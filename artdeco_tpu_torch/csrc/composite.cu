// Tile compositor for 3D Gaussian splatting: forward (K1) and recompute
// backward (K2), CUDA C++ for Hopper (sm_90a), with a plain C interface
// bound from Python by ctypes (artdeco_tpu_torch/ops/splat/composite.py).
//
// Replaces the Pallas TPU kernels of artdeco_tpu/ops/splat/composite.py:
//   K1 _fwd_kernel (tile_composite / _fwd_impl)  -> composite_fwd_kernel
//   K2 _bwd_kernel (_bwd_rule)                    -> bwd_chunk_summary_kernel,
//                                                    bwd_scan_kernel,
//                                                    bwd_chunk_grad_kernel
//
// Layout (the JAX package's): slot matrix (16, S) f32, row-major, rows
//   [0] mean_x [1] mean_y [2] conic_a [3] conic_b [4] conic_c [5] opacity
//   [6..7] pad [8..15] channels.  Tile t owns the run
//   [starts[t], starts[t] + counts[t]) of depth-sorted slots.  Runs are
//   disjoint and begin and end on CHUNK boundaries, so each 128-slot chunk
//   of the matrix belongs to at most one tile.
//   Output (T, 256, 8): channels 0..6 composited, channel 7 = alpha.
//
// K1: a cluster of SPLIT (4) blocks per 16x16 tile.  What bounds it is
// the serial walk: per (pixel, slot) an exp, the alpha tests and, where
// alpha > 0, 7 FMAs and T *= 1 - a, all on one dependent chain (compute and
// latency, not bytes: a chunk is 8 KB and every pixel of the tile reads
// it).  One thread per pixel walking all 128 slots of a chunk, one block
// per tile, ran 192 blocks of 8 warps at the stream's scene: most SMs held
// one block, and the chain's latency was exposed.  Front-to-back "over" is
// associative, so the walk is split inside each chunk: a run of slots
// reduces to (P, C), P = prod(1 - a) and C = sum a T_local c, T_local
// starting at 1.  Each block takes 64 pixels of the tile; its 256 threads
// are those pixels x the chunk's 4 sub-runs of 32 slots, one sub-run per
// pair of warps (so every lane of a warp reads the same slot: broadcast).
// The sub-runs' (P, C) are combined in order in shared memory, C <- C_a +
// P_a C_b, P <- P_a P_b, and the chunk's pair is applied to the pixel's
// (T, acc).  At the stream's scene (192 tiles) that is 768 blocks, 6 an SM
// (the card holds 186 clusters at once), and a chain of 32 slots in place
// of 128.  After the split the chain no longer sets the time: 2, 4 and 8
// sub-runs time alike on the H100 (PERF.md); what is left is latency (the
// launch, a chunk's copy, the barriers, the combine).
// Chunks are read coalesced (16 bytes a thread, neighbouring lanes on
// neighbouring columns of one row) with cp.async into a row-major staging
// buffer, then moved to the slot-major walk buffer (a slot's 16 rows are 64
// contiguous bytes, read as four broadcast float4 loads: scalar loads of
// each row would make the shared-memory pipe, not the FMAs, the limit);
// where a tile has another chunk, its copy is in flight while the current
// one is walked, and is dropped if the vote stops.  The exp stays the
// accurate expf: an approximate exp can flip the raw >= 1/255 test and move
// a pixel by more than the 1e-4 golden.  The whole tile stops when no pixel
// has T > 1e-4, voted once per chunk boundary, first per block with
// __syncthreads_or, then over the cluster's four flags in distributed
// shared memory: the decision points of the Pallas kernel (max log T > log
// 1e-4, checked per chunk), so the two packages composite the same slots.
// A tile with one chunk never votes (T = 1 before its first chunk) and
// never syncs its cluster.  K1 writes, per tile, the number of chunks it
// composited (its stop chunk).
//
// K2 computes the JAX _bwd_kernel's function: pass A walks the forward's
// chunks (up to its stop) for the final T and the total weighted-gradient
// mass; pass B walks every slot of the run (no early-out) and writes 13
// gradients per slot.  What bounds it: pass B's flops, 14 for alpha on
// every (pixel, slot) pair of a real slot and, where alpha > 0, 63 more
// (50 for the gradient terms, 13 for the sums over the tile's 256 pixels;
// chip_smoke.py counts them); its bytes (the real slots read once, their
// gradients written once) are a small share.  A walk per tile is serial and fills
// the card with only one block per tile, and 13 separate warp sums per slot
// (65 shuffles) run at the shuffle unit's quarter rate.  So K2 splits each
// run at chunk boundaries:
//   1. bwd_chunk_summary_kernel, one block per chunk: per pixel the chunk's
//      own transmittance product P = prod(1 - a) and weighted-gradient
//      mass Q = sum a T_local cg, T_local starting at 1 in the chunk.
//   2. bwd_scan_kernel, one block per tile: scans its chunks' (P, Q) in
//      order into each chunk's starting checkpoint (T, q), in place:
//      T(c+1) = T(c) P(c), q(c+1) = q(c) + T(c) Q(c).  Pass A's results
//      are the checkpoint at K1's stop chunk, so the backward uses the
//      forward's vote and never votes on a differently rounded T.
//   3. bwd_chunk_grad_kernel, one block per chunk: pass B from the chunk's
//      checkpoint.  Each slot's 13 gradients (padded to 16) are summed over
//      a warp by one butterfly: at xor 16, 8, 4, 2 each lane sends the half
//      of its values it does not keep (8 + 4 + 2 + 1 shuffles), and one
//      shuffle at xor 1 completes the sum (16 shuffles in place of 65).
//      Then over the 8 warps in shared memory, in a fixed order, and each
//      gradient is written once.
// No global atomics and fixed summation orders: the result is
// deterministic.  The checkpoints take 8 bytes per (chunk, pixel).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch_info.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;       // threads per block
constexpr int CHUNK = 128;             // early-out and split granularity (slots)
constexpr int BATCH_B = 32;            // pass-B reduction batch (slots)
constexpr int SCAN_AHEAD = 8;          // checkpoints loaded ahead in the scan
constexpr int D_PAIR = 16;             // slot-matrix rows
constexpr int C_MAX = 8;               // output channels (slot 7 = alpha)
constexpr int NCH = 7;                 // composited channels
constexpr int NWARP = PIX / 32;
constexpr int NGRAD = 6 + NCH;         // mx my ca cb cc op + channels
constexpr int NPAD = 16;               // NGRAD padded for the butterfly
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_CLAMP = 0.999f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr int SPLIT = 4;                 // K1: sub-runs per chunk, blocks per tile
constexpr int SUB = CHUNK / SPLIT;       // K1: slots per sub-run
constexpr int FWD_PIX = PIX / SPLIT;     // K1: pixels per block
constexpr int FWD_MIN_BLOCKS = 6;        // K1: blocks an SM must hold -> <= 40 registers
static_assert(CHUNK % SPLIT == 0 && FWD_PIX % 32 == 0,
              "K1: every warp walks one sub-run");
static_assert(PIX == 2 * CHUNK, "unstage_chunk: two threads per slot");

// A chunk staged in shared memory, slot-major: sd[j][0] = (mean_x, mean_y,
// conic_a, conic_b), sd[j][1] = (conic_c, opacity, pad, pad), sd[j][2..3] =
// the 8 channels.
typedef float4 Chunk[CHUNK][D_PAIR / 4];
// The same chunk as the matrix holds it, row-major: cp.async's target.
typedef float RowChunk[D_PAIR][CHUNK];

struct SlotEval {
  float alpha;   // clamped alpha (0 when the pair is dropped)
  float e;       // d alpha / d opacity (0 when dropped or clamped)
  float dx, dy;
  float ca, cb, cc;
};

__device__ __forceinline__ SlotEval eval_slot(const Chunk& sd, int j, float px,
                                              float py) {
  const float4 a = sd[j][0];
  const float4 b = sd[j][1];
  const float dx = px - a.x;
  const float dy = py - a.y;
  const float sigma = 0.5f * (a.z * dx * dx + b.x * dy * dy) + a.w * dx * dy;
  const float ex = expf(-sigma);
  const float raw = b.y * ex;
  const bool value_valid = (sigma >= 0.0f) && (raw >= ALPHA_MIN);
  SlotEval r;
  r.alpha = value_valid ? fminf(raw, ALPHA_CLAMP) : 0.0f;
  r.e = (value_valid && raw <= ALPHA_CLAMP) ? ex : 0.0f;
  r.dx = dx;
  r.dy = dy;
  r.ca = a.z;
  r.cb = a.w;
  r.cc = b.x;
  return r;
}

// The 7 composited channels of slot j.
__device__ __forceinline__ void slot_colors(const Chunk& sd, int j,
                                            float (&col)[NCH]) {
  const float4 c0 = sd[j][2];
  const float4 c1 = sd[j][3];
  col[0] = c0.x; col[1] = c0.y; col[2] = c0.z; col[3] = c0.w;
  col[4] = c1.x; col[5] = c1.y; col[6] = c1.z;
}

// Stage the chunk of slots starting at column `base` of the (16, S)
// matrix.  Thread i takes row i % 16 of slot i / 16: the shared stores
// fill consecutive words (no bank conflicts), and a warp's global loads
// cover two slots of every row, cache lines that the block's other warps
// read too.
__device__ __forceinline__ void load_chunk(Chunk& sd,
                                           const float* __restrict__ slot,
                                           long long S, long long base) {
  float* dst = reinterpret_cast<float*>(sd);
  for (int i = threadIdx.x; i < D_PAIR * CHUNK; i += PIX) {
    const int r = i % D_PAIR;
    const int j = i / D_PAIR;
    dst[i] = slot[r * S + base + j];
  }
}

// Start the copy of the chunk at column `base` into st, 16 bytes a thread,
// neighbouring lanes on neighbouring columns of one row (coalesced; needs S
// and base to be multiples of 4 and a 16-byte aligned matrix).
__device__ __forceinline__ void stage_chunk(RowChunk& st, const float* __restrict__ slot,
                                            long long S, long long base) {
  constexpr int V = CHUNK / 4;  // 16-byte pieces of a row
  for (int i = threadIdx.x; i < D_PAIR * V; i += PIX) {
    const int r = i / V;
    const int c = i - r * V;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(&st[r][4 * c]);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(slot + r * S + base + 4 * c) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Move a staged chunk to the slot-major layout: thread i writes rows
// 8 (i & 1) .. + 7 of slot i >> 1 as two float4 stores.
__device__ __forceinline__ void unstage_chunk(Chunk& sd, const RowChunk& st) {
  const int j = threadIdx.x >> 1;
  const int h = (threadIdx.x & 1) * 8;
  sd[j][h / 4] = make_float4(st[h][j], st[h + 1][j], st[h + 2][j], st[h + 3][j]);
  sd[j][h / 4 + 1] = make_float4(st[h + 4][j], st[h + 5][j], st[h + 6][j], st[h + 7][j]);
}

__device__ __forceinline__ float pixel_x(int t, int tiles_x, int p) {
  return float((t % tiles_x) * TILE + (p % TILE)) + 0.5f;
}

__device__ __forceinline__ float pixel_y(int t, int tiles_x, int p) {
  return float((t / tiles_x) * TILE + (p / TILE)) + 0.5f;
}

// The tile whose run holds column `col`, or -1.  Every thread of the block
// calls it; each tests a share of the runs, so any disjoint runs work.
__device__ __forceinline__ int chunk_tile(const int* __restrict__ starts,
                                          const int* __restrict__ counts,
                                          int num_tiles, long long col,
                                          int* s_tile) {
  if (threadIdx.x == 0) *s_tile = -1;
  __syncthreads();
  for (int i = threadIdx.x; i < num_tiles; i += PIX) {
    const long long s0 = starts[i];
    if (col >= s0 && col < s0 + counts[i]) *s_tile = i;
  }
  __syncthreads();
  return *s_tile;
}

// One butterfly step: lanes whose bit 2H is set keep values [H, 2H), the
// others [0, H); each sends the half it does not keep to lane ^ 2H and
// adds the half it receives.  Afterwards v[0..H) hold the kept sums.
template <int H>
__device__ __forceinline__ void halve(float (&v)[NPAD], int lane) {
  const bool up = lane & (2 * H);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, 2 * H);
  }
}

// Warp sums of 16 values in 16 shuffles: lane l returns the sum of v[l >> 1]
// over the warp (lanes l and l ^ 1 hold the same sum).  The tree is fixed,
// so the sums do not change from run to run.
__device__ __forceinline__ float warp_sum16(float (&v)[NPAD], int lane) {
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// K1.  Block `rank` of tile t's cluster owns pixels [rank * FWD_PIX, +
// FWD_PIX); thread (sub, lp) walks sub-run `sub` of each chunk for pixel
// lp.  The threads of sub-run 0 also hold their pixel's T (a register) and
// acc (shared memory) across chunks.
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(PIX, FWD_MIN_BLOCKS)
composite_fwd_kernel(const float* __restrict__ slot, long long S,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, int tiles_x,
                     float* __restrict__ out, int* __restrict__ stop) {
  __shared__ Chunk sd;
  __shared__ __align__(16) RowChunk st;
  __shared__ float part[SPLIT][1 + NCH][FWD_PIX];  // each sub-run's (P, C)
  __shared__ float acc[NCH][FWD_PIX];
  __shared__ int vote[2];                          // by chunk parity
  cg::cluster_group cluster = cg::this_cluster();
  const int t = blockIdx.x / SPLIT;
  const int sub = threadIdx.x / FWD_PIX;
  const int lp = threadIdx.x - sub * FWD_PIX;
  const int p = (int)cluster.block_rank() * FWD_PIX + lp;
  const float px = pixel_x(t, tiles_x, p);
  const float py = pixel_y(t, tiles_x, p);
  const long long start = starts[t];
  const int nchunks = counts[t] / CHUNK;

  if (nchunks > 0) stage_chunk(st, slot, S, start);
  if (sub == 0) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c][lp] = 0.0f;
  }
  float T = 1.0f;  // sub-run 0's threads: the pixel's transmittance

  int ci = 0;
  for (; ci < nchunks; ++ci) {
    if (ci > 0) {
      // tile-wide vote at the chunk boundary: this block's pixels, then the
      // cluster's four flags.  Flags alternate by chunk parity, so a block
      // that runs ahead never overwrites one that another block has still
      // to read.  The barrier also keeps the last walk ahead of the unstage.
      const int mine = __syncthreads_or(sub == 0 && T > T_EPS);
      if (threadIdx.x == 0) vote[ci & 1] = mine;
      cluster.sync();
      int any = 0;
#pragma unroll
      for (int r = 0; r < SPLIT; ++r) any |= *cluster.map_shared_rank(&vote[ci & 1], r);
      if (!any) break;
    }
    wait_staged();
    __syncthreads();
    unstage_chunk(sd, st);
    __syncthreads();
    // the next chunk's copy runs under this walk
    if (ci + 1 < nchunks) stage_chunk(st, slot, S, start + (long long)(ci + 1) * CHUNK);

    float P = 1.0f;
    float C[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c) C[c] = 0.0f;
#pragma unroll 4
    for (int j = sub * SUB; j < (sub + 1) * SUB; ++j) {
      const SlotEval s = eval_slot(sd, j, px, py);
      if (s.alpha == 0.0f) continue;
      const float w = s.alpha * P;
      float col[NCH];
      slot_colors(sd, j, col);
#pragma unroll
      for (int c = 0; c < NCH; ++c) C[c] += w * col[c];
      P *= 1.0f - s.alpha;
    }
    part[sub][0][lp] = P;
#pragma unroll
    for (int c = 0; c < NCH; ++c) part[sub][1 + c][lp] = C[c];
    __syncthreads();
    if (sub == 0) {
      // the chunk's (P, C), sub-runs combined in order, applied to (T, acc)
      float Pc = 1.0f;
      float Cc[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) Cc[c] = 0.0f;
#pragma unroll
      for (int k = 0; k < SPLIT; ++k) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) Cc[c] += Pc * part[k][1 + c][lp];
        Pc *= part[k][0][lp];
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[c][lp] += T * Cc[c];
      T *= Pc;
    }
  }
  wait_staged();  // a copy the vote dropped
  if (sub == 0) {
    float4* o = reinterpret_cast<float4*>(out + ((long long)t * PIX + p) * C_MAX);
    o[0] = make_float4(acc[0][lp], acc[1][lp], acc[2][lp], acc[3][lp]);
    o[1] = make_float4(acc[4][lp], acc[5][lp], acc[6][lp], 1.0f - T);
  }
  if (threadIdx.x == 0 && cluster.block_rank() == 0) stop[t] = ci;
  // a block's flags must outlive the other blocks' reads of them
  if (nchunks > 1) cluster.sync();
}

// ---- K2 stage 1: (P, Q) of one chunk, per pixel ---------------------------
__global__ void __launch_bounds__(PIX)
bwd_chunk_summary_kernel(const float* __restrict__ slot, long long S,
                         const int* __restrict__ starts,
                         const int* __restrict__ counts, int num_tiles,
                         int tiles_x, const float* __restrict__ gout,
                         float2* __restrict__ ckpt) {
  __shared__ Chunk sd;
  __shared__ int s_tile;
  const long long g = blockIdx.x;
  const int t = chunk_tile(starts, counts, num_tiles, g * CHUNK, &s_tile);
  if (t < 0) return;  // the chunk lies outside every run
  const int p = threadIdx.x;
  const float px = pixel_x(t, tiles_x, p);
  const float py = pixel_y(t, tiles_x, p);
  load_chunk(sd, slot, S, g * CHUNK);
  const float* go = gout + ((long long)t * PIX + p) * C_MAX;
  float gc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) gc[c] = go[c];
  __syncthreads();

  float P = 1.0f, Q = 0.0f;
  for (int j = 0; j < CHUNK; ++j) {
    const SlotEval s = eval_slot(sd, j, px, py);
    if (s.alpha == 0.0f) continue;
    float col[NCH];
    slot_colors(sd, j, col);
    float cg = 0.0f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) cg += col[c] * gc[c];
    Q += s.alpha * P * cg;
    P *= 1.0f - s.alpha;
  }
  ckpt[g * PIX + p] = make_float2(P, Q);
}

// ---- K2 stage 2: scan a tile's chunks into checkpoints --------------------
__global__ void __launch_bounds__(PIX)
bwd_scan_kernel(const int* __restrict__ starts, const int* __restrict__ counts,
                const int* __restrict__ stop, float2* __restrict__ ckpt,
                float2* __restrict__ fin) {
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const long long g0 = starts[t] / CHUNK;
  const int nch = counts[t] / CHUNK;
  const int st = min(max(stop[t], 0), nch);
  float T = 1.0f, q = 0.0f;
  float2 f = make_float2(1.0f, 0.0f);
  for (int c0 = 0; c0 < nch; c0 += SCAN_AHEAD) {
    // the loads of a batch are independent: issue them before the scan
    float2 pq[SCAN_AHEAD];
#pragma unroll
    for (int k = 0; k < SCAN_AHEAD; ++k)
      pq[k] = c0 + k < nch ? ckpt[(g0 + c0 + k) * PIX + p] : make_float2(1.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < SCAN_AHEAD; ++k) {
      if (c0 + k < nch) {
        if (c0 + k == st) f = make_float2(T, q);
        ckpt[(g0 + c0 + k) * PIX + p] = make_float2(T, q);
        q += T * pq[k].y;
        T *= pq[k].x;
      }
    }
  }
  if (st == nch) f = make_float2(T, q);
  fin[(long long)t * PIX + p] = f;  // (T_final, total_q) of pass A
}

// ---- K2 stage 3: pass B of one chunk from its checkpoint ------------------
__global__ void __launch_bounds__(PIX)
bwd_chunk_grad_kernel(const float* __restrict__ slot, long long S,
                      const int* __restrict__ starts,
                      const int* __restrict__ counts, int num_tiles, int tiles_x,
                      const float* __restrict__ gout,
                      const float2* __restrict__ ckpt,
                      const float2* __restrict__ fin, float* __restrict__ grad) {
  __shared__ Chunk sd;
  // row length NGRAD (odd): the lanes' writes of one slot and the reducers'
  // reads of one gradient row both fall in distinct banks
  __shared__ float part[NWARP][BATCH_B][NGRAD];
  __shared__ int s_tile;
  const long long g = blockIdx.x;
  const long long col = g * CHUNK;
  const int t = chunk_tile(starts, counts, num_tiles, col, &s_tile);
  if (t < 0) return;  // outside every run: the wrapper zeroed these slots
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = pixel_x(t, tiles_x, p);
  const float py = pixel_y(t, tiles_x, p);
  load_chunk(sd, slot, S, col);

  const float* go = gout + ((long long)t * PIX + p) * C_MAX;
  float gc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) gc[c] = go[c];
  const float2 ck = ckpt[g * PIX + p];
  const float2 f = fin[(long long)t * PIX + p];
  const float total_q = f.y;
  const float galpha_T = go[C_MAX - 1] * f.x;
  float T = ck.x;
  float pref_q = ck.y;

  for (int b0 = 0; b0 < CHUNK; b0 += BATCH_B) {
    __syncthreads();  // the chunk is staged / the last batch's sums have read part
    for (int jb = 0; jb < BATCH_B; ++jb) {
      const int j = b0 + jb;
      const SlotEval s = eval_slot(sd, j, px, py);
      float r = 0.0f;
      // a warp no pixel of which this slot touches adds nothing: every
      // term carries alpha or w
      if (__any_sync(FULL, s.alpha > 0.0f)) {
        float colr[NCH];
        slot_colors(sd, j, colr);
        float cg = 0.0f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) cg += colr[c] * gc[c];
        const float w = s.alpha * T;
        pref_q += w * cg;
        const float suffix = total_q - pref_q;
        // 1 / (1 - a), then a product: the JAX kernel's inv_1ma
        const float dl_da = cg * T + (galpha_T - suffix) * __frcp_rn(1.0f - s.alpha);
        const float g_sigma = -dl_da * s.alpha;
        float v[NPAD];
        v[0] = g_sigma * -(s.ca * s.dx + s.cb * s.dy);
        v[1] = g_sigma * -(s.cc * s.dy + s.cb * s.dx);
        v[2] = g_sigma * 0.5f * s.dx * s.dx;
        v[3] = g_sigma * s.dx * s.dy;
        v[4] = g_sigma * 0.5f * s.dy * s.dy;
        v[5] = dl_da * s.e;
#pragma unroll
        for (int c = 0; c < NCH; ++c) v[6 + c] = w * gc[c];
#pragma unroll
        for (int k = NGRAD; k < NPAD; ++k) v[k] = 0.0f;
        r = warp_sum16(v, lane);
      }
      if ((lane & 1) == 0 && (lane >> 1) < NGRAD) part[warp][jb][lane >> 1] = r;
      T *= 1.0f - s.alpha;
    }
    __syncthreads();
    // fixed-order sum over warps, one writer per (gradient row, slot);
    // consecutive threads write consecutive slots of one row
    for (int i = p; i < NGRAD * BATCH_B; i += PIX) {
      const int k = i / BATCH_B;
      const int jb = i - k * BATCH_B;
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) acc += part[w][jb][k];
      const int row = k < 6 ? k : k + 2;  // rows 6, 7 are padding
      grad[row * S + col + b0 + jb] = acc;
    }
  }
}

}  // namespace

extern "C" int artdeco_composite_fwd(const float* slot, long long S,
                                     const int* starts, const int* counts,
                                     int num_tiles, int tiles_x, float* out,
                                     int* stop, void* stream) {
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles * SPLIT, PIX, 0, (cudaStream_t)stream>>>(
        slot, S, starts, counts, tiles_x, out, stop);
  }
  return (int)cudaGetLastError();
}

// K1's launch shape (launch_info.cuh): threads, cluster size, registers, ...
extern "C" int artdeco_composite_fwd_info(int* info) {
  return launch_info(composite_fwd_kernel, PIX, SPLIT, info);
}

// ckpt: (S / CHUNK + num_tiles) * PIX float2 of scratch: the chunks'
// checkpoints, then each tile's pass-A results.  grad must be zeroed by
// the caller: slots outside every run are not written.
extern "C" int artdeco_composite_bwd(const float* slot, long long S,
                                     const int* starts, const int* counts,
                                     const int* stop, int num_tiles,
                                     int tiles_x, const float* gout,
                                     float* ckpt, float* grad, void* stream) {
  const long long nchunks = S / CHUNK;
  if (num_tiles == 0 || nchunks == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  float2* pq = reinterpret_cast<float2*>(ckpt);
  float2* fin = pq + nchunks * PIX;
  bwd_chunk_summary_kernel<<<(unsigned)nchunks, PIX, 0, st>>>(
      slot, S, starts, counts, num_tiles, tiles_x, gout, pq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_scan_kernel<<<num_tiles, PIX, 0, st>>>(starts, counts, stop, pq, fin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_chunk_grad_kernel<<<(unsigned)nchunks, PIX, 0, st>>>(
      slot, S, starts, counts, num_tiles, tiles_x, gout, pq, fin, grad);
  return (int)cudaGetLastError();
}

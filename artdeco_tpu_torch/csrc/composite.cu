// Tile compositor for 3D Gaussian splatting: forward (K1) and recompute
// backward (K2), CUDA C++ for Hopper (sm_90a), with a plain C interface
// bound from Python by ctypes (artdeco_tpu_torch/ops/splat/composite.py).
//
// Replaces the Pallas TPU kernels of artdeco_tpu/ops/splat/composite.py:
//   K1 _fwd_kernel (tile_composite / _fwd_impl)  -> composite_fwd_kernel
//   K2 _bwd_kernel (_bwd_rule)                    -> composite_bwd_kernel
//
// Layout (the JAX package's): slot matrix (16, S) f32, row-major, rows
//   [0] mean_x [1] mean_y [2] conic_a [3] conic_b [4] conic_c [5] opacity
//   [6..7] pad [8..15] channels.  Tile t owns the CHUNK-aligned run
//   [starts[t], starts[t] + counts[t]) of depth-sorted slots.
//   Output (T, 256, 8): channels 0..6 composited, channel 7 = alpha.
//
// Mapping: one block per 16x16 tile, one thread per pixel.  The block
// stages slots in shared memory and every thread composites front to back.
// What bounds it on the H100: the per-slot exp and FMAs of 256 threads
// (compute, not bytes: a 128-slot batch is 8 KB and is read by all 256
// pixels), plus, in the backward, the per-slot reduction over 256 pixels.
// The design keeps every intermediate in registers and shared memory; the
// only device-memory traffic is the slot matrix, the image and the
// gradient rows.
//
// Early-out: the whole tile stops when no pixel has T > 1e-4, voted with
// __syncthreads_or once per 128-slot batch.  These are the decision points
// of the Pallas kernel (max log T > log 1e-4, checked per chunk), so the
// two packages composite the same slots.
//
// Backward: pass A repeats the forward (same vote) for the final T and the
// total weighted-gradient mass; pass B walks every slot of the run (no
// early-out, as in JAX), rebuilding T_j and the inclusive prefix of that
// mass per pixel.  Each slot's 13 gradients are summed over the tile's 256
// pixels with warp shuffles and then over the 8 warps in shared memory in
// a fixed order, and written once: a slot belongs to exactly one tile, so
// there are no global atomics and the result is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;       // threads per block
constexpr int CHUNK = 128;             // early-out granularity (slots)
constexpr int BATCH_B = 32;            // pass-B staging batch (slots)
constexpr int D_PAIR = 16;             // slot-matrix rows
constexpr int C_MAX = 8;               // output channels (slot 7 = alpha)
constexpr int NCH = 7;                 // composited channels
constexpr int NWARP = PIX / 32;
constexpr int NGRAD = 6 + NCH;         // mx my ca cb cc op + channels
constexpr float ALPHA_CLAMP = 0.999f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

struct SlotEval {
  float alpha;   // clamped alpha (0 when the pair is dropped)
  float e;       // d alpha / d opacity (0 when dropped or clamped)
  float dx, dy;
};

__device__ __forceinline__ SlotEval eval_slot(const float (*sd)[CHUNK], int j,
                                              float px, float py) {
  const float dx = px - sd[0][j];
  const float dy = py - sd[1][j];
  const float sigma =
      0.5f * (sd[2][j] * dx * dx + sd[4][j] * dy * dy) + sd[3][j] * dx * dy;
  const float ex = expf(-sigma);
  const float raw = sd[5][j] * ex;
  const bool value_valid = (sigma >= 0.0f) && (raw >= ALPHA_MIN);
  SlotEval r;
  r.alpha = value_valid ? fminf(raw, ALPHA_CLAMP) : 0.0f;
  r.e = (value_valid && raw <= ALPHA_CLAMP) ? ex : 0.0f;
  r.dx = dx;
  r.dy = dy;
  return r;
}

// Stage n slots starting at column `base` of the (16, S) matrix; threads
// read consecutive columns of one row (coalesced).
__device__ __forceinline__ void load_slots(float (*sd)[CHUNK],
                                           const float* __restrict__ slot,
                                           long long S, long long base, int n) {
  for (int i = threadIdx.x; i < D_PAIR * n; i += PIX) {
    const int r = i / n;
    const int j = i - r * n;
    sd[r][j] = slot[r * S + base + j];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(PIX)
composite_fwd_kernel(const float* __restrict__ slot, long long S,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, int tiles_x,
                     float* __restrict__ out) {
  __shared__ float sd[D_PAIR][CHUNK];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = float((t % tiles_x) * TILE + (p % TILE)) + 0.5f;
  const float py = float((t / tiles_x) * TILE + (p / TILE)) + 0.5f;
  const long long start = starts[t];
  const int nchunks = counts[t] / CHUNK;

  float T = 1.0f;
  float acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;

  for (int ci = 0; ci < nchunks; ++ci) {
    // tile-wide vote; the barrier also keeps the last batch's readers
    // ahead of the next load
    if (!__syncthreads_or(T > T_EPS)) break;
    load_slots(sd, slot, S, start + (long long)ci * CHUNK, CHUNK);
    __syncthreads();
    for (int j = 0; j < CHUNK; ++j) {
      const SlotEval s = eval_slot(sd, j, px, py);
      if (s.alpha == 0.0f) continue;
      const float w = s.alpha * T;
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[c] += w * sd[8 + c][j];
      T *= 1.0f - s.alpha;
    }
  }
  float* o = out + ((long long)t * PIX + p) * C_MAX;
#pragma unroll
  for (int c = 0; c < NCH; ++c) o[c] = acc[c];
  o[C_MAX - 1] = 1.0f - T;
}

__global__ void __launch_bounds__(PIX)
composite_bwd_kernel(const float* __restrict__ slot, long long S,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, int tiles_x,
                     const float* __restrict__ gout,
                     float* __restrict__ grad) {
  __shared__ float sd[D_PAIR][CHUNK];
  __shared__ float part[NWARP][NGRAD][BATCH_B];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = float((t % tiles_x) * TILE + (p % TILE)) + 0.5f;
  const float py = float((t / tiles_x) * TILE + (p / TILE)) + 0.5f;
  const long long start = starts[t];
  const int nslots = counts[t];
  const int nchunks = nslots / CHUNK;

  const float* g = gout + ((long long)t * PIX + p) * C_MAX;
  float gc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) gc[c] = g[c];
  const float g_alpha = g[C_MAX - 1];

  // ---- pass A: final T and total weighted-gradient mass (forward's vote)
  float T = 1.0f;
  float total_q = 0.0f;
  for (int ci = 0; ci < nchunks; ++ci) {
    if (!__syncthreads_or(T > T_EPS)) break;
    load_slots(sd, slot, S, start + (long long)ci * CHUNK, CHUNK);
    __syncthreads();
    for (int j = 0; j < CHUNK; ++j) {
      const SlotEval s = eval_slot(sd, j, px, py);
      if (s.alpha == 0.0f) continue;
      float cg = 0.0f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) cg += sd[8 + c][j] * gc[c];
      total_q += s.alpha * T * cg;
      T *= 1.0f - s.alpha;
    }
  }
  const float galpha_T = g_alpha * T;

  // ---- pass B: per-slot gradients over every slot of the run
  T = 1.0f;
  float pref_q = 0.0f;
  for (int b0 = 0; b0 < nslots; b0 += BATCH_B) {
    __syncthreads();  // last batch's reduction has finished reading sd/part
    load_slots(sd, slot, S, start + b0, BATCH_B);
    __syncthreads();
    for (int j = 0; j < BATCH_B; ++j) {
      const SlotEval s = eval_slot(sd, j, px, py);
      float v[NGRAD];
      if (__any_sync(0xffffffffu, s.alpha > 0.0f)) {
        float cg = 0.0f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) cg += sd[8 + c][j] * gc[c];
        const float w = s.alpha * T;
        pref_q += w * cg;
        const float suffix = total_q - pref_q;
        const float dl_da = cg * T + (galpha_T - suffix) / (1.0f - s.alpha);
        const float g_sigma = -dl_da * s.alpha;
        const float ca = sd[2][j], cb = sd[3][j], cc = sd[4][j];
        v[0] = g_sigma * -(ca * s.dx + cb * s.dy);
        v[1] = g_sigma * -(cc * s.dy + cb * s.dx);
        v[2] = g_sigma * 0.5f * s.dx * s.dx;
        v[3] = g_sigma * s.dx * s.dy;
        v[4] = g_sigma * 0.5f * s.dy * s.dy;
        v[5] = dl_da * s.e;
#pragma unroll
        for (int c = 0; c < NCH; ++c) v[6 + c] = w * gc[c];
#pragma unroll
        for (int k = 0; k < NGRAD; ++k) v[k] = warp_sum(v[k]);
      } else {
        // no pixel of this warp is touched: every term carries alpha or w
#pragma unroll
        for (int k = 0; k < NGRAD; ++k) v[k] = 0.0f;
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NGRAD; ++k) part[warp][k][j] = v[k];
      }
      T *= 1.0f - s.alpha;
    }
    __syncthreads();
    // fixed-order sum over warps, one writer per (gradient row, slot)
    for (int i = p; i < NGRAD * BATCH_B; i += PIX) {
      const int k = i / BATCH_B;
      const int j = i - k * BATCH_B;
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) acc += part[w][k][j];
      const int row = k < 6 ? k : k + 2;  // rows 6, 7 are padding
      grad[row * S + start + b0 + j] = acc;
    }
  }
}

}  // namespace

extern "C" int artdeco_composite_fwd(const float* slot, long long S,
                                     const int* starts, const int* counts,
                                     int num_tiles, int tiles_x, float* out,
                                     void* stream) {
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
        slot, S, starts, counts, tiles_x, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int artdeco_composite_bwd(const float* slot, long long S,
                                     const int* starts, const int* counts,
                                     int num_tiles, int tiles_x,
                                     const float* gout, float* grad,
                                     void* stream) {
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
        slot, S, starts, counts, tiles_x, gout, grad);
  }
  return (int)cudaGetLastError();
}

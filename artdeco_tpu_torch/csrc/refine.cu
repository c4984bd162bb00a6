// K3: the refine window-argmax search, per query, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ``_band_kernel`` / ``dense_best_pallas``
// (artdeco_tpu/ops/refine_pallas.py) and its XLA twin ``_dense_best``
// (artdeco_tpu/ops/refine_dense.py), which score every query's dilated
// window densely in image-1 space after a claim pass, because gathers are
// slow on the TPU.  Gathers are cheap here, so the kernel is per query:
// one thread per query walks its own window at its current centre, on
// every dilation level d = d_max..d_min in one launch, and keeps the
// running max across levels.  There is no claim pass and no collision
// drain; the positions are the same.
//
// Semantics (refine_matches_dense_single, matching_kernels.cu:26-81):
//   * the running max starts at init_score (FLT_MIN on the main path);
//   * window sample (i, j) of level d sits at (u - r*d + i*d, v - r*d + j*d),
//     i (u) outer, j (v) inner; a strict '>' keeps the first max;
//   * out-of-image samples score exactly 0.0 (they never beat FLT_MIN);
//   * the window re-centres on the best position after every level;
//   * queries with valid == 0 keep their position.
// A score is the f32 sum, in channel order from 0, of products of two
// bf16 values.  Such a product has at most 16 significant bits, so it is
// exact in f32 (outside f32 underflow), and fmaf(r, g, s) rounds exactly
// as s + r * g with the product rounded first.  The kernel therefore sums
// with FMAs, in channel order, and agrees bit for bit with the plain
// PyTorch version (ops/refine_dense.py), which multiplies and adds in
// separate steps.
//
// What bounds it on the H100: the L1 cache, then instruction issue.  The
// device-memory bytes are few (the image, 9.4 MB at 384x512, is read from
// L2 many times over: each query reads 81 rows of 48 bytes per level,
// ~3.8 GB over 5 levels).  Neighbouring threads take neighbouring pixels,
// so a warp's window samples share cache lines, but only while those
// lines stay in L1.  Walked i (columns) outer, j (rows) inner, as the
// reference orders the window, a warp touches 9 image rows per column step
// and its working set (~30 KB at d = 5) times the 32 warps of an SM
// overflows L1: the loads went to L2 (0.53 against 0.30 ms at 384x512 on
// the H100; PERF.md).  So each window row j is walked across its
// columns i (one image row at a time, a few lines per warp), and the
// first max of the reference order is kept by its index (ties keep the
// lower i * span + j).  The wrapper hands the image over as three planes
// of 8 channels (16 bytes a pixel in each), so load e of a warp reads
// contiguous bytes of plane e, 4 lines where the interleaved 48-byte
// pixels took 12.  Per position the kernel then spends 3 16-byte loads,
// 24 bf16 -> f32 conversions of one shift or mask each on the packed
// words, 24 FMAs and the argmax test; the window span is a template
// parameter, so the inner loop unrolls and AHEAD positions have their
// loads issued together and their chains interleaved (each chain keeps
// channel order).  The query's 24 channels stay in registers as f32.
//
// Tensor cores do not fit: each query scores its own 81 candidates, a
// matrix product computes all pairs of a tile's queries and rows, so 8-16x
// of its products would be thrown away, and its accumulation order would
// end the bit equality with the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_info.cuh"

namespace {

constexpr int F = 24;          // descriptor channels (three 16-byte loads)
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;  // 1024 threads an SM (50 % occupancy): <= 64 registers
constexpr int AHEAD = 2;       // window positions whose loads are in flight together

// bf16 -> f32 of the low and the high half of a packed word: exact
__device__ __forceinline__ float lo_bf16(unsigned x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi_bf16(unsigned x) { return __uint_as_float(x & 0xffff0000u); }

__device__ __forceinline__ unsigned word(const uint4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int R>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
refine_kernel(const uint4* __restrict__ D11,           // (3, h*w) planes of 8 bf16
              const uint4* __restrict__ D21,           // (n, 3)
              const int* __restrict__ p_in,            // (n, 2) u, v
              const uint8_t* __restrict__ valid,       // (n,)
              int n, int h, int w, int d_max, int d_min,
              float init_score,
              int* __restrict__ p_out,                 // (n, 2)
              float* __restrict__ score_out)           // (n,)
{
    constexpr int SPAN = 2 * R + 1;
    const size_t hw = (size_t)h * w;
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= n) return;
    int u = p_in[2 * q];
    int v = p_in[2 * q + 1];
    float best = init_score;
    if (valid[q]) {
        float g[F];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
            const uint4 raw = __ldg(D21 + (size_t)q * 3 + e);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                g[8 * e + 2 * k] = lo_bf16(word(raw, k));
                g[8 * e + 2 * k + 1] = hi_bf16(word(raw, k));
            }
        }
        for (int d = d_max; d >= d_min; --d) {
            const int u0 = u - R * d;
            const int v0 = v - R * d;
            // the level's best that beats the running max: its score and
            // its index i * SPAN + j in the reference order (i outer, j
            // inner), -1 while none does.  Ties keep the lower index, so
            // the first max is found whatever order the positions are
            // scored in.
            float lbest = best;
            int lidx = -1;
            for (int j = 0; j < SPAN; ++j) {
                const int vv = v0 + j * d;
#pragma unroll
                for (int i0 = 0; i0 < SPAN; i0 += AHEAD) {
                    // AHEAD positions of window row j: their pixels' entries
                    // in plane 0 and whether each lies in the image (out-of-
                    // image samples read as zeros)
                    const uint4* px[AHEAD];
                    bool in[AHEAD];
#pragma unroll
                    for (int k = 0; k < AHEAD; ++k) {
                        const int uu = u0 + (i0 + k) * d;
                        in[k] = i0 + k < SPAN && uu >= 0 && uu < w && vv >= 0 && vv < h;
                        px[k] = D11 + (in[k] ? (size_t)vv * w + uu : 0);
                    }
                    float s[AHEAD];
#pragma unroll
                    for (int k = 0; k < AHEAD; ++k) s[k] = 0.0f;
#pragma unroll
                    for (int e = 0; e < 3; ++e) {
                        uint4 raw[AHEAD];
#pragma unroll
                        for (int k = 0; k < AHEAD; ++k)
                            raw[k] = in[k] ? __ldg(px[k] + e * hw) : make_uint4(0, 0, 0, 0);
#pragma unroll
                        for (int c = 0; c < 4; ++c) {
#pragma unroll
                            for (int k = 0; k < AHEAD; ++k) {
                                const unsigned x = word(raw[k], c);
                                s[k] = fmaf(lo_bf16(x), g[8 * e + 2 * c], s[k]);
                                s[k] = fmaf(hi_bf16(x), g[8 * e + 2 * c + 1], s[k]);
                            }
                        }
                    }
#pragma unroll
                    for (int k = 0; k < AHEAD; ++k) {
                        const int idx = (i0 + k) * SPAN + j;
                        if (i0 + k < SPAN && (s[k] > lbest || (s[k] == lbest && idx < lidx))) {
                            lbest = s[k];
                            lidx = idx;
                        }
                    }
                }
            }
            // re-centre on the level's best, if it beat the running max
            if (lidx >= 0) {
                best = lbest;
                u = u0 + (lidx / SPAN) * d;
                v = v0 + (lidx % SPAN) * d;
            }
        }
    }
    p_out[2 * q] = u;
    p_out[2 * q + 1] = v;
    score_out[q] = best;
}

// The radii K3 is built for: r = 4 (config/base.yaml), 5
// (config/base_outdoor.yaml), 3 (refine_matches' default) and 2.  The
// wrapper (ops/refine_dense.py RADII) refuses any other.
template <int R>
int launch(const void* D11, const void* D21, const void* p_in, const void* valid, int n,
           int h, int w, int d_max, int d_min, float init_score, void* p_out,
           void* score_out, cudaStream_t stream)
{
    const int blocks = (n + THREADS - 1) / THREADS;
    refine_kernel<R><<<blocks, THREADS, 0, stream>>>(
        (const uint4*)D11, (const uint4*)D21, (const int*)p_in, (const uint8_t*)valid, n, h,
        w, d_max, d_min, init_score, (int*)p_out, (float*)score_out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int artdeco_refine(const void* D11, const void* D21, const void* p_in,
                              const void* valid, int n, int h, int w, int radius,
                              int d_max, int d_min, float init_score, void* p_out,
                              void* score_out, void* stream)
{
    if (n == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (radius) {
        case 2: return launch<2>(D11, D21, p_in, valid, n, h, w, d_max, d_min, init_score, p_out, score_out, st);
        case 3: return launch<3>(D11, D21, p_in, valid, n, h, w, d_max, d_min, init_score, p_out, score_out, st);
        case 4: return launch<4>(D11, D21, p_in, valid, n, h, w, d_max, d_min, init_score, p_out, score_out, st);
        case 5: return launch<5>(D11, D21, p_in, valid, n, h, w, d_max, d_min, init_score, p_out, score_out, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// K3's launch shape at `radius` (launch_info.cuh)
extern "C" int artdeco_refine_info(int radius, int* info)
{
    switch (radius) {
        case 2: return launch_info(refine_kernel<2>, THREADS, 1, info);
        case 3: return launch_info(refine_kernel<3>, THREADS, 1, info);
        case 4: return launch_info(refine_kernel<4>, THREADS, 1, info);
        case 5: return launch_info(refine_kernel<5>, THREADS, 1, info);
        default: return (int)cudaErrorInvalidValue;
    }
}

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
// bf16 values; such a product is exact in f32, so the kernel and the plain
// PyTorch version (ops/refine_dense.py) agree bit for bit.
//
// What bounds it on the H100: loads.  Each query reads 81 rows of 48 bytes
// per level (5 levels: ~19 KB per query, ~3.8 GB at 384x512), but
// neighbouring threads read neighbouring rows, so L1/L2 serve nearly all
// of it.  The query's 24 channels stay in registers; the image rows are
// read through the read-only cache as three 16-byte loads.  Shared-memory
// tiling and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F = 24;          // descriptor channels (three 16-byte loads)
constexpr int THREADS = 256;

__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p, float* out) {
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        uint4 raw = __ldg(p4 + k);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float2 f = __bfloat1622float2(h[e]);
            out[8 * k + 2 * e] = f.x;
            out[8 * k + 2 * e + 1] = f.y;
        }
    }
}

__global__ void __launch_bounds__(THREADS)
refine_kernel(const __nv_bfloat16* __restrict__ D11,   // (h*w, F)
              const __nv_bfloat16* __restrict__ D21,   // (n, F)
              const int* __restrict__ p_in,            // (n, 2) u, v
              const uint8_t* __restrict__ valid,       // (n,)
              int n, int h, int w, int radius, int d_max, int d_min,
              float init_score,
              int* __restrict__ p_out,                 // (n, 2)
              float* __restrict__ score_out)           // (n,)
{
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= n) return;
    int u = p_in[2 * q];
    int v = p_in[2 * q + 1];
    float best = init_score;
    if (valid[q]) {
        float g[F];
        load_row(D21 + (size_t)q * F, g);
        const int span = 2 * radius + 1;
        for (int d = d_max; d >= d_min; --d) {
            const int rd = radius * d;
            int bu = u, bv = v;
            for (int i = 0; i < span; ++i) {
                const int uu = u - rd + i * d;
                const bool in_u = uu >= 0 && uu < w;
                for (int j = 0; j < span; ++j) {
                    const int vv = v - rd + j * d;
                    float s = 0.0f;
                    if (in_u && vv >= 0 && vv < h) {
                        float r[F];
                        load_row(D11 + ((size_t)vv * w + uu) * F, r);
#pragma unroll
                        for (int c = 0; c < F; ++c) s = __fadd_rn(s, __fmul_rn(r[c], g[c]));
                    }
                    if (s > best) { best = s; bu = uu; bv = vv; }
                }
            }
            u = bu;
            v = bv;
        }
    }
    p_out[2 * q] = u;
    p_out[2 * q + 1] = v;
    score_out[q] = best;
}

}  // namespace

extern "C" int artdeco_refine(const void* D11, const void* D21, const void* p_in,
                              const void* valid, int n, int h, int w, int radius,
                              int d_max, int d_min, float init_score, void* p_out,
                              void* score_out, void* stream)
{
    if (n == 0) return 0;
    const int blocks = (n + THREADS - 1) / THREADS;
    refine_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)D11, (const __nv_bfloat16*)D21, (const int*)p_in,
        (const uint8_t*)valid, n, h, w, radius, d_max, d_min, init_score,
        (int*)p_out, (float*)score_out);
    return (int)cudaGetLastError();
}

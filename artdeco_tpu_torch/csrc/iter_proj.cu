// K4: iter_proj, the matching cascade's per-pixel 2-DoF Levenberg-Marquardt
// projection, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package left ``_iter_proj_single``
// (artdeco_tpu/ops/matching.py, vmapped over a batch's rows) to XLA.  Its
// eager PyTorch form (``iter_proj_plain`` in ops/matching.py) makes about a
// hundred small launches an LM iteration and reads the unconverged share
// back to the host once a row, and the wrapper looped over the rows in
// Python: on a host shared with the mapper's worker the cascade was
// host-bound and the device sat idle.  Here a call is two launches, whatever
// the batch, and nothing comes back to the host.
//
// 1. The head (``head_kernel``): one thread a pixel, grid (pixel blocks,
//    rows).  The thread reads its row's (h, w, 9) ray image directly (four
//    bilinear taps of 9 floats), runs the head iterations in registers and
//    writes u, v, lambda and the converged flag.  Each block writes its
//    count of converged pixels to its own slot (an integer: no atomics, so
//    the count does not depend on the order blocks run in).
// 2. The tail (``tail_kernel``): every block sums its row's slots and
//    applies the tail rule, 1 - n_conv / n > early_exit_frac in float32
//    (``tail_runs`` in ops/matching.py).  Where it holds, each thread
//    continues from the stored (u, v, lambda) to max_iter; the other rows'
//    blocks return at once.  The taps and weights are a pure function of the
//    accepted (u, v), so the tail samples them again instead of storing them.
//
// Semantics: bit for bit ``iter_proj_plain`` on the card.  Every operation
// is the plain path's, in its order, each rounded on its own: __fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn and __fsqrt_rn keep nvcc from contracting
// a product and a sum into an FMA (a global -fmad=false would take K3's
// FMAs too).  ``1.0 / x`` is PyTorch's reciprocal times 1.0, the same
// rounding as 1.0f / x; ``lam * 0.1`` multiplies by 0.1f, as PyTorch's CUDA
// kernels take a Python scalar in the tensor's type.  torch.clamp passes a
// NaN through (fminf / fmaxf would not), and a NaN coordinate gathers row 0
// through nan_to_num before the saturating int64 conversion and the clamp
// to [0, h*w - 1]; its NaN weights give a NaN cost, which rejects the step.
// The taps at lin + 1, lin + w and lin + w + 1 wrap modulo h*w, as the
// plain path's torch.roll does.
//
// What bounds it on the H100: bytes, far under the card.  The ray images
// (36 bytes a pixel) and the points and starts (20 bytes) are read once
// from device memory and the positions and flags (9 bytes) written once;
// the taps are read again from L1 and L2 every iteration (an LM step
// samples once: the accepted sample becomes the next step's current one),
// and the head's lambda (4 bytes) goes to the tail through L2.  At 512x288
// a row is 147456 pixels, 65 bytes each: 9.6 MB, 2.9 us at 3.35 TB/s.  The
// 36 scalar loads of a sample are each a warp's 32 pixels 36 bytes apart,
// about ten L1 wavefronts a load where pixels project near their own
// position.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int C = 9;           // channels of the ray image: unit ray, x and y gradients

// torch.clamp: a NaN passes through
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// a[0] * b[0] + a[1] * b[1] + a[2] * b[2], left to right, each step rounded
__device__ __forceinline__ float dot3(const float* a, const float* b) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])),
                     __fmul_rn(a[2], b[2]));
}

// The ray image interpolated at (u, v): the error of the normalised ray
// against the target point, its cost, and the interpolated gradients.
struct Sample {
    float err[3];
    float gx[3];
    float gy[3];
    float cost;
};

__device__ __forceinline__ void sample(const float* __restrict__ img, int h, int w, float u,
                                       float v, const float* pt, Sample& s) {
    const float u11 = floorf(u), v11 = floorf(v);
    const float du = __fsub_rn(u, u11), dv = __fsub_rn(v, v11);
    const long long hw = (long long)h * w;
    const float t = __fadd_rn(__fmul_rn(v11, (float)w), u11);
    long long lin = __float2ll_rz(isnan(t) ? 0.0f : t);
    lin = lin < 0 ? 0 : (lin > hw - 1 ? hw - 1 : lin);
    long long i1 = lin + 1, i2 = lin + w, i3 = lin + w + 1;
    if (i1 >= hw) i1 -= hw;
    if (i2 >= hw) i2 -= hw;
    if (i3 >= hw) i3 -= hw;
    const float* t0 = img + lin * C;
    const float* t1 = img + i1 * C;
    const float* t2 = img + i2 * C;
    const float* t3 = img + i3 * C;
    const float a = __fsub_rn(1.0f, du), c = __fsub_rn(1.0f, dv);
    const float w0 = __fmul_rn(a, c), w1 = __fmul_rn(du, c);
    const float w2 = __fmul_rn(a, dv), w3 = __fmul_rn(du, dv);
    float x[C];
#pragma unroll
    for (int k = 0; k < C; ++k)
        x[k] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w3, __ldg(t3 + k)),
                                             __fmul_rn(w2, __ldg(t2 + k))),
                                   __fmul_rn(w1, __ldg(t1 + k))),
                         __fmul_rn(w0, __ldg(t0 + k)));
    const float nrm = __fsqrt_rn(dot3(x, x));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        s.err[k] = __fsub_rn(__fdiv_rn(x[k], nrm), pt[k]);
        s.gx[k] = x[3 + k];
        s.gy[k] = x[6 + k];
    }
    s.cost = dot3(s.err, s.err);
}

// `iters` LM steps from (u, v, lam) with `cur` sampled at (u, v)
__device__ __forceinline__ void lm(const float* __restrict__ img, int h, int w,
                                   const float* pt, float thresh, int iters, float& u,
                                   float& v, float& lam, bool& conv, Sample& cur) {
    const float u_hi = (float)(w - 2), v_hi = (float)(h - 2);
    for (int it = 0; it < iters; ++it) {
        const float A00 = __fadd_rn(dot3(cur.gx, cur.gx), lam);
        const float A01 = dot3(cur.gx, cur.gy);
        const float A11 = __fadd_rn(dot3(cur.gy, cur.gy), lam);
        const float b0 = -dot3(cur.err, cur.gx);
        const float b1 = -dot3(cur.err, cur.gy);
        const float det_inv = __fdiv_rn(1.0f, __fsub_rn(__fmul_rn(A00, A11),
                                                        __fmul_rn(A01, A01)));
        const float du = __fmul_rn(det_inv, __fsub_rn(__fmul_rn(A11, b0), __fmul_rn(A01, b1)));
        const float dv = __fmul_rn(det_inv, __fadd_rn(__fmul_rn(-A01, b0), __fmul_rn(A00, b1)));
        const float u_new = clamp_nan(__fadd_rn(u, du), 1.0f, u_hi);
        const float v_new = clamp_nan(__fadd_rn(v, dv), 1.0f, v_hi);
        Sample nxt;
        sample(img, h, w, u_new, v_new, pt, nxt);
        const bool accept = nxt.cost < cur.cost;
        conv = accept ? nxt.cost < thresh : cur.cost < thresh;
        lam = accept ? __fmul_rn(lam, 0.1f) : __fmul_rn(lam, 10.0f);
        if (accept) {
            u = u_new;
            v = v_new;
            cur = nxt;
        }
    }
}

__global__ void __launch_bounds__(THREADS)
head_kernel(const float* __restrict__ rays,     // (b, h, w, 9)
            const float* __restrict__ pts,      // (b, n, 3)
            const float* __restrict__ p_init,   // (b, n, 2)
            int n, int h, int w, float lam0, float thresh, int iters,
            float* __restrict__ p_out,          // (b, n, 2)
            float* __restrict__ lam_out,        // (b, n)
            uint8_t* __restrict__ conv_out,     // (b, n)
            int* __restrict__ counts)           // (b, blocks)
{
    const int i = blockIdx.x * THREADS + threadIdx.x;
    bool conv = false;
    if (i < n) {
        const size_t q = (size_t)blockIdx.y * n + i;
        const float* img = rays + (size_t)blockIdx.y * h * w * C;
        const float pt[3] = {pts[3 * q], pts[3 * q + 1], pts[3 * q + 2]};
        float u = clamp_nan(p_init[2 * q], 1.0f, (float)(w - 2));
        float v = clamp_nan(p_init[2 * q + 1], 1.0f, (float)(h - 2));
        float lam = lam0;
        Sample cur;
        sample(img, h, w, u, v, pt, cur);
        lm(img, h, w, pt, thresh, iters, u, v, lam, conv, cur);
        p_out[2 * q] = u;
        p_out[2 * q + 1] = v;
        lam_out[q] = lam;
        conv_out[q] = conv;
    }
    const int c = __syncthreads_count(conv);
    if (threadIdx.x == 0) counts[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = c;
}

__global__ void __launch_bounds__(THREADS)
tail_kernel(const float* __restrict__ rays, const float* __restrict__ pts,
            const int* __restrict__ counts, int n, int h, int w, float thresh,
            float early_exit_frac, int iters,
            float* __restrict__ p,              // (b, n, 2), read and written
            const float* __restrict__ lam_in,
            uint8_t* __restrict__ conv_out)
{
    // the row's converged count, every thread of the block summing it
    __shared__ int part[THREADS / 32];
    int s = 0;
    for (int k = threadIdx.x; k < gridDim.x; k += THREADS)
        s += counts[(size_t)blockIdx.y * gridDim.x + k];
    s = __reduce_add_sync(0xffffffffu, s);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
    __syncthreads();
    int n_conv = 0;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) n_conv += part[k];
    // the tail rule (tail_runs): 1 - n_conv / n > early_exit_frac, in float32
    if (!(__fsub_rn(1.0f, __fdiv_rn((float)n_conv, (float)n)) > early_exit_frac)) return;
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const size_t q = (size_t)blockIdx.y * n + i;
    const float* img = rays + (size_t)blockIdx.y * h * w * C;
    const float pt[3] = {pts[3 * q], pts[3 * q + 1], pts[3 * q + 2]};
    float u = p[2 * q], v = p[2 * q + 1], lam = lam_in[q];
    bool conv = conv_out[q];
    Sample cur;
    sample(img, h, w, u, v, pt, cur);
    lm(img, h, w, pt, thresh, iters, u, v, lam, conv, cur);
    p[2 * q] = u;
    p[2 * q + 1] = v;
    conv_out[q] = conv;
}

}  // namespace

// iter_proj over b rows of n pixels: the head's `head` iterations, then,
// where max_iter > head, the tail's max_iter - head on the rows the tail
// rule picks.  `blocks` is the wrapper's ceil(n / 256), the rows' count
// slots in `counts`; `lam` is scratch of b * n floats.
extern "C" int artdeco_iter_proj(const void* rays, const void* pts, const void* p_init, int b,
                                 int n, int h, int w, int blocks, float lambda_init,
                                 float cost_thresh, float early_exit_frac, int head,
                                 int max_iter, void* p_out, void* conv_out, void* lam,
                                 void* counts, void* stream)
{
    if (b == 0 || n == 0) return 0;
    if (blocks != (n + THREADS - 1) / THREADS || b > 65535 || head < 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid(blocks, b);
    head_kernel<<<grid, THREADS, 0, st>>>(
        (const float*)rays, (const float*)pts, (const float*)p_init, n, h, w, lambda_init,
        cost_thresh, head, (float*)p_out, (float*)lam, (uint8_t*)conv_out, (int*)counts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || max_iter <= head) return (int)err;
    tail_kernel<<<grid, THREADS, 0, st>>>(
        (const float*)rays, (const float*)pts, (const int*)counts, n, h, w, cost_thresh,
        early_exit_frac, max_iter - head, (float*)p_out, (const float*)lam,
        (uint8_t*)conv_out);
    return (int)cudaGetLastError();
}

// K7: near-unity arbitrary-rate dual-PFB resampling of a 1-D float32
// stream.
//
// Replaces dsptpu/kernels/arbd.py:arbd_resample_pallas (:359, pallas_call
// :332).  With xcat = hist ‖ x, the host plan's end0_j (0-based window
// end in xcat), phi_j and alpha_j, and (W, nphi) banks pfb and dpfb:
//
//     y_j = lo_j + alpha_j * hi_j,
//     lo_j = sum_{t < W} pfb[t, phi_j] * xcat[end0_j - (W - 1) + t],
//
// hi_j the same over dpfb (reference stream_filt.jl:579-625).
//
// Bound on an H100: the bytes, 4 per input sample and 4 per output (the
// 4 W + 2 flops per output take about as long on the CUDA cores; the
// plan, 12 bytes per output, is read as well).  The design:
//   * a block owns `to` consecutive outputs and finds the least and
//     greatest window end among them (a warp reduction, then shared
//     atomics), so it needs no ordering of the plan;
//   * if their windows span at most `cap` samples, as they do at a rate
//     near one (about `to` + W), the block stages the span in shared
//     memory with coalesced loads; otherwise it reads xcat from global
//     memory;
//   * both banks (2 W nphi floats, 9.7 KB at W = 38, nphi = 32) are
//     staged in shared memory; near unity the phase moves slowly with
//     j, so a warp mostly reads one bank column (a broadcast);
//   * one thread per output runs the two dots in ascending tap order
//     with fused multiply-adds and writes y_j; stores are coalesced.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_cat(const float* __restrict__ hist,
                                          long long hl,
                                          const float* __restrict__ x,
                                          long long n, long long pos) {
    if (pos < 0 || pos >= hl + n) return 0.f;
    return pos < hl ? hist[pos] : x[pos - hl];
}

__global__ void __launch_bounds__(kThreads)
arbd_kernel(const float* __restrict__ hist, long long hl,
            const float* __restrict__ x, long long n,
            const int* __restrict__ end0, const int* __restrict__ phi,
            const float* __restrict__ alpha, const float* __restrict__ pfb,
            const float* __restrict__ dpfb, int W, int nphi,
            long long out_len, int to, int cap, float* __restrict__ y) {
    extern __shared__ float smem[];
    __shared__ int s_lo, s_hi;
    const int nb = W * nphi;
    float* bp = smem;
    float* bd = smem + nb;
    float* xs = smem + 2 * nb;
    const long long j0 = (long long)blockIdx.x * to;
    const int cnt = (int)min((long long)to, out_len - j0);

    if (threadIdx.x == 0) {
        s_lo = INT_MAX;
        s_hi = INT_MIN;
    }
    for (int i = threadIdx.x; i < nb; i += kThreads) {
        bp[i] = pfb[i];
        bd[i] = dpfb[i];
    }
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
        const int e = end0[j0 + i];
        lo = min(lo, e);
        hi = max(hi, e);
    }
    for (int off = 16; off > 0; off >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
        atomicMin(&s_lo, lo);
        atomicMax(&s_hi, hi);
    }
    __syncthreads();
    const long long base = (long long)s_lo - (W - 1);
    const long long span = (long long)s_hi - s_lo + W;
    const bool staged = span <= cap;
    if (staged)
        for (int i = threadIdx.x; i < span; i += kThreads)
            xs[i] = load_cat(hist, hl, x, n, base + i);
    __syncthreads();

    for (int i = threadIdx.x; i < cnt; i += kThreads) {
        const long long j = j0 + i;
        const long long start = (long long)end0[j] - (W - 1);
        const int p = phi[j];
        float acc_lo = 0.f, acc_hi = 0.f;
        if (staged) {
            const float* xw = xs + (start - base);
            for (int t = 0; t < W; ++t) {
                const float v = xw[t];
                acc_lo = fmaf(bp[t * nphi + p], v, acc_lo);
                acc_hi = fmaf(bd[t * nphi + p], v, acc_hi);
            }
        } else {
            for (int t = 0; t < W; ++t) {
                const float v = load_cat(hist, hl, x, n, start + t);
                acc_lo = fmaf(bp[t * nphi + p], v, acc_lo);
                acc_hi = fmaf(bd[t * nphi + p], v, acc_hi);
            }
        }
        y[j] = fmaf(alpha[j], acc_hi, acc_lo);
    }
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// hist (hl,) or null, x (n,), alpha (>= out_len,), pfb and dpfb
// (W, nphi), y (out_len,): float32; end0, phi (>= out_len,): int32; all
// contiguous.  smem_bytes = 4 (2 W nphi + cap), chosen by the wrapper
// (kernels/arbd.py).
int dsptpu_arbd(const void* hist, long long hl, const void* x, long long n,
                const void* end0, const void* phi, const void* alpha,
                const void* pfb, const void* dpfb, int W, int nphi,
                long long out_len, int to, int cap, long long smem_bytes,
                void* y, void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        arbd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (err != cudaSuccess) return err;
    const long long blocks = (out_len + to - 1) / to;
    arbd_kernel<<<(unsigned)blocks, kThreads, (size_t)smem_bytes,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(hist), hl, static_cast<const float*>(x), n,
        static_cast<const int*>(end0), static_cast<const int*>(phi),
        static_cast<const float*>(alpha), static_cast<const float*>(pfb),
        static_cast<const float*>(dpfb), W, nphi, out_len, to, cap,
        static_cast<float*>(y));
    return cudaGetLastError();
}

}  // extern "C"

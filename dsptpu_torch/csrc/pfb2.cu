// K6: rational L/M polyphase resampling of a 1-D float32 stream.
//
// Replaces dsptpu/kernels/pfb2.py:pfb2_resample_pallas (:487; both of
// its pallas_calls, the resident and the grouped kernel).  With
// xcat = hist ‖ x, q_j = phi0 - 1 + j M and w_j = deficit - taps +
// floor(q_j / L):
//
//     y_j = sum_{t < taps} pfb[t, q_j mod L] * xcat[w_j + t],
//
// zero where w_j + t lies outside xcat.  hist and x are read through two
// pointers, never concatenated.
//
// Bound on an H100: the bytes (4 per input sample, 4 per output); the
// 2 taps flops per output take about half as long on the CUDA cores.
// The design keeps every input and tap read after the first in shared
// memory:
//   * a block owns `to` consecutive outputs; w_j is monotone in j, so
//     they read one contiguous span [w_first, w_last + taps), about
//     to * M / L + taps samples, staged with coalesced loads (zero
//     outside xcat);
//   * the (taps, L) bank is staged too when it is at most 96 KB (the
//     wrapper's choice, `bank_smem`); a larger bank is read from global
//     memory, where L1 and L2 hold it;
//   * one thread per output runs its taps from shared memory, in
//     ascending tap order with fused multiply-adds, and the stores of a
//     warp are coalesced.
// q_j needs 64 bits: j * M passes 2^31 at 441/640 over 10M samples.

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
pfb2_kernel(const float* __restrict__ hist, long long hl,
            const float* __restrict__ x, long long n,
            const float* __restrict__ pfb, int taps, int L, long long M,
            long long phi0m1, long long deficit, long long out_len, int to,
            int bank_smem, float* __restrict__ y) {
    extern __shared__ float smem[];
    const int bank_f = bank_smem ? taps * L : 0;
    float* xs = smem + bank_f;
    const long long j0 = (long long)blockIdx.x * to;
    const long long j1 = min(j0 + to, out_len) - 1;
    const long long base = deficit - taps;
    const long long w0 = base + (phi0m1 + j0 * M) / L;
    const int span = (int)(base + (phi0m1 + j1 * M) / L + taps - w0);

    for (int i = threadIdx.x; i < bank_f; i += kThreads) smem[i] = pfb[i];
    for (int i = threadIdx.x; i < span; i += kThreads)
        xs[i] = load_cat(hist, hl, x, n, w0 + i);
    __syncthreads();

    const float* bank = bank_smem ? smem : pfb;
    for (long long j = j0 + threadIdx.x; j <= j1; j += kThreads) {
        const long long q = phi0m1 + j * M;
        const int col = (int)(q % L);
        const float* xw = xs + (base + q / L - w0);
        float acc = 0.f;
        for (int t = 0; t < taps; ++t)
            acc = fmaf(bank[t * L + col], xw[t], acc);
        y[j] = acc;
    }
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// hist (hl,) or null, x (n,), pfb (taps, L), y (out_len,): float32,
// contiguous.  phi0m1 = phi0 - 1 in [0, L).  The wrapper chooses `to`
// outputs per block, bank_smem and smem_bytes (kernels/pfb2.py,
// _launch_geometry), so that each block's span and the bank fit.
int dsptpu_pfb2(const void* hist, long long hl, const void* x, long long n,
                const void* pfb, int taps, int L, long long M,
                long long phi0m1, long long deficit, long long out_len,
                int to, int bank_smem, long long smem_bytes, void* y,
                void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        pfb2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (err != cudaSuccess) return err;
    const long long blocks = (out_len + to - 1) / to;
    pfb2_kernel<<<(unsigned)blocks, kThreads, (size_t)smem_bytes,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(hist), hl, static_cast<const float*>(x), n,
        static_cast<const float*>(pfb), taps, L, M, phi0m1, deficit, out_len,
        to, bank_smem, static_cast<float*>(y));
    return cudaGetLastError();
}

}  // extern "C"

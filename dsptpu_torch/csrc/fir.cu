// K1: causal FIR, y[t, c] = sum_k b[k] x[t - k, c], zero initial state.
//
// Replaces dsptpu/kernels/fir.py:fir_pallas (Pallas `_kernel`, :77).
// The signal keeps the public time-major (n, C) layout: no transpose on
// the way in or out.
//
// Bound on an H100: 2*nb flops per output in f32 on the CUDA cores
// (67 TFLOP/s) against 8 bytes per sample of HBM traffic (3.35 TB/s):
// at 127 taps the arithmetic bounds it.  So the design keeps the FMA
// pipes fed from registers:
//   * a block owns `tt` output times of `cw` channels (cw a power of two,
//     cw = 32 when C >= 32 so that a warp reads 128 contiguous bytes of
//     one time row); it stages those rows plus the nb-1 history rows,
//     zero outside [0, n), and the taps, in shared memory;
//   * each thread computes R consecutive outputs of one channel.  Taps
//     go in chunks of R: a chunk needs a window of 2R-1 inputs, loaded
//     once into registers, for R*R fused multiply-adds, so shared
//     memory is read 31 times per 256 FMAs;
//   * with cw < 32 a warp spans several time lanes, 16 rows apart; one
//     padding row per 16 rows spreads them over the banks.
// Accumulation is in f32, tap by tap in ascending order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int R = 16;
constexpr size_t kMaxSmem = 232448;   // per block on sm_90

__device__ __forceinline__ int skew(int row, int cw) {
    return cw < 32 ? row + (row >> 4) : row;
}

__global__ void __launch_bounds__(kThreads)
fir_kernel(const float* __restrict__ x, const float* __restrict__ taps,
           float* __restrict__ y, long long n, int C, int nb, int nbp,
           int cw, int tt) {
    extern __shared__ float smem[];
    float* hs = smem;                 // nbp taps, zero past nb
    float* xs = smem + nbp;           // (tt + nbp - 1) skewed rows x cw
    const int tid = threadIdx.x;
    const int cl = tid & (cw - 1);
    const int tl = tid / cw;
    const int tlanes = kThreads / cw;
    const int halo = nbp - 1;
    const long long t0 = (long long)blockIdx.x * tt;
    const int cbase = blockIdx.y * cw;

    for (int k = tid; k < nbp; k += kThreads) hs[k] = k < nb ? taps[k] : 0.f;
    const int rows = tt + halo;
    for (int e = tid; e < rows * cw; e += kThreads) {
        const int r = e / cw, l = e & (cw - 1);
        const long long t = t0 - halo + r;
        const int c = cbase + l;
        xs[skew(r, cw) * cw + l] =
            (t >= 0 && t < n && c < C) ? x[t * C + c] : 0.f;
    }
    __syncthreads();

    const int c = cbase + cl;
    for (int lt0 = tl * R; lt0 < tt; lt0 += tlanes * R) {
        float acc[R];
#pragma unroll
        for (int j = 0; j < R; ++j) acc[j] = 0.f;
        for (int k0 = 0; k0 < nbp; k0 += R) {
            // w[i] = x at local row lt0 + halo - k0 - (R-1) + i, so that
            // x[t0 + lt0 + j - (k0 + kk)] = w[j - kk + R - 1]
            const int base = lt0 + halo - k0 - (R - 1);
            float w[2 * R - 1];
#pragma unroll
            for (int i = 0; i < 2 * R - 1; ++i)
                w[i] = xs[skew(base + i, cw) * cw + cl];
#pragma unroll
            for (int kk = 0; kk < R; ++kk) {
                const float h = hs[k0 + kk];
#pragma unroll
                for (int j = 0; j < R; ++j)
                    acc[j] = fmaf(h, w[j - kk + R - 1], acc[j]);
            }
        }
        if (c < C) {
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const long long t = t0 + lt0 + j;
                if (t < n) y[t * C + c] = acc[j];
            }
        }
    }
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, y: (n, C) float32, contiguous; taps: (nb,) float32.
int dsptpu_fir(const void* x, const void* taps, void* y, long long n,
               int C, int nb, void* stream) {
    int cw = 1;
    while (cw < C && cw < 32) cw *= 2;
    const int tlanes = kThreads / cw;
    const int nbp = (nb + R - 1) / R * R;
    int passes = 512 / (tlanes * R);
    if (passes < 1) passes = 1;
    auto smem_of = [&](int p) {
        const int rows = tlanes * R * p + nbp - 1;
        const int srows = cw < 32 ? rows + rows / 16 + 1 : rows;
        return sizeof(float) * (nbp + (size_t)srows * cw);
    };
    // long taps: fewer outputs per block so that tile + history fit
    while (passes > 1 && smem_of(passes) > kMaxSmem) passes /= 2;
    const int tt = tlanes * R * passes;
    const size_t smem = smem_of(passes);
    cudaError_t err = cudaFuncSetAttribute(
        fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((unsigned)((n + tt - 1) / tt), (unsigned)((C + cw - 1) / cw));
    fir_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(taps),
        static_cast<float*>(y), n, C, nb, nbp, cw, tt);
    return cudaGetLastError();
}

}  // extern "C"

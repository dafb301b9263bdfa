// K3: fused windowed-segment power spectra (STFT power / Welch sums),
// with the frame loader of K3b folded in.
//
// Replaces dsptpu/kernels/stft.py:stft_pow_pallas (Pallas `_kernel`,
// :132) and its input-layout pass kernels/transpose.py:
// regroup_planes_pallas (:132).  For frames f < nframes of a time-major
// (n, C) float32 signal, starting at f*hop and zero past n, and a stack
// of K >= 1 windows win_m (K = 1: one window; K > 1: multitaper):
//     X_{f,m}[k] = sum_j win_m[j] x[f*hop + j] exp(-2 pi i j k / nfft)
//     P_f[k]     = sum_{m<K} |X_{f,m}[k]|^2   (m in order 0..K-1)
// for the bins k < nbins, written in bin order, either
//   * per frame:   out[k][f][c] = scale[k] P_f[k], or
//   * summed:      part[blk][k][c] = sum of P_f over the block's frames,
//                  then a second pass out[k][c] = scale[k] sum_blk part
//                  (a fixed order, no atomics: results repeat from run
//                  to run).
// nfft = N1 * 128 with 2 <= N1 <= 16, any N1.  The DFT is the four-step
// split of the TPU kernel, j = j2 + 128 j1, k = k1 + N1 k2:
//     X[k1 + N1 k2] = sum_j2 W128^(j2 k2) T[k1][j2] sum_j1 WN1^(j1 k1) x[j2 + 128 j1]
// done on the CUDA cores: a direct N1-point DFT across the planes, the
// twiddle T, and a radix-2 128-point FFT in shared memory.  Real input
// gives |X[k]| = |X[nfft - k]|, and bin nfft - k sits at row N1 - k1,
// column 127 - k2, so only rows k1 <= N1/2 are transformed.  All tables
// are computed in float64 on the host and cast to float32.
//
// Each frame is loaded into shared memory once.  With one window the
// load applies it; with a stack the frame stays raw and window m is
// applied where the first stage reads the planes, so the K windows share
// one load.  With K > 1 the windows' |X|^2 add into a per-frame
// accumulator of cg x nbins floats in shared memory, and scale[k] is
// applied once, at the store after the last window.  The windows are
// read from global memory (L1/L2), so K is not bounded by shared memory;
// the channel group cg halves from 8 until the block's buffers fit
// (nfft 2048, all bins, K > 1, summed: cg 4).
//
// Bound on an H100: reading the signal (overlapping frames read it
// twice, the second time mostly from L2) and, per frame, writing nbins
// floats per channel.  A real FFT with the window and |X|^2 needs ~28
// f32 flops per sample per frame and window for nfft 1024, less than
// those bytes at K = 1; at K = 7 the flops bound it.  This four-step
// split does ~48 per window (a direct N1-point DFT).
// A block loads `cg` channels of a frame with one pass over its rows.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 8;           // channels per block, at most
constexpr size_t kMaxSmem = 232448;    // shared memory a block may have

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

template <bool ACC>
__global__ void __launch_bounds__(kThreads)
stft_kernel(const float* __restrict__ x, const float* __restrict__ win,
            const float2* __restrict__ w1, const float2* __restrict__ tw,
            const float2* __restrict__ w128, const float* __restrict__ scale,
            float* __restrict__ out, long long n, int C, int N1, int hop,
            int nframes, int nbins, int cg, int fpb, int K) {
    extern __shared__ float smem[];
    const int nfft = N1 * 128;
    const int R = N1 / 2 + 1;
    const int xstride = nfft + 1;                  // spreads the banks
    float2* Z = reinterpret_cast<float2*>(smem);   // cg x R x 128
    float* xs = smem + 2 * cg * R * 128;           // cg x (nfft + 1), raw
    float* pacc = xs + cg * xstride;               // cg x nbins (K > 1)
    float* acc = pacc + (K > 1 ? cg * nbins : 0);  // cg x nbins (ACC)
    const int tid = threadIdx.x;
    const int cbase = blockIdx.y * cg;
    const int f0 = blockIdx.x * fpb;
    const int f1 = min(nframes, f0 + fpb);

    if (ACC)
        for (int e = tid; e < cg * nbins; e += kThreads) acc[e] = 0.f;

    for (int f = f0; f < f1; ++f) {
        // frame rows f*hop .. f*hop + nfft, cg channels, loaded once:
        // windowed here for one window, raw for a stack
        const long long t0 = (long long)f * hop;
        for (int e = tid; e < nfft * cg; e += kThreads) {
            const int j = e / cg, cl = e % cg;
            const long long t = t0 + j;
            const int c = cbase + cl;
            const float v = (t < n && c < C) ? x[t * C + c] : 0.f;
            xs[cl * xstride + j] = K == 1 ? v * win[j] : v;
        }
        __syncthreads();
        for (int wi = 0; wi < K; ++wi) {
            const float* wm = win + (long long)wi * nfft;
            // first stage over the j1 planes (window m applied here for a
            // stack) and twiddle, stored bit-reversed
            for (int e = tid; e < cg * R * 128; e += kThreads) {
                const int j2 = e & 127;
                const int k1 = (e >> 7) % R;
                const int cl = (e >> 7) / R;
                const float* xr = xs + cl * xstride + j2;
                const float* wr = wm + j2;
                float re = 0.f, im = 0.f;
                int m = 0;                              // (j1 * k1) mod N1
                for (int j1 = 0; j1 < N1; ++j1) {
                    float v = xr[128 * j1];
                    if (K > 1) v *= wr[128 * j1];
                    const float2 w = w1[m];
                    re = fmaf(v, w.x, re);
                    im = fmaf(v, w.y, im);
                    m += k1;
                    if (m >= N1) m -= N1;
                }
                const int dst = (cl * R + k1) * 128 + (__brev(j2) >> 25);
                Z[dst] = cmul(make_float2(re, im), tw[k1 * 128 + j2]);
            }
            __syncthreads();
            // 128-point radix-2 decimation-in-time FFT of every row, in place
            for (int s = 0; s < 7; ++s) {
                const int h = 1 << s;
                for (int e = tid; e < cg * R * 64; e += kThreads) {
                    const int row = e >> 6, b = e & 63;
                    const int pos = b & (h - 1);
                    const int i = ((b >> s) << (s + 1)) + pos;
                    float2* zr = Z + row * 128;
                    const float2 a = zr[i];
                    const float2 t = cmul(w128[pos << (6 - s)], zr[i + h]);
                    zr[i] = make_float2(a.x + t.x, a.y + t.y);
                    zr[i + h] = make_float2(a.x - t.x, a.y - t.y);
                }
                __syncthreads();
            }
            // |X|^2 in bin order; with K > 1 summed over the windows in the
            // per-frame accumulator (each entry stays with one thread)
            for (int e = tid; e < cg * nbins; e += kThreads) {
                const int cl = e % cg, k = e / cg;
                int k1 = k % N1, k2 = k / N1;
                if (k1 > N1 / 2) {
                    k1 = N1 - k1;
                    k2 = 127 - k2;
                }
                const float2 v = Z[(cl * R + k1) * 128 + k2];
                float p = v.x * v.x + v.y * v.y;
                if (K > 1) {
                    if (wi > 0) p += pacc[cl * nbins + k];
                    if (wi < K - 1) {
                        pacc[cl * nbins + k] = p;
                        continue;
                    }
                }
                if (ACC) {
                    acc[cl * nbins + k] += p;
                } else {
                    const int c = cbase + cl;
                    if (c < C)
                        out[((long long)k * nframes + f) * C + c] =
                            p * scale[k];
                }
            }
            __syncthreads();
        }
    }
    if (ACC) {
        for (int e = tid; e < cg * nbins; e += kThreads) {
            const int cl = e % cg, k = e / cg;
            const int c = cbase + cl;
            if (c < C)
                out[((long long)blockIdx.x * nbins + k) * C + c] =
                    acc[cl * nbins + k];
        }
    }
}

// out[k][c] = scale[k] * sum_{blk < nblk} part[blk][k][c], in blk order.
__global__ void reduce_kernel(const float* __restrict__ part,
                              const float* __restrict__ scale,
                              float* __restrict__ out, int nblk, int nbins,
                              int C) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long total = (long long)nbins * C;
    if (idx >= total) return;
    float s = 0.f;
    for (int b = 0; b < nblk; ++b) s += part[(long long)b * total + idx];
    out[idx] = s * scale[idx / C];
}

// Dynamic shared memory of one block, in bytes.
size_t stft_smem(int N1, int cg, int nbins, int K, int accumulate) {
    const int R = N1 / 2 + 1;
    return sizeof(float) * ((size_t)2 * cg * R * 128 +
                            (size_t)cg * (N1 * 128 + 1) +
                            (K > 1 ? (size_t)cg * nbins : 0) +
                            (accumulate ? (size_t)cg * nbins : 0));
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (n, C) float32; win: (K, nfft); w1: (N1,) complex; tw: (R, 128)
// complex; w128: (64,) complex; scale: (nbins,).  accumulate == 0:
// out (nbins, nframes, C).  accumulate != 0: part (nblk, nbins, C)
// scratch with nblk = ceil(nframes / fpb), out (nbins, C).
int dsptpu_stft_pow(const void* x, const void* win, const void* w1,
                    const void* tw, const void* w128, const void* scale,
                    void* part, void* out, long long n, int C, int N1,
                    int hop, int nframes, int nbins, int fpb,
                    int accumulate, int K, void* stream) {
    int cg = C < kMaxGroup ? C : kMaxGroup;
    while (cg > 1 && stft_smem(N1, cg, nbins, K, accumulate) > kMaxSmem)
        cg /= 2;
    const size_t smem = stft_smem(N1, cg, nbins, K, accumulate);
    auto st = static_cast<cudaStream_t>(stream);
    const dim3 grid((nframes + fpb - 1) / fpb, (C + cg - 1) / cg);
    const float* fx = static_cast<const float*>(x);
    const float* fw = static_cast<const float*>(win);
    const float2* f1 = static_cast<const float2*>(w1);
    const float2* ft = static_cast<const float2*>(tw);
    const float2* f2 = static_cast<const float2*>(w128);
    const float* fs = static_cast<const float*>(scale);
    cudaError_t err;
    if (accumulate) {
        err = cudaFuncSetAttribute(stft_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return err;
        stft_kernel<true><<<grid, kThreads, smem, st>>>(
            fx, fw, f1, ft, f2, fs, static_cast<float*>(part), n, C, N1, hop,
            nframes, nbins, cg, fpb, K);
        const long long total = (long long)nbins * C;
        reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
            static_cast<const float*>(part), fs, static_cast<float*>(out),
            (int)grid.x, nbins, C);
    } else {
        err = cudaFuncSetAttribute(stft_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return err;
        stft_kernel<false><<<grid, kThreads, smem, st>>>(
            fx, fw, f1, ft, f2, fs, static_cast<float*>(out), n, C, N1, hop,
            nframes, nbins, cg, fpb, K);
    }
    return cudaGetLastError();
}

}  // extern "C"

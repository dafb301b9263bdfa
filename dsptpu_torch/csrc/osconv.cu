// K4: overlap-save FFT convolution of the channels of a time-major
// (n, C) float32 signal with one real float32 filter.
//
// Replaces dsptpu/kernels/osconv.py:osconv_pallas (Pallas `_kernel`, :87).
// Block advance L (a multiple of 128), save S = nfft - L >= nv - 1:
// frame f covers x[f*L - S, f*L - S + nfft) (zero outside [0, n)) and
// gives the outputs y[f*L, f*L + L).  The TPU kernel pairs two frames of a
// channel into one complex frame and runs a four-step DFT as matmuls.
// Here one block takes a pair of adjacent channels of a frame (they read
// from the same rows of the time-major signal) as z = x_c + i x_{c+1};
// since the filter is real, ifft(fft(z) H) = (x_c * h) + i (x_{c+1} * h).
// The frame stays in shared memory through the whole pipeline:
//   1. load z (zero outside the signal);
//   2. forward DFT, decimation in frequency: with nfft = m * M (M the
//      largest power of two dividing nfft, m odd), an odd radix-m stage
//      (m = 1 for every power-of-two nfft, which is what the library's
//      size choice gives) folded into the load, then log2 M radix-2
//      stages, taken two at a time (radix 2^2: a thread carries four
//      points through both stages in registers, so each pair of stages
//      is one pass over shared memory and one barrier); the bins end in
//      bit-reversed order within each of the m sub-blocks;
//   3. multiply by H / nfft, stored by the wrapper in that same order
//      (no permutation pass);
//   4. inverse DFT, decimation in time: log2 M radix-2 stages (again two
//      at a time) from the bit-reversed order back to natural order, and
//      the inverse radix-m stage folded into the store;
//   5. store the L valid samples of both channels.
// Twiddles come from float64-built tables.  The radix-2 stage of span h
// needs w_{2h}^j for j < h; a block keeps those of every stage but the
// first in shared memory, each stage's contiguous at offset h - 1 (a
// warp's lanes read consecutive entries: a single table read at stride
// M/(2h) put all 32 lanes on one bank in most stages), and reads the
// first stage's, contiguous already, from the global table.  A block
// loops over frames (grid-stride), so it builds its tables once.
//
// Bound on an H100: the bytes, 8 per sample and channel (input read
// once, output written once); the FFT arithmetic is about 60% of that
// time on the CUDA cores at nfft 16384.  The frame is read with its
// save region, nfft / L times the input; neighbouring blocks read the
// other channels of the same rows, which L2 serves.  A frame of 16384
// complex points is 128 KB of shared memory, one block per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cconj(float2 a) {
    return make_float2(a.x, -a.y);
}

__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 acc) {
    acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
    acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
    return acc;
}

// Channels c0, c0+1 of sample s as one complex value, zero outside
// [0, n) and for a missing second channel.
__device__ __forceinline__ float2 load_pair(const float* __restrict__ x,
                                            long long s, long long n, int C,
                                            int c0, bool two, bool vec2) {
    if (s < 0 || s >= n) return make_float2(0.f, 0.f);
    const float* p = x + s * C + c0;
    if (vec2) return __ldg(reinterpret_cast<const float2*>(p));
    return make_float2(__ldg(p), two ? __ldg(p + 1) : 0.f);
}

// w_{2h}^j, j < h: the stage of span h's twiddle (h = M/2 from the global
// table, smaller spans from the block's per-stage table)
__device__ __forceinline__ float2 twid(const float2* tw,
                                       const float2* __restrict__ tw2g,
                                       int hM, int h, int j) {
    return h == hM ? __ldg(tw2g + j) : tw[h - 1 + j];
}

__global__ void __launch_bounds__(kThreads)
osconv_kernel(const float* __restrict__ x, const float2* __restrict__ Hp,
              const float2* __restrict__ wn, const float2* __restrict__ tw2g,
              float* __restrict__ y, long long n, int C, int N, int M,
              int logM, int L, long long nout, int K) {
    extern __shared__ float2 smem[];
    float2* buf = smem;           // N: the frame
    float2* tw = smem + N;        // M/2 - 1: tw[h-1+j] = w_{2h}^j, h < M/2
    const int tid = threadIdx.x;
    const int c0 = 2 * blockIdx.x;
    const bool two = c0 + 1 < C;
    const bool vec2 = two && !(C & 1) &&
                      !(reinterpret_cast<uintptr_t>(x) & 7) &&
                      !(reinterpret_cast<uintptr_t>(y) & 7);
    const int S = N - L;
    const int m = N >> logM;
    const int hM = M >> 1;
    const int half = N >> 1, quarter = N >> 2, qM = M >> 2;
    for (int e = tid; e < hM - 1; e += kThreads) {
        const int h = 1 << (31 - __clz(e + 1));   // e = h - 1 + j
        tw[e] = tw2g[(e + 1 - h) * (hM / h)];
    }

    for (int f = blockIdx.y; f < K; f += gridDim.y) {
        const long long s0 = (long long)f * L - S;
        // 1-2a. load, with the radix-m stage:
        //   buf[k1*M + r] = sum_{n1} z[n1*M + r] w_N^{(n1*M + r) k1}
        if (m == 1) {
            for (int e = tid; e < N; e += kThreads)
                buf[e] = load_pair(x, s0 + e, n, C, c0, two, vec2);
        } else {
            for (int e = tid; e < N; e += kThreads) {
                const int k1 = e >> logM, r = e & (M - 1);
                float2 acc = make_float2(0.f, 0.f);
                for (int n1 = 0; n1 < m; ++n1) {
                    const int idx = n1 * M + r;
                    acc = cfma(load_pair(x, s0 + idx, n, C, c0, two, vec2),
                               __ldg(wn + (int)(((long long)idx * k1) % N)),
                               acc);
                }
                buf[e] = acc;
            }
        }
        __syncthreads();
        // 2b. decimation in frequency within each M-point block, stages
        // of span h and q = h/2 together: points i, i+q, i+h, i+h+q
        int h = hM;
        for (; h >= 2; h >>= 2) {
            const int q = h >> 1, lq = __ffs(q) - 1;
            for (int u = tid; u < quarter; u += kThreads) {
                const int uu = u & (qM - 1);
                const int j = uu & (q - 1);
                const int i = (u >> (logM - 2)) * M + (uu >> lq) * 2 * h + j;
                const float2 a0 = buf[i], a1 = buf[i + q];
                const float2 a2 = buf[i + h], a3 = buf[i + h + q];
                const float2 b0 = cadd(a0, a2), b1 = cadd(a1, a3);
                const float2 b2 = cmul(csub(a0, a2),
                                       twid(tw, tw2g, hM, h, j));
                const float2 b3 = cmul(csub(a1, a3),
                                       twid(tw, tw2g, hM, h, j + q));
                const float2 wq = twid(tw, tw2g, hM, q, j);
                buf[i] = cadd(b0, b1);
                buf[i + q] = cmul(csub(b0, b1), wq);
                buf[i + h] = cadd(b2, b3);
                buf[i + h + q] = cmul(csub(b2, b3), wq);
            }
            __syncthreads();
        }
        if (h == 1) {     // log2 M odd: the last stage, span 1, alone
            for (int b = tid; b < half; b += kThreads) {
                const int i = (b >> (logM - 1)) * M + ((b & (hM - 1)) << 1);
                const float2 a = buf[i], c = buf[i + 1];
                buf[i] = cadd(a, c);
                buf[i + 1] = csub(a, c);
            }
            __syncthreads();
        }
        // 3. spectrum product (H / N, in this bin order)
        for (int e = tid; e < N; e += kThreads)
            buf[e] = cmul(buf[e], __ldg(Hp + e));
        __syncthreads();
        // 4a. decimation in time, conjugate twiddles, stages of span h
        // and 2h together: points i, i+h, i+2h, i+3h
        for (h = 1; 2 * h <= hM; h <<= 2) {
            const int lh = __ffs(h) - 1;
            for (int u = tid; u < quarter; u += kThreads) {
                const int uu = u & (qM - 1);
                const int j = uu & (h - 1);
                const int i = (u >> (logM - 2)) * M + (uu >> lh) * 4 * h + j;
                const float2 w1 = cconj(twid(tw, tw2g, hM, h, j));
                float2 t = cmul(buf[i + h], w1);
                const float2 a0 = buf[i];
                const float2 b0 = cadd(a0, t), b1 = csub(a0, t);
                t = cmul(buf[i + 3 * h], w1);
                const float2 a2 = buf[i + 2 * h];
                const float2 b2 = cadd(a2, t), b3 = csub(a2, t);
                t = cmul(b2, cconj(twid(tw, tw2g, hM, 2 * h, j)));
                buf[i] = cadd(b0, t);
                buf[i + 2 * h] = csub(b0, t);
                t = cmul(b3, cconj(twid(tw, tw2g, hM, 2 * h, j + h)));
                buf[i + h] = cadd(b1, t);
                buf[i + 3 * h] = csub(b1, t);
            }
            __syncthreads();
        }
        if (h == hM) {    // log2 M odd: the last stage, span M/2, alone
            for (int b = tid; b < half; b += kThreads) {
                const int j = b & (hM - 1);
                const int i = (b >> (logM - 1)) * M + j;
                const float2 a = buf[i];
                const float2 t = cmul(buf[i + hM], cconj(__ldg(tw2g + j)));
                buf[i] = cadd(a, t);
                buf[i + hM] = csub(a, t);
            }
            __syncthreads();
        }
        // 4b-5. store the valid samples [S, S + L), with the inverse
        // radix-m stage: z[t] = sum_{k1} buf[k1*M + (t mod M)] w_N^{-t k1}
        for (int j = tid; j < L; j += kThreads) {
            const long long t = (long long)f * L + j;
            if (t >= nout) break;
            const int nn = S + j;
            float2 v;
            if (m == 1) {
                v = buf[nn];
            } else {
                const int r = nn & (M - 1);
                v = make_float2(0.f, 0.f);
                for (int k1 = 0; k1 < m; ++k1) {
                    float2 w = __ldg(wn + (int)(((long long)nn * k1) % N));
                    w.y = -w.y;
                    v = cfma(buf[k1 * M + r], w, v);
                }
            }
            float* out = y + t * C + c0;
            if (vec2) {
                *reinterpret_cast<float2*>(out) = v;
            } else {
                out[0] = v.x;
                if (two) out[1] = v.y;
            }
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (n, C) float32; Hp: (N,) complex as float2, H / N in the kernel's
// bin order; wn: (N,) float2, exp(-2 pi i e / N); tw2: (M/2,) float2,
// exp(-2 pi i j / M); y: (nout, C).  N = nfft = m * M with m odd, M a
// power of two >= 128; L the block advance, a multiple of 128 with
// L <= N.
int dsptpu_osconv(const void* x, const void* Hp, const void* wn,
                  const void* tw2, void* y, long long n, int C, int N, int M,
                  int L, long long nout, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    if (M < 128 || (M & (M - 1)) || N % M || L <= 0 || L > N)
        return cudaErrorInvalidValue;
    int logM = 0;
    while ((1 << logM) < M) ++logM;
    const int K = (int)((nout + L - 1) / L);
    const int pairs = (C + 1) / 2;
    if (K <= 0 || pairs <= 0) return cudaSuccess;
    const size_t smem = sizeof(float2) * ((size_t)N + M / 2 - 1);
    cudaError_t err = cudaFuncSetAttribute(
        osconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, occ = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &occ, osconv_kernel, kThreads, smem)) != cudaSuccess)
        return err;
    if (occ < 1) occ = 1;
    // as many blocks as fit on the card at once, each looping over frames
    long long gy = (long long)sms * occ / pairs;
    if (gy < 1) gy = 1;
    if (gy > K) gy = K;
    osconv_kernel<<<dim3(pairs, (unsigned)gy), kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float2*>(Hp),
        static_cast<const float2*>(wn), static_cast<const float2*>(tw2),
        static_cast<float*>(y), n, C, N, M, logM, L, nout, K);
    return cudaGetLastError();
}

}  // extern "C"

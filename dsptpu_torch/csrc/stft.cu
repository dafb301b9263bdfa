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
//                  to run on the same card), or
//   * fused (K = 1): both of one transform of each frame, per frame with
//                  one scale and summed with another (the chain's STFT
//                  power and Welch PSD of the same frames). Its own
//                  instance, stft_fused_kernel, so that the other two
//                  compile as they would alone; the same frame blocks as
//                  the summed mode, so the sums repeat its values.
//
// Design (Hopper, CUDA cores, float32 throughout):
//   * Two real channels per complex transform: z = w (x_c + i x_{c+1}),
//     separated at the end, X_c[k] = (Z[k] + conj Z[-k]) / 2 and
//     X_{c+1}[k] = (Z[k] - conj Z[-k]) / 2i.  An odd C gives the last
//     transform a zero imaginary part.
//   * nfft = N1 * 128 (2 <= N1 <= 16) by three register passes with two
//     exchanges through shared memory, j = j2 + 128 j1, k = k1 + N1 k2,
//     j2 = jb + 8 ja, k2 = ka + 16 kb:
//       A  one job per (pair, j2): the N1 samples j1 of column j2 in
//          registers, windowed; an N1-point DFT (radix-2 for powers of
//          two, a direct DFT otherwise); twiddle W_nfft^(j2 k1);
//       B  one job per (pair, k1, jb): a 16-point radix-2 FFT over ja in
//          registers, twiddle W_128^(jb ka);
//       C  one job per (pair, super-job): two 8-point FFTs over jb, the
//          rows k1 and N1 - k1 (row 0 with itself), so that the thread
//          that has Z[k] also has Z[nfft - k]; it separates the channels
//          and adds |X|^2 of its 16 bins into registers.
//     The C thread of a bin is the same for every window and frame, so
//     the stack's sum over windows and the Welch sum over a block's
//     frames stay in registers: no shared accumulator, no atomics.
//   * Shared memory: a row of 128 points takes 144 float2 slots (column
//     j2 at jb + 9 ja, pairs innermost) so that passes B and C read
//     without bank conflicts at 4 pairs; the raw frame as a ring of nfft
//     rows: a block's later frames load only their new hop rows, by
//     cp.async while the previous frame's passes B and C run; the
//     twiddles W_nfft^(j2 k1), W_128^m, W_128^(jb ka) (laid out by jb,
//     conflict-free) and W_N1^m, built in float64 on the host, cast to
//     float32 and staged once per block (no fast-math sin/cos; 1 and -i
//     exact); and the windows when K nfft floats take <= 32 KB (the entry
//     point decides; else they are read through L1).  At most 128
//     registers a thread, so that two blocks of 256 threads share an SM.
//   * A block takes G channel pairs (G N1 = 32: 4 pairs at nfft 1024,
//     8 threads per pair and N1) and a fixed run of consecutive frames;
//     the grid is one wave of blocks (occupancy x SMs), so each block
//     walks about nframes * groups / slots frames.  Loads are 16 bytes
//     where the channel group and C allow; the per-frame store writes 2G
//     contiguous floats per (bin, frame).
//   * No tensor cores: TF32 alone would lose the port's float32
//     precision, and a 3xTF32 DFT-as-matmul does 20-40x the flops of an
//     FFT.  The TPU kernel used its matrix unit because the TPU's vector
//     unit is weak; an H100's CUDA cores give 67 TFLOP/s in float32.
//
// Bound on an H100: the bytes of reading the signal and (per frame and
// fused) writing nbins floats per frame and channel, at 3.35 TB/s; a real
// FFT with the window and |X|^2 (~2.5 nfft log2 nfft flops per frame and
// window) at 67 TFLOP/s bounds the K-window stack.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPairsN1 = 32;          // G * N1, channel pairs x N1 per block
constexpr int kRow = 144;             // float2 slots per 128-point row
constexpr int kMaxThreads = 8 * kPairsN1;
constexpr size_t kWinSmemMax = 32768;  // window bytes staged in shared memory

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__host__ __device__ constexpr int ilog2(int n) {
    int l = 0;
    while ((1 << l) < n) ++l;
    return l;
}

// The bit reversal of the register array, unrolled by template
// recursion so that every index is a compile-time constant (a register
// array indexed by a value known only at run time goes to local memory).
template <int I, int BITS>
struct BitRev {
    static constexpr int value =
        ((I & 1) << (BITS - 1)) | BitRev<(I >> 1), BITS - 1>::value;
};
template <int I>
struct BitRev<I, 0> {
    static constexpr int value = 0;
};

template <int N, int I = 0>
__device__ __forceinline__ void bitrev_permute(float2 (&a)[N]) {
    if constexpr (I < N) {
        constexpr int J = BitRev<I, ilog2(N)>::value;
        if constexpr (J > I) {
            const float2 t = a[I];
            a[I] = a[J];
            a[J] = t;
        }
        bitrev_permute<N, I + 1>(a);
    }
}

// The butterflies of span LEN, LEN * 2, ..., N (radix-2, decimation in
// time) on a bit-reversed register array; r128[m] = exp(-2 pi i m / 128).
// The roots 1 and -i are applied exactly.
template <int N, int LEN = 2>
__device__ __forceinline__ void dit_stages(float2 (&a)[N],
                                           const float2* r128) {
    if constexpr (LEN <= N) {
#pragma unroll
        for (int i = 0; i < N; i += LEN) {
#pragma unroll
            for (int j = 0; j < LEN / 2; ++j) {
                const float2 u = a[i + j];
                const float2 v = a[i + j + LEN / 2];
                // W^0 = 1 and W^32 = -i exactly; the rest from the table
                constexpr int kStep = 128 / LEN;
                const float2 t = j == 0 ? v
                    : j * kStep == 32 ? make_float2(v.y, -v.x)
                    : cmul(r128[j * kStep], v);
                a[i + j] = make_float2(u.x + t.x, u.y + t.y);
                a[i + j + LEN / 2] = make_float2(u.x - t.x, u.y - t.y);
            }
        }
        dit_stages<N, 2 * LEN>(a, r128);
    }
}

// In-place radix-2 FFT of N points (a power of two, N <= 128) in
// registers.
template <int N>
__device__ __forceinline__ void fft_pow2(float2 (&a)[N],
                                         const float2* r128) {
    bitrev_permute<N>(a);
    dit_stages<N>(a, r128);
}

// N-point DFT in registers: radix-2 for a power of two, else direct with
// the roots rN[m] = exp(-2 pi i m / N) (indices fixed at compile time),
// pairing j with N - j: with s = a[j] + a[N-j], d = a[j] - a[N-j],
// y[k] and y[N-k] = a[0] + sum_j s Re w^(jk) (+ a[N/2] (-1)^k for even
// N) +- i sum_j d Im w^(jk).
template <int N>
__device__ __forceinline__ void dft(float2 (&a)[N], const float2* r128,
                                    const float2* rN) {
    if constexpr ((N & (N - 1)) == 0) {
        fft_pow2<N>(a, r128);
    } else {
        constexpr int H = (N - 1) / 2;
        float2 w[N];
#pragma unroll
        for (int m = 0; m < N; ++m) w[m] = rN[m];
        float2 sj[H + 1], dj[H + 1];
        float2 y0 = a[0];
#pragma unroll
        for (int j = 1; j <= H; ++j) {
            sj[j] = make_float2(a[j].x + a[N - j].x, a[j].y + a[N - j].y);
            dj[j] = make_float2(a[j].x - a[N - j].x, a[j].y - a[N - j].y);
            y0.x += sj[j].x;
            y0.y += sj[j].y;
        }
        float2 yh = a[0];                        // y[N/2] for even N
        if constexpr (N % 2 == 0) {
            y0.x += a[N / 2].x;
            y0.y += a[N / 2].y;
#pragma unroll
            for (int j = 1; j < N; ++j) {
                const float sg = (j & 1) ? -1.f : 1.f;
                yh.x += sg * a[j].x;
                yh.y += sg * a[j].y;
            }
        }
#pragma unroll
        for (int k = 1; k <= H; ++k) {
            float2 p = a[0], q = make_float2(0.f, 0.f);
            if constexpr (N % 2 == 0) {
                const float sg = (k & 1) ? -1.f : 1.f;
                p.x += sg * a[N / 2].x;
                p.y += sg * a[N / 2].y;
            }
#pragma unroll
            for (int j = 1; j <= H; ++j) {
                const float2 r = w[(j * k) % N];
                p.x = fmaf(sj[j].x, r.x, p.x);
                p.y = fmaf(sj[j].y, r.x, p.y);
                // i d Im w
                q.x = fmaf(-dj[j].y, r.y, q.x);
                q.y = fmaf(dj[j].x, r.y, q.y);
            }
            a[k] = make_float2(p.x + q.x, p.y + q.y);
            a[N - k] = make_float2(p.x - q.x, p.y - q.y);
        }
        a[0] = y0;
        if constexpr (N % 2 == 0) a[N / 2] = yh;
    }
}

// |X_c[k]|^2 and |X_{c+1}[k]|^2 from Z[k] and Zm = Z[nfft - k], added
// into p0 and p1.
__device__ __forceinline__ void separate(float2 z, float2 zm, float& p0,
                                         float& p1) {
    const float ar = z.x + zm.x, ai = z.y - zm.y;
    const float br = z.x - zm.x, bi = z.y + zm.y;
    p0 += 0.25f * (ar * ar + ai * ai);
    p1 += 0.25f * (br * br + bi * bi);
}

// Copy 16 (or 4) bytes from global to shared memory without passing
// through registers (cp.async); !valid writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying rows t0 + j, jl <= j < nfft, of channels [cbase, +2G)
// into ring slots (t0 + j) mod nfft (zero past n and past C): 16-byte
// copies where vec, else 4-byte.
__device__ __forceinline__ void load_rows(
        float* raw, const float* __restrict__ x, long long n, int C,
        long long t0, int jl, int nfft, int cbase, int G, int vec) {
    const int base = (int)(t0 % nfft);
    const int wv = vec ? 4 : 1;                  // floats per copy
    const int V = 2 * G / wv;                    // copies per ring row
    for (int e = threadIdx.x; e < (nfft - jl) * V; e += blockDim.x) {
        const int j = jl + e / V, cl = wv * (e % V);
        const long long t = t0 + j;
        const int c = cbase + cl;
        const bool ok = t < n && c < C;
        int slot = base + j;
        if (slot >= nfft) slot -= nfft;
        float* dst = raw + slot * 2 * G + cl;
        const float* src = ok ? x + t * C + c : x;
        if (vec)
            cp_async16(dst, src, ok);
        else
            cp_async4(dst, src, ok);
    }
}

// Write bin k of channels c0 and c0 + 1 (p0, p1; c0 < C) at out row `row`
// of C floats, times scale[k] if scale.
__device__ __forceinline__ void store_bin(
        float* __restrict__ out, const float* __restrict__ scale,
        long long row, int k, int c0, int C, float p0, float p1) {
    const float s = scale ? scale[k] : 1.f;
    p0 *= s;
    p1 *= s;
    float* o = out + row * C + c0;
    if (c0 + 1 >= C) {
        o[0] = p0;
    } else if ((C & 1) == 0) {
        *reinterpret_cast<float2*>(o) = make_float2(p0, p1);
    } else {
        o[0] = p0;
        o[1] = p1;
    }
}

// Write one thread's 16 bins x 2 channels (acc as in stft_kernel) at the
// out rows k * rowmul + rowadd of C floats, times scale[k] if scale.
template <int N1>
__device__ __forceinline__ void store_bins(
        const float (&acc)[32], float* __restrict__ out,
        const float* __restrict__ scale, long long rowmul, long long rowadd,
        int a1, int aa, int b1, int ba, int c0, int C, int nbins) {
    if (c0 >= C) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int kb = 0; kb < 8; ++kb) {
            const int k = h == 0 ? a1 + N1 * (aa + 16 * kb)
                                 : b1 + N1 * (ba + 16 * kb);
            if (k >= nbins) continue;
            store_bin(out, scale, (long long)k * rowmul + rowadd, k, c0, C,
                      acc[8 * h + kb], acc[16 + 8 * h + kb]);
        }
    }
}

// Block (blockIdx.x, blockIdx.y): frames [blockIdx.x fpb, + fpb) of the
// channel pairs [blockIdx.y G, + G); blockDim.x = 8 N1 G threads. The
// body of both kernels: kFused false, the per-frame or (accumulate)
// summed mode into out; kFused true (K = 1), each frame's power times
// scale into frames (nbins, nframes, C) as it leaves pass C, and its sum
// over the block's frames, unscaled, into out as the summed mode's.
template <int N1, bool kFused>
__device__ __forceinline__ void stft_body(
        const float* __restrict__ x, const float* __restrict__ win,
        const float2* __restrict__ r1g, const float2* __restrict__ twg,
        const float2* __restrict__ r128g, const float* __restrict__ scale,
        float* __restrict__ out, float* __restrict__ frames, long long n,
        int C, int hop, int nframes, int nbins, int G, int fpb, int K,
        int stage_win, int accumulate, int vec) {
    constexpr int nfft = N1 * 128;
    extern __shared__ float4 smem4[];
    float* raw = reinterpret_cast<float*>(smem4);        // nfft x 2G ring
    float2* Z = reinterpret_cast<float2*>(raw + nfft * 2 * G);
    float2* tw = Z + N1 * kRow * G;                      // (N1, 128)
    float2* r128 = tw + nfft;           // 128 roots, then (16, 8) W128^(i q)
    float2* r1 = r128 + 256;                             // 16
    float* swin = reinterpret_cast<float*>(r1 + 16);     // K x nfft
    const int tid = threadIdx.x;
    const int T = blockDim.x;

    for (int e = tid; e < nfft; e += T) tw[e] = twg[e];
    for (int e = tid; e < 256; e += T) r128[e] = r128g[e];
    if (tid < N1) r1[tid] = r1g[tid];
    const float* wbase = win;
    if (stage_win) {
        for (int e = tid; e < K * nfft; e += T) swin[e] = win[e];
        wbase = swin;
    }

    const int cbase = blockIdx.y * 2 * G;
    const int f0 = blockIdx.x * fpb;
    const int f1 = min(nframes, f0 + fpb);
    // this thread: pair g; pass-B job (k1 = s1, jb = q); pass-C
    // super-job r: jobs A = (a1, aa) and B = (b1, ba), element kb of one
    // the mirror of element 7 - kb of the other (r = 0: each its own)
    const int g = tid % G;
    const int r = tid / G;
    const int s1 = r >> 3, q = r & 7;
    int a1, aa, b1, ba;
    if (s1 == 0) {
        a1 = 0; aa = q; b1 = 0; ba = q == 0 ? 8 : 16 - q;
    } else if (2 * s1 <= N1) {
        a1 = s1; aa = q; b1 = N1 - s1; ba = 15 - q;
    } else {
        a1 = N1 - s1; aa = q + 8; b1 = s1; ba = 7 - q;
    }
    const int c0 = cbase + 2 * g;
    // acc[kb]: A's bins, channel c0; [8 + kb] B's; [16 + ...] channel c0+1
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    // the ring holds rows t0 + j at slot (t0 + j) mod nfft. The first
    // frame loads all nfft rows; each later one only the rows past the
    // previous frame (hop < nfft), copied while the previous frame's
    // passes B and C run, once its last pass A has read the ring
    load_rows(raw, x, n, C, (long long)f0 * hop, 0, nfft, cbase, G, vec);
    cp_async_wait_all();
    __syncthreads();
    for (int f = f0; f < f1; ++f) {
        const long long t0 = (long long)f * hop;
        const int base = (int)(t0 % nfft);               // a multiple of 128
        if (!kFused && !accumulate) {
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        }
        for (int m = 0; m < K; ++m) {
            const float* wm = wbase + (long long)m * nfft;
            // pass A: column j2 of pair ga, N1-point DFT, twiddle
            for (int e = tid; e < G * 128; e += T) {
                const int ga = e % G, j2 = e / G;
                const float2* rp = reinterpret_cast<const float2*>(raw) + ga;
                float2 z[N1];
                int slot = base + j2;
#pragma unroll
                for (int j1 = 0; j1 < N1; ++j1) {
                    const float w = wm[j2 + 128 * j1];
                    const float2 v = rp[slot * G];
                    z[j1] = make_float2(w * v.x, w * v.y);
                    slot += 128;
                    if (slot >= nfft) slot -= nfft;
                }
                dft<N1>(z, r128, r1);
                float2* zp = Z + ((j2 & 7) + 9 * (j2 >> 3)) * G + ga;
#pragma unroll
                for (int k1 = 0; k1 < N1; ++k1)
                    zp[k1 * kRow * G] = k1 == 0
                        ? z[0] : cmul(z[k1], tw[k1 * 128 + j2]);
            }
            __syncthreads();
            if (m == K - 1 && f + 1 < f1)
                load_rows(raw, x, n, C, t0 + hop, hop < nfft ? nfft - hop : 0,
                          nfft, cbase, G, vec);
            // pass B: row s1, 16 points q + 8 ja, twiddle W128^(q ka)
            {
                float2* zp = Z + (s1 * kRow + q) * G + g;
                float2 a[16];
#pragma unroll
                for (int i = 0; i < 16; ++i) a[i] = zp[9 * i * G];
                fft_pow2<16>(a, r128);
#pragma unroll
                for (int i = 0; i < 16; ++i)
                    zp[9 * i * G] = i == 0 ? a[0]
                                           : cmul(a[i], r128[128 + 8 * i + q]);
            }
            __syncthreads();
            // pass C: 8-point FFTs of jobs A and B, |X|^2 of both channels
            {
                const float2* pa = Z + (a1 * kRow + 9 * aa) * G + g;
                const float2* pb = Z + (b1 * kRow + 9 * ba) * G + g;
                float2 A[8], B[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    A[i] = pa[i * G];
                    B[i] = pb[i * G];
                }
                fft_pow2<8>(A, r128);
                fft_pow2<8>(B, r128);
                if constexpr (kFused) {
                    // a bin's power goes to its frame's row and into the
                    // sum: only the sums live on past pass C
#pragma unroll
                    for (int kb = 0; kb < 8; ++kb) {
                        const float2 ma = r == 0 ? A[(8 - kb) & 7] : B[7 - kb];
                        const float2 mb = r == 0 ? B[7 - kb] : A[7 - kb];
                        float pa0 = 0.f, pa1 = 0.f, pb0 = 0.f, pb1 = 0.f;
                        separate(A[kb], ma, pa0, pa1);
                        separate(B[kb], mb, pb0, pb1);
                        const int ka = a1 + N1 * (aa + 16 * kb);
                        const int kB = b1 + N1 * (ba + 16 * kb);
                        if (c0 < C && ka < nbins)
                            store_bin(frames, scale,
                                      (long long)ka * nframes + f, ka, c0, C,
                                      pa0, pa1);
                        if (c0 < C && kB < nbins)
                            store_bin(frames, scale,
                                      (long long)kB * nframes + f, kB, c0, C,
                                      pb0, pb1);
                        acc[kb] += pa0;
                        acc[16 + kb] += pa1;
                        acc[8 + kb] += pb0;
                        acc[24 + kb] += pb1;
                    }
                } else if (r == 0) {
#pragma unroll
                    for (int kb = 0; kb < 8; ++kb) {
                        separate(A[kb], A[(8 - kb) & 7], acc[kb], acc[16 + kb]);
                        separate(B[kb], B[7 - kb], acc[8 + kb], acc[24 + kb]);
                    }
                } else {
#pragma unroll
                    for (int kb = 0; kb < 8; ++kb) {
                        separate(A[kb], B[7 - kb], acc[kb], acc[16 + kb]);
                        separate(B[kb], A[7 - kb], acc[8 + kb], acc[24 + kb]);
                    }
                }
            }
            // the next window's pass A overwrites Z
            if (m + 1 < K) __syncthreads();
        }
        if (!kFused && !accumulate)
            store_bins<N1>(acc, out, scale, nframes, f, a1, aa, b1, ba, c0,
                           C, nbins);
        // the next frame's rows have landed, and this frame's pass C is
        // done with Z
        if (f + 1 < f1) {
            cp_async_wait_all();
            __syncthreads();
        }
    }
    if (kFused || accumulate)
        store_bins<N1>(acc, out, nullptr, 1, (long long)blockIdx.x * nbins,
                       a1, aa, b1, ba, c0, C, nbins);
}

template <int N1>
__global__ void __launch_bounds__(kMaxThreads, 512 / kMaxThreads)
stft_kernel(const float* __restrict__ x, const float* __restrict__ win,
            const float2* __restrict__ r1g, const float2* __restrict__ twg,
            const float2* __restrict__ r128g,
            const float* __restrict__ scale, float* __restrict__ out,
            long long n, int C, int hop, int nframes, int nbins, int G,
            int fpb, int K, int stage_win, int accumulate, int vec) {
    stft_body<N1, false>(x, win, r1g, twg, r128g, scale, out, nullptr, n, C,
                         hop, nframes, nbins, G, fpb, K, stage_win,
                         accumulate, vec);
}

// The fused mode: part as the summed mode's, frames (nbins, nframes, C)
// times scale.
template <int N1>
__global__ void __launch_bounds__(kMaxThreads, 512 / kMaxThreads)
stft_fused_kernel(const float* __restrict__ x, const float* __restrict__ win,
                  const float2* __restrict__ r1g,
                  const float2* __restrict__ twg,
                  const float2* __restrict__ r128g,
                  const float* __restrict__ scale, float* __restrict__ part,
                  float* __restrict__ frames, long long n, int C, int hop,
                  int nframes, int nbins, int G, int fpb, int stage_win,
                  int vec) {
    stft_body<N1, true>(x, win, r1g, twg, r128g, scale, part, frames, n, C,
                        hop, nframes, nbins, G, fpb, 1, stage_win, 1, vec);
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

using KernelFn = void (*)(const float*, const float*, const float2*,
                          const float2*, const float2*, const float*, float*,
                          long long, int, int, int, int, int, int, int, int,
                          int, int);
using FusedFn = void (*)(const float*, const float*, const float2*,
                         const float2*, const float2*, const float*, float*,
                         float*, long long, int, int, int, int, int, int, int,
                         int);

struct Kernels {
    KernelFn pow;
    FusedFn fused;
};

template <int N1>
constexpr Kernels kernels_of() {
    return {stft_kernel<N1>, stft_fused_kernel<N1>};
}

Kernels kernels_for(int N1) {
    switch (N1) {
        case 2: return kernels_of<2>();
        case 3: return kernels_of<3>();
        case 4: return kernels_of<4>();
        case 5: return kernels_of<5>();
        case 6: return kernels_of<6>();
        case 7: return kernels_of<7>();
        case 8: return kernels_of<8>();
        case 9: return kernels_of<9>();
        case 10: return kernels_of<10>();
        case 11: return kernels_of<11>();
        case 12: return kernels_of<12>();
        case 13: return kernels_of<13>();
        case 14: return kernels_of<14>();
        case 15: return kernels_of<15>();
        case 16: return kernels_of<16>();
        default: return {nullptr, nullptr};
    }
}

// The launch geometry of one call: G pairs and 8 N1 G threads per block,
// nfb x groups blocks of fpb frames, windows staged or not. The fused
// kernel takes the per-frame and summed kernel's geometry (its occupancy
// sets nfb), so that its partial sums are the summed mode's.
struct Plan {
    Kernels kern;
    int G, threads, groups, fpb, nfb, stage;
    size_t smem;
};

int plan_launch(int N1, int C, int nframes, int K, bool fused, Plan* p) {
    p->kern = kernels_for(N1);
    if (p->kern.pow == nullptr || nframes < 1 || K < 1 || C < 1)
        return cudaErrorInvalidValue;
    const int nfft = N1 * 128;
    const int pairs = (C + 1) / 2;
    p->G = kPairsN1 / N1 < pairs ? kPairsN1 / N1 : pairs;
    p->threads = 8 * N1 * p->G;
    p->groups = (pairs + p->G - 1) / p->G;
    p->stage = (size_t)K * nfft * sizeof(float) <= kWinSmemMax;
    p->smem = sizeof(float) * (size_t)nfft * 2 * p->G +
              sizeof(float2) * ((size_t)N1 * kRow * p->G + nfft + 256 + 16) +
              (p->stage ? sizeof(float) * (size_t)K * nfft : 0);
    cudaError_t err = cudaFuncSetAttribute(
        p->kern.pow, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)p->smem);
    if (err == cudaSuccess && fused)
        err = cudaFuncSetAttribute(
            p->kern.fused, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)p->smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, occ = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, p->kern.pow,
                                                        p->threads, p->smem);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    int nfb = sms * occ / p->groups;
    nfb = nfb < 1 ? 1 : (nfb > nframes ? nframes : nfb);
    p->fpb = (nframes + nfb - 1) / nfb;
    p->nfb = (nframes + p->fpb - 1) / p->fpb;
    return cudaSuccess;
}

// out[k][c] = scale[k] * sum_blk part[blk][k][c] for a summed or fused
// launch of plan p.
void launch_reduce(const Plan& p, const void* part, const void* scale,
                   void* out, int nbins, int C, cudaStream_t st) {
    const long long total = (long long)nbins * C;
    reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(part), static_cast<const float*>(scale),
        static_cast<float*>(out), p.nfb, nbins, C);
}

int vec_loads(const Plan& p, const void* x, int C) {
    return (C % 4 == 0) && (p.G % 2 == 0) &&
           (reinterpret_cast<uintptr_t>(x) % 16 == 0);
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Number of frame blocks (partial sums) a summed or fused call of these
// shapes launches: the rows of its `part` scratch.
int dsptpu_stft_blocks(int N1, int C, int nframes, int K, int* nblk) {
    Plan p;
    const int err = plan_launch(N1, C, nframes, K, false, &p);
    *nblk = err == cudaSuccess ? p.nfb : 0;
    return err;
}

// x: (n, C) float32; win: (K, nfft); r1: (16,) complex W_N1^m; tw:
// (N1, 128) complex W_nfft^(j2 k1); r128: (256,) complex, W_128^m for
// m < 128, then W_128^(i q) at 128 + 8 i + q (i < 16, q < 8); scale:
// (nbins,).  accumulate == 0: out (nbins, nframes, C).  accumulate != 0:
// part (nblk, nbins, C) scratch with nblk from dsptpu_stft_blocks, out
// (nbins, C).
int dsptpu_stft_pow(const void* x, const void* win, const void* r1,
                    const void* tw, const void* r128, const void* scale,
                    void* part, void* out, long long n, int C, int N1,
                    int hop, int nframes, int nbins, int accumulate, int K,
                    void* stream) {
    Plan p;
    int err = plan_launch(N1, C, nframes, K, false, &p);
    if (err != cudaSuccess) return err;
    auto st = static_cast<cudaStream_t>(stream);
    const dim3 grid(p.nfb, p.groups);
    p.kern.pow<<<grid, p.threads, p.smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(win),
        static_cast<const float2*>(r1), static_cast<const float2*>(tw),
        static_cast<const float2*>(r128), static_cast<const float*>(scale),
        static_cast<float*>(accumulate ? part : out), n, C, hop, nframes,
        nbins, p.G, p.fpb, K, p.stage, accumulate, vec_loads(p, x, C));
    if (accumulate) launch_reduce(p, part, scale, out, nbins, C, st);
    return cudaGetLastError();
}

// The fused mode, one window (nfft,) and the arguments of
// dsptpu_stft_pow: out_frames (nbins, nframes, C) = scale_frame[k] P_f[k]
// and out_sum (nbins, C) = scale_sum[k] sum_f P_f[k] through part
// (nblk, nbins, C), nblk from dsptpu_stft_blocks(N1, C, nframes, 1).
int dsptpu_stft_pow_fused(const void* x, const void* win, const void* r1,
                          const void* tw, const void* r128,
                          const void* scale_frame, const void* scale_sum,
                          void* part, void* out_frames, void* out_sum,
                          long long n, int C, int N1, int hop, int nframes,
                          int nbins, void* stream) {
    Plan p;
    int err = plan_launch(N1, C, nframes, 1, true, &p);
    if (err != cudaSuccess) return err;
    auto st = static_cast<cudaStream_t>(stream);
    const dim3 grid(p.nfb, p.groups);
    p.kern.fused<<<grid, p.threads, p.smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(win),
        static_cast<const float2*>(r1), static_cast<const float2*>(tw),
        static_cast<const float2*>(r128),
        static_cast<const float*>(scale_frame), static_cast<float*>(part),
        static_cast<float*>(out_frames), n, C, hop, nframes, nbins, p.G,
        p.fpb, p.stage, vec_loads(p, x, C));
    launch_reduce(p, part, scale_sum, out_sum, nbins, C, st);
    return cudaGetLastError();
}

}  // extern "C"

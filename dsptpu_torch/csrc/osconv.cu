// K4: overlap-save FFT convolution of the channels of a time-major
// (n, C) float32 signal with one real float32 filter.
//
// Replaces dsptpu/kernels/osconv.py:osconv_pallas (Pallas `_kernel`, :87).
// Block advance L (a multiple of 128), save S = nfft - L >= nv - 1:
// frame f covers x[f*L - S, f*L - S + nfft) (zero outside [0, n)) and
// gives the outputs y[f*L, f*L + L).  The TPU kernel pairs two frames of a
// channel into one complex frame and runs a four-step DFT as matmuls.
// Here a transform takes a pair of adjacent channels of a frame (they
// read from the same rows of the time-major signal) as z = x_c + i x_{c+1};
// since the filter is real, ifft(fft(z) H) = (x_c * h) + i (x_{c+1} * h).
//
// Design (Hopper, CUDA cores, float32 throughout).  nfft = m * M with M
// the largest power of two dividing it (128 <= M <= 16384) and m odd; one
// template per M.  The M-point transform lives in registers: T = M / R
// threads hold R points each (R = 16 for M <= 256, else 32), and the
// transform is a mixed-radix decimation in frequency of P passes (radix R,
// then a last radix r = M / R^(P-1) <= R; P = 2 up to M = 1024, else 3):
//   * pass j < P: each thread runs an R-point DFT over the pass's digit
//     (points lo + n s_j of the sub-block at hi s_{j-1}, s_j = M / R^j)
//     and multiplies by W_{s_{j-1}}^(lo k), computed from two table
//     anchors W^lo and W^(R/4 lo) by a short chain of products;
//   * between passes one exchange through shared memory, position p at
//     slot p + p / R (one pad per R points, so that the last pass's R
//     consecutive points per thread fall on distinct banks), transforms
//     of a block interleaved slot by slot;
//   * the last pass (R / r DFTs of r consecutive points per thread) ends
//     with each thread's R bins in registers; the product with H / nfft
//     (stored by the wrapper in exactly this register order, coalesced)
//     follows in registers, and the inverse transform mirrors the forward
//     one from the same registers (conjugate DFTs and twiddles, DIT
//     order), so no exchange falls between forward, product and inverse:
//     2 (P - 1) exchanges per frame pair, against about 17 passes over
//     shared memory in a frame kept there;
//   * the frame is loaded from device memory straight into the first
//     pass's registers (thread t holds rows t + n s_1: neighbouring threads
//     on neighbouring rows) and the last inverse pass stores from
//     registers, the L valid samples of both channels.
// Every register index is a compile-time constant (DFTs and bit
// reversals unrolled by template recursion): a register array indexed at
// run time goes to local memory.  The in-register DFTs are radix 2 with
// the roots W_R^j as constants in the code, 1 and -i applied exactly.
//   * m = 1 (every power-of-two nfft, the library's choice): a block holds
//     G transforms, G (pair, frame) jobs side by side, pairs fastest, so
//     that a warp's loads cover neighbouring channel pairs of the same
//     rows; blocks walk job groups in a grid-stride loop.  At G = 1 (M >=
//     8192) one block holds one pair, and a warp's loads would take 8
//     bytes of each of 32 rows: every 32-byte sector crosses from L2 once
//     for each of the 4 pairs that share it (4x the sectors at C = 16).
//     So where C % 8 == 0 and x and y are 16-byte aligned, G = 1 takes the
//     cluster instance (osconv_kernel_cluster<M>, same FFT core, so the
//     outputs are bit for bit the per-pair instance's): a cluster of 4
//     CTAs, one an SM, takes one frame of 4 neighbouring pairs, channels
//     8q .. 8q + 7 (one sector of each row); rank k owns pair 4q + k.
//       - Loads: rank k reads a quarter of the frame's rows, all 8
//         channels (lane pairs on a row's 32 bytes, 16 bytes a lane, 16
//         loads a thread in flight), and puts each pair into its owner's
//         exchange buffer at the first pass's slot, through distributed
//         shared memory; after a cluster barrier each thread reads its
//         registers from its own buffer.
//       - Stores: after the inverse each CTA writes its frame into its
//         exchange buffer in register order; after a cluster barrier rank
//         k gathers a quarter of the L output rows from the 4 buffers and
//         writes each row's 32 bytes as two 16-byte stores.  A third
//         barrier, waited on before the next job's loads are put, keeps a
//         buffer until its readers are done; its arrival is relaxed, so
//         that it does not wait for the stores in flight.
//     A TMA design (256-row boxes multicast into an 8-box ring beside the
//     buffer, each CTA taking in all 4 pairs' bytes, an mbarrier
//     handshake across the cluster a box) took 4.6 ms for path A with the
//     transform knocked out, against 0.8 ms for this staging.
//     Every other shape (C % 8 != 0, M <= 4096 where G >= 2 already
//     shares sectors, odd m, unaligned views) keeps osconv_kernel<M, ODD>.
//   * m > 1: the odd radix-m stage is folded into the load (sub-block c:
//     sum over n1 of z[n1 M + r] W_nfft^((n1 M + r) c)) and the inverse one
//     into the store; a block takes one job at a time, its G transform
//     slots the sub-blocks c, each sub-block's inverse into a shared
//     result frame, and the store sums the m sub-blocks per output.
//   m = 1 and m > 1 are separate kernels (a template flag), so that the
//   m = 1 kernel does not carry the other's registers.
// Twiddles come from float64-built tables: wn (nfft) for the radix-m
// stage, tw2 = W_M^e (e < M/2) for the passes.
//
// Bound on an H100: the bytes, 8 per sample and channel (input read
// once, output written once); the FFT work (about 5 nfft log2 nfft flops
// per frame and pair each way) is some 60% of that time on the CUDA
// cores at nfft 16384.  The frame is read with its save region, nfft / L
// times the input; the other channel pairs of the same rows come from L2
// (once a sector on the cluster route).  The cluster route moves the
// frame through shared memory twice more (the staging and the gather)
// and waits at 3 cluster barriers a job, with one CTA an SM at M = 16384:
// on path A about half its time is the transform.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cconj(float2 a) {
    return make_float2(a.x, -a.y);
}

__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 acc) {
    acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
    acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
    return acc;
}

__host__ __device__ constexpr int ilog2(int n) {
    int l = 0;
    while ((1 << l) < n) ++l;
    return l;
}

__host__ __device__ constexpr int ipow(int b, int e) {
    int r = 1;
    for (int i = 0; i < e; ++i) r *= b;
    return r;
}

// W_32^j = exp(-2 pi i j / 32), j < 16, rounded to float32: the roots of
// the in-register DFTs (W_R^j = W_32^(32 j / R)), folded into the code as
// constants once the DFTs are unrolled.
__host__ __device__ constexpr float w32_re(int j) {
    switch (j) {
        case 0: return 1.0f;
        case 1: return 0.980785251f;
        case 2: return 0.923879504f;
        case 3: return 0.831469595f;
        case 4: return 0.707106769f;
        case 5: return 0.555570245f;
        case 6: return 0.382683426f;
        case 7: return 0.195090324f;
        case 9: return -0.195090324f;
        case 10: return -0.382683426f;
        case 11: return -0.555570245f;
        case 12: return -0.707106769f;
        case 13: return -0.831469595f;
        case 14: return -0.923879504f;
        case 15: return -0.980785251f;
        default: return 0.f;
    }
}

__host__ __device__ constexpr float w32_im(int j) {
    switch (j) {
        case 1: return -0.195090324f;
        case 2: return -0.382683426f;
        case 3: return -0.555570245f;
        case 4: return -0.707106769f;
        case 5: return -0.831469595f;
        case 6: return -0.923879504f;
        case 7: return -0.980785251f;
        case 8: return -1.0f;
        case 9: return -0.980785251f;
        case 10: return -0.923879504f;
        case 11: return -0.831469595f;
        case 12: return -0.707106769f;
        case 13: return -0.555570245f;
        case 14: return -0.382683426f;
        case 15: return -0.195090324f;
        default: return 0.f;
    }
}

// Passes of radix R (the last one r <= R) that an M-point transform takes.
__host__ __device__ constexpr int npasses(int M, int R) {
    int p = 1, rem = M;
    while (rem > R) {
        rem /= R;
        ++p;
    }
    return p;
}

// The plan of an M-point transform; kernels/osconv.py:_geometry mirrors it.
template <int M>
struct Plan {
    static constexpr int R = M <= 256 ? 16 : 32;   // points per thread
    static constexpr int T = M / R;                // threads per transform
    static constexpr int G = 256 / T > 1 ? 256 / T : 1;  // per block
    static constexpr int THREADS = G * T;
    static constexpr int MINB = 65536 / (THREADS * 128);  // <= 128 regs
    static constexpr int A = R / 4;                // twiddle anchor
    static constexpr int SLOT = M + M / R;         // padded slots
    static constexpr int P = npasses(M, R);
    static constexpr int LAST = M / ipow(R, P - 1);   // last pass's radix
    // s_j: the stride of pass j's digit (s_0 = M, s_P = 1)
    __host__ __device__ static constexpr int stride(int j) {
        return j >= P ? 1 : M / ipow(R, j);
    }
};

// Digit reversal of I over BITS bits, at compile time.
template <int I, int BITS>
struct BitRev {
    static constexpr int value =
        ((I & 1) << (BITS - 1)) | BitRev<(I >> 1), BITS - 1>::value;
};
template <int I>
struct BitRev<I, 0> {
    static constexpr int value = 0;
};

template <int R, int N, int OFF, int I = 0>
__device__ __forceinline__ void bitrev_sub(float2 (&a)[R]) {
    if constexpr (I < N) {
        constexpr int J = BitRev<I, ilog2(N)>::value;
        if constexpr (J > I) {
            const float2 t = a[OFF + I];
            a[OFF + I] = a[OFF + J];
            a[OFF + J] = t;
        }
        bitrev_sub<R, N, OFF, I + 1>(a);
    }
}

// Radix-2 decimation-in-time stages of span LEN, 2 LEN, ..., N on the
// bit-reversed points a[OFF .. OFF + N).
template <int R, int N, int OFF, int LEN = 2>
__device__ __forceinline__ void dit_sub(float2 (&a)[R]) {
    if constexpr (LEN <= N) {
        constexpr int kStep = 32 / LEN;      // W_LEN^j = W_32^(32 j / LEN)
#pragma unroll
        for (int i = 0; i < N; i += LEN) {
#pragma unroll
            for (int j = 0; j < LEN / 2; ++j) {
                const float2 u = a[OFF + i + j];
                const float2 v = a[OFF + i + j + LEN / 2];
                const float2 t = j == 0 ? v
                    : j * kStep == 8 ? make_float2(v.y, -v.x)
                    : cmul(make_float2(w32_re(j * kStep), w32_im(j * kStep)),
                           v);
                a[OFF + i + j] = make_float2(u.x + t.x, u.y + t.y);
                a[OFF + i + j + LEN / 2] = make_float2(u.x - t.x, u.y - t.y);
            }
        }
        dit_sub<R, N, OFF, 2 * LEN>(a);
    }
}

// N-point DFT (N a power of two) of a[OFF .. OFF + N) in place, natural
// order in and out; INV: the unnormalised inverse, conj(dft(conj(a))).
template <int R, int N, int OFF, bool INV>
__device__ __forceinline__ void dft_sub(float2 (&a)[R]) {
    if constexpr (INV) {
#pragma unroll
        for (int i = 0; i < N; ++i) a[OFF + i].y = -a[OFF + i].y;
    }
    bitrev_sub<R, N, OFF>(a);
    dit_sub<R, N, OFF>(a);
    if constexpr (INV) {
#pragma unroll
        for (int i = 0; i < N; ++i) a[OFF + i].y = -a[OFF + i].y;
    }
}

// The last pass: R / r DFTs of r consecutive registers.
template <int R, int r, bool INV, int GI = 0>
__device__ __forceinline__ void last_pass(float2 (&a)[R]) {
    if constexpr (GI < R / r) {
        dft_sub<R, r, GI * r, INV>(a);
        last_pass<R, r, INV, GI + 1>(a);
    }
}

// a[k] *= W_{s_{j-1}}^(lo k) (conjugated for the inverse), from the
// anchors w1 = W^lo and wa = W^(A lo): W^(q A + b) = wa^q w1^b, a chain
// of products from wa^q (few live registers; the error grows to some
// ten roundings).
template <int M, bool INV>
__device__ __forceinline__ void twiddle(float2 (&a)[Plan<M>::R], int e,
                                        const float2* __restrict__ tw2) {
    using PL = Plan<M>;
    constexpr int R = PL::R, A = PL::A;
    if (e == 0) return;
    const float2 w1 = __ldg(tw2 + e);
    const float2 wa = __ldg(tw2 + A * e);
    float2 pa = wa;
#pragma unroll
    for (int q = 0; q < R / A; ++q) {
        float2 w = q == 0 ? w1 : pa;
#pragma unroll
        for (int b = q == 0 ? 1 : 0; b < A; ++b) {
            a[q * A + b] = cmul(a[q * A + b], INV ? cconj(w) : w);
            if (b + 1 < A) w = cmul(w, w1);
        }
        if (q > 0 && q + 1 < R / A) pa = cmul(pa, wa);
    }
}

// The exchange slot (p + p / R) of pass J's register n in thread t, as a
// run-time base plus a compile-time offset, so that a thread's R accesses
// share one address register: pass J < P holds positions hi s_{J-1} +
// n s_J + lo (lo < s_J; s_{J-1} a multiple of R, and s_J either a multiple
// of R or a divisor of it); the last pass holds t R + n.
template <int M, int J>
__device__ __forceinline__ int slot_base(int t) {
    using PL = Plan<M>;
    constexpr int R = PL::R;
    if constexpr (J >= PL::P) {
        return t * (R + 1);
    } else {
        constexpr int sj = PL::stride(J), sp = PL::stride(J - 1);
        const int hi = t / sj, lo = t % sj;
        if constexpr (sj >= R) {
            const int b = hi * sp + lo;
            return b + b / R;
        } else {
            return hi * (sp + sp / R) + lo;
        }
    }
}

template <int M, int J>
__host__ __device__ constexpr int slot_off(int n) {
    using PL = Plan<M>;
    constexpr int R = PL::R;
    constexpr int s = J >= PL::P ? 1 : PL::stride(J);
    return s >= R ? n * (s + s / R) : n * s + n * s / R;
}

// Move the registers from pass JF's layout to pass JT's through the
// block's exchange buffer (the G transforms interleaved slot by slot).
template <int M, int JF, int JT>
__device__ __forceinline__ void exchange(float2 (&a)[Plan<M>::R], float2* ex,
                                         int t, int g) {
    using PL = Plan<M>;
    constexpr int R = PL::R, G = PL::G;
    __syncthreads();
    {
        float2* e = ex + slot_base<M, JF>(t) * G + g;
#pragma unroll
        for (int n = 0; n < R; ++n) e[slot_off<M, JF>(n) * G] = a[n];
    }
    __syncthreads();
    {
        const float2* e = ex + slot_base<M, JT>(t) * G + g;
#pragma unroll
        for (int n = 0; n < R; ++n) a[n] = e[slot_off<M, JT>(n) * G];
    }
}

// Forward passes J..P-1 (each: exchange from the previous pass's layout
// unless J = 1, DFT, twiddle), then the exchange into the last pass.
template <int M, int J = 1>
__device__ __forceinline__ void forward_passes(float2 (&a)[Plan<M>::R],
                                               float2* ex, int t, int g,
                                               const float2* __restrict__ tw2) {
    using PL = Plan<M>;
    if constexpr (J < PL::P) {
        if constexpr (J > 1) exchange<M, J - 1, J>(a, ex, t, g);
        dft_sub<PL::R, PL::R, 0, false>(a);
        twiddle<M, false>(a, (t % PL::stride(J)) * (M / PL::stride(J - 1)),
                          tw2);
        forward_passes<M, J + 1>(a, ex, t, g, tw2);
    } else {
        exchange<M, PL::P - 1, PL::P>(a, ex, t, g);
    }
}

// Inverse passes J..1 (each: exchange from pass J + 1's layout,
// conjugate twiddle, inverse DFT).
template <int M, int J>
__device__ __forceinline__ void inverse_passes(float2 (&a)[Plan<M>::R],
                                               float2* ex, int t, int g,
                                               const float2* __restrict__ tw2) {
    using PL = Plan<M>;
    if constexpr (J >= 1) {
        exchange<M, J + 1, J>(a, ex, t, g);
        twiddle<M, true>(a, (t % PL::stride(J)) * (M / PL::stride(J - 1)),
                         tw2);
        dft_sub<PL::R, PL::R, 0, true>(a);
        inverse_passes<M, J - 1>(a, ex, t, g, tw2);
    }
}

// The whole pipeline on registers in the first pass's layout (point
// n s_1 + t of the sub-block): forward transform, product with the
// spectrum slots hp[n T + t], inverse transform, same layout.
template <int M>
__device__ __forceinline__ void convolve(float2 (&a)[Plan<M>::R], float2* ex,
                                         int t, int g,
                                         const float2* __restrict__ tw2,
                                         const float2* __restrict__ hp) {
    using PL = Plan<M>;
    forward_passes<M>(a, ex, t, g, tw2);
    last_pass<PL::R, PL::LAST, false>(a);
#pragma unroll
    for (int n = 0; n < PL::R; ++n)
        a[n] = cmul(a[n], __ldg(hp + n * PL::T + t));
    last_pass<PL::R, PL::LAST, true>(a);
    inverse_passes<M, PL::P - 1>(a, ex, t, g, tw2);
}

// The pair at p (channels c0, c0 + 1 of one row), zero unless `in`.
__device__ __forceinline__ float2 load_at(const float* __restrict__ p,
                                          bool in, bool two, bool vec2) {
    if (!in) return make_float2(0.f, 0.f);
    if (vec2) return __ldg(reinterpret_cast<const float2*>(p));
    return make_float2(__ldg(p), two ? __ldg(p + 1) : 0.f);
}

__device__ __forceinline__ void store_at(float* __restrict__ out, bool two,
                                         bool vec2, float2 v) {
    if (vec2) {
        *reinterpret_cast<float2*>(out) = v;
    } else {
        out[0] = v.x;
        if (two) out[1] = v.y;
    }
}

// Thread tid = g + G t: transform slot g, point group t.  ODD: nfft = m M
// with m > 1 odd, else m = 1 (two kernels, so that neither carries the
// other's registers).  The ODD kernels (sizes the library's own nfft
// choice never takes) run with registers uncapped, so that they do not
// spill.
template <int M, bool ODD>
__global__ void __launch_bounds__(Plan<M>::THREADS, ODD ? 1 : Plan<M>::MINB)
osconv_kernel(const float* __restrict__ x, const float2* __restrict__ Hp,
              const float2* __restrict__ wn, const float2* __restrict__ tw2,
              float* __restrict__ y, long long n, int C, int N, int L,
              long long nout, int K) {
    using PL = Plan<M>;
    constexpr int R = PL::R, T = PL::T, G = PL::G;
    constexpr int S1 = PL::stride(1);
    extern __shared__ float2 smem[];
    float2* ex = smem;                         // G * SLOT exchange slots
    float2* res = ex + G * PL::SLOT;           // ODD: the frame, N
    const int tid = threadIdx.x;
    const int g = tid % G, t = tid / G;
    const int m = N / M;
    const int S = N - L;
    const int pairs = (C + 1) / 2;
    const int jobs = pairs * K;        // < 2^31 (checked at the launch)
    const bool vec2a = !(C & 1) && !(reinterpret_cast<uintptr_t>(x) & 7) &&
                       !(reinterpret_cast<uintptr_t>(y) & 7);
    float2 a[R];

    if constexpr (!ODD) {
        const int groups = (jobs + G - 1) / G;
        for (int jg = blockIdx.x; jg < groups; jg += gridDim.x) {
            const int J = jg * G + g;
            const bool active = J < jobs;
            const int pair = active ? J % pairs : 0;
            const long long f = active ? J / pairs : 0;
            const int c0 = 2 * pair;
            const bool two = c0 + 1 < C;
            const bool vec2 = two && vec2a;
            // register i holds row r0 + i S1 of the frame, output row
            // r0 - S + i S1: one base pointer each, a fixed stride
            const long long r0 = f * L - S + t;
            const long long step = (long long)S1 * C;
            const float* px = x + r0 * C + c0;
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const long long row = r0 + i * S1;
                a[i] = load_at(px + i * step, active && row >= 0 && row < n,
                               two, vec2);
            }
            convolve<M>(a, ex, t, g, tw2, Hp);
            if (!active) continue;
            float* py = y + (f * L + t - S) * C + c0;
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const int r = i * S1 + t;
                if (r >= S && f * L + (r - S) < nout)
                    store_at(py + i * step, two, vec2, a[i]);
            }
        }
    } else {
    for (int J = blockIdx.x; J < jobs; J += gridDim.x) {
        const int c0 = 2 * (J % pairs);
        const long long f = J / pairs;
        const bool two = c0 + 1 < C;
        const bool vec2 = two && vec2a;
        const long long s0 = f * L - S;
        for (int kb = 0; kb < m; kb += G) {
            const int c = kb + g;               // sub-block of this slot
            // the radix-m stage: sum_{n1} z[n1 M + r] W_N^((n1 M + r) c),
            // the twiddle's exponent stepped by M c mod N; one point at a
            // time into this thread's own first-pass slots (no other
            // thread touches them between exchanges), then into registers
            const int dM = M * c % N;
            const long long step = (long long)M * C;
            float2* own = ex + slot_base<M, 1>(t) * G + g;
#pragma unroll 1
            for (int i = 0; i < R; ++i) {
                const int r = i * S1 + t;
                const float* px = x + (s0 + r) * C + c0;
                float2 acc = make_float2(0.f, 0.f);
                if (c < m) {
                    int e = r * c % N;
                    for (int n1 = 0; n1 < m; ++n1) {
                        const long long row = s0 + n1 * M + r;
                        acc = cfma(load_at(px + n1 * step, row >= 0 && row < n,
                                           two, vec2),
                                   __ldg(wn + e), acc);
                        e += dM;
                        if (e >= N) e -= N;
                    }
                }
                own[slot_off<M, 1>(i) * G] = acc;
            }
#pragma unroll
            for (int i = 0; i < R; ++i) a[i] = own[slot_off<M, 1>(i) * G];
            convolve<M>(a, ex, t, g, tw2,
                        Hp + (long long)(c < m ? c : 0) * M);
            if (c < m) {
#pragma unroll
                for (int i = 0; i < R; ++i) res[c * M + i * S1 + t] = a[i];
            }
        }
        __syncthreads();
        // the inverse radix-m stage and the store of the valid samples:
        // z[nn] = sum_c res[c M + (nn mod M)] W_N^(-nn c)
        for (int j = tid; j < L; j += PL::THREADS) {
            const long long to = f * L + j;
            if (to >= nout) break;
            const int nn = S + j;
            const int r = nn & (M - 1);
            float2 v = make_float2(0.f, 0.f);
            for (int c = 0; c < m; ++c)
                v = cfma(res[c * M + r],
                         cconj(__ldg(wn + nn * c % N)), v);
            store_at(y + to * C + c0, two, vec2, v);
        }
        // the next job's first exchange synchronises before any thread
        // writes res again
    }
    }
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

// An arrival that orders nothing: for a barrier that only says this CTA
// has read other CTAs' shared memory (every value read has come back, so
// no later write can change it), it does not wait for the global stores
// in flight.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// A generic pointer to CTA `rank`'s copy of the shared variable at p.
__device__ __forceinline__ float2* remote_ptr(float2* p, int rank) {
    uint64_t r;
    asm volatile("mapa.u64 %0, %1, %2;"
                 : "=l"(r) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
    return reinterpret_cast<float2*>(r);
}

// An int the compiler cannot see through: values derived from it after
// the transform are computed there, not kept in registers across it.
__device__ __forceinline__ int opaque(int v) {
    asm volatile("" : "+r"(v));
    return v;
}

// The cluster route (see the note at the top): m = 1, M >= 8192 (G = 1).
// A cluster of 4 CTAs walks jobs J = (frame f, channel group q), groups
// fastest; rank k = blockIdx.x % 4 (a 1-D grid of 1-D clusters) owns pair
// 4q + k.  Per job: rank k loads rows [k M/4, (k + 1) M/4) of the frame,
// lane pairs on a row's 32 bytes, lane t 16 bytes (pairs 2 (t & 1), 2 (t
// & 1) + 1), and puts each pair into its owner's exchange buffer at the
// first pass's slot (row p at p + p / R); after a cluster barrier each
// thread reads its registers from its own buffer, transforms, and writes
// its outputs back in register order (row i T + t); after a second
// barrier rank k gathers output rows [k L/4, (k + 1) L/4) from the 4
// buffers and stores them as whole 32-byte segments.  A third barrier,
// waited on before the next job's staging, keeps each buffer until its
// readers are done.  Across the transform only J stays in registers.
template <int M>
__global__ void __launch_bounds__(Plan<M>::THREADS, Plan<M>::MINB)
osconv_kernel_cluster(const float* __restrict__ x,
                      const float2* __restrict__ Hp,
                      const float2* __restrict__ tw2,
                      float* __restrict__ y, long long n, int C, int L,
                      long long nout, int K) {
    using PL = Plan<M>;
    constexpr int R = PL::R, T = PL::T, THREADS = PL::THREADS;
    constexpr int QR = M / 4;                    // rows a rank stages
    constexpr int LOADS = 2 * QR / THREADS;      // 16-byte loads a thread
    static_assert(PL::G == 1 && 2 * QR % THREADS == 0, "G = 1 only");
    extern __shared__ __align__(16) float2 csmem[];
    float2* ex = csmem;                          // SLOT exchange slots
    const int jobs = C / 8 * K;        // < 2^31 (checked at the launch)

    cluster_arrive();   // no outputs of a previous job to wait for
    float2 a[R];
    for (int J = blockIdx.x / 4; J < jobs; J += gridDim.x / 4) {
        {
            const int t = threadIdx.x, rank = blockIdx.x & 3;
            const int f = J / (C / 8), q = J % (C / 8);
            // frame row p = rank QR + (u THREADS + t) / 2 is row g0 + (u
            // THREADS + t) / 2 of x
            const long long g0 = (long long)f * L - (M - L) + rank * QR;
            const float* px = x + g0 * C + 8 * q + 4 * (t & 1);
            float4 v[LOADS];
#pragma unroll
            for (int u = 0; u < LOADS; ++u) {
                const int pl = (u * THREADS + t) >> 1;
                const long long g = g0 + pl;
                v[u] = g >= 0 && g < n
                    ? __ldg(reinterpret_cast<const float4*>(
                          px + (long long)pl * C))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
            }
            float2* o0 = remote_ptr(ex, 2 * (t & 1));
            float2* o1 = remote_ptr(ex, 2 * (t & 1) + 1);
            cluster_wait();   // the cluster has read this CTA's last outputs
#pragma unroll
            for (int u = 0; u < LOADS; ++u) {
                const int p = rank * QR + ((u * THREADS + t) >> 1);
                o0[p + p / R] = make_float2(v[u].x, v[u].y);
                o1[p + p / R] = make_float2(v[u].z, v[u].w);
            }
        }
        cluster_arrive();
        cluster_wait();       // every pair of the frame is with its owner
        {
            const float2* own = ex + slot_base<M, 1>(threadIdx.x);
#pragma unroll
            for (int i = 0; i < R; ++i) a[i] = own[slot_off<M, 1>(i)];
        }
        convolve<M>(a, ex, threadIdx.x, 0, tw2, Hp);
        __syncthreads();      // every thread has left the last exchange
#pragma unroll
        for (int i = 0; i < R; ++i) ex[i * T + threadIdx.x] = a[i];
        cluster_arrive();
        cluster_wait();
        // rank k stores output rows [k L/4, (k + 1) L/4) of the frame: a
        // lane takes one row's half (pairs 2 hh, 2 hh + 1: channels 8q +
        // 4 hh .. + 3), 16 rows a warp, both halves of a row side by side
        {
            const int Jo = opaque(J);
            const int f = Jo / (C / 8), q = Jo % (C / 8);
            const int Lq = L / 4;
            const int hh = (threadIdx.x >> 4) & 1;
            const float2* lo = remote_ptr(ex, 2 * hh) + (M - L);
            const float2* hi = remote_ptr(ex, 2 * hh + 1) + (M - L);
            const int r0 = (blockIdx.x & 3) * Lq;
            float* py = y + ((long long)f * L + r0) * C + 8 * q + 4 * hh;
            const long long left = nout - (long long)f * L - r0;
            for (int j = threadIdx.x; j < 2 * Lq; j += THREADS) {
                const int row = (j >> 5) * 16 + (j & 15);
                if (row < left) {
                    const float2 u = lo[r0 + row], w = hi[r0 + row];
                    *reinterpret_cast<float4*>(py + (long long)row * C) =
                        make_float4(u.x, u.y, w.x, w.y);
                }
            }
        }
        cluster_arrive_relaxed();   // waited on before the next staging
    }
    cluster_wait();           // no CTA leaves while others read its memory
}

using KernelFn = void (*)(const float*, const float2*, const float2*,
                          const float2*, float*, long long, int, int, int,
                          long long, int);

template <int M, bool ODD>
int launch(const void* x, const void* Hp, const void* wn, const void* tw2,
           void* y, long long n, int C, int N, int L, long long nout,
           cudaStream_t st) {
    using PL = Plan<M>;
    const KernelFn kern = osconv_kernel<M, ODD>;
    const int K = (int)((nout + L - 1) / L);
    const long long jobs = (long long)((C + 1) / 2) * K;
    if (K <= 0 || jobs <= 0) return cudaSuccess;
    if (jobs > 0x7fffffff) return cudaErrorInvalidValue;
    const size_t smem = sizeof(float2) *
        ((size_t)PL::G * PL::SLOT + (ODD ? (size_t)N : 0));
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, occ = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &occ, kern, PL::THREADS, smem)) != cudaSuccess)
        return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    // one wave of blocks on every SM, each walking its jobs (m = 1: groups
    // of G jobs)
    const long long units = ODD ? jobs : (jobs + PL::G - 1) / PL::G;
    long long grid = (long long)sms * occ;
    if (grid > units) grid = units;
    kern<<<(unsigned)grid, PL::THREADS, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float2*>(Hp),
        static_cast<const float2*>(wn), static_cast<const float2*>(tw2),
        static_cast<float*>(y), n, C, N, L, nout, K);
    return cudaGetLastError();
}

// The cluster route: x and y 16-byte aligned, C % 8 == 0, every frame
// row and job number an int.
template <int M>
int launch_cluster(const void* x, const void* Hp, const void* tw2, void* y,
                   long long n, int C, int L, long long nout,
                   cudaStream_t st) {
    using PL = Plan<M>;
    const auto kern = osconv_kernel_cluster<M>;
    const long long K = (nout + L - 1) / L;
    const long long jobs = (long long)(C / 8) * K;
    if (K <= 0 || jobs <= 0) return cudaSuccess;
    if (C % 8 || ((uintptr_t)x & 15) || ((uintptr_t)y & 15) ||
        K * L + M > 0x7fffffff || jobs > 0x7fffffff)
        return cudaErrorInvalidValue;
    const size_t smem = sizeof(float2) * PL::SLOT;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 4;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(4);
    cfg.blockDim = dim3(PL::THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // one wave of clusters, each walking its jobs (the count cached by
    // device: it depends on nothing else)
    static int cached[64];
    int dev = 0, clusters = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if (dev < 64 && cached[dev] > 0) {
        clusters = cached[dev];
    } else {
        if ((err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg)) !=
            cudaSuccess)
            return err;
        if (clusters < 1) return cudaErrorInvalidConfiguration;
        if (dev < 64) cached[dev] = clusters;
    }
    cfg.gridDim = dim3(4 * (unsigned)(clusters < jobs ? clusters : jobs));
    err = cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(x),
                             static_cast<const float2*>(Hp),
                             static_cast<const float2*>(tw2),
                             static_cast<float*>(y), n, C, L, nout, (int)K);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// The kernel for M and odd = (m > 1): m = 1 takes M from 256 (nfft >= 256)
// to 16384, m >= 3 M up to 4096 (nfft <= 16384); cluster: m = 1 and M >=
// 8192 only.
template <int M>
int dispatch(bool odd, bool cluster, const void* x, const void* Hp,
             const void* wn, const void* tw2, void* y, long long n, int C,
             int N, int L, long long nout, cudaStream_t st) {
    if (cluster) {
        if constexpr (M >= 8192)
            if (!odd)
                return launch_cluster<M>(x, Hp, tw2, y, n, C, L, nout, st);
        return cudaErrorInvalidValue;
    }
    if (odd) {
        if constexpr (M <= 4096)
            return launch<M, true>(x, Hp, wn, tw2, y, n, C, N, L, nout, st);
        return cudaErrorInvalidValue;
    }
    if constexpr (M >= 256)
        return launch<M, false>(x, Hp, wn, tw2, y, n, C, N, L, nout, st);
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (n, C) float32; Hp: (N,) complex as float2, H / N in the kernel's
// slot order (kernels/osconv.py:_perm); wn: (N,) float2,
// exp(-2 pi i e / N); tw2: (M/2,) float2, exp(-2 pi i j / M); y:
// (nout, C).  N = nfft = m * M with m odd, M a power of two in
// [128, 16384]; L the block advance, a multiple of 128 with L <= N.
// cluster: take the cluster instance (kernels/osconv.py:cluster_route:
// m = 1, M >= 8192, C % 8 == 0, x and y 16-byte aligned); anything else
// there is refused.
int dsptpu_osconv(const void* x, const void* Hp, const void* wn,
                  const void* tw2, void* y, long long n, int C, int N, int M,
                  int L, long long nout, int cluster, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    if ((M & (M - 1)) || N % M || (N / M) % 2 == 0 || L <= 0 || L > N ||
        C <= 0 || N > 16384)
        return cudaErrorInvalidValue;
    const bool odd = N > M;
    const bool cl = cluster != 0;
    switch (M) {
        case 128:
            return dispatch<128>(odd, cl, x, Hp, wn, tw2, y, n, C, N, L, nout,
                                 st);
        case 256:
            return dispatch<256>(odd, cl, x, Hp, wn, tw2, y, n, C, N, L, nout,
                                 st);
        case 512:
            return dispatch<512>(odd, cl, x, Hp, wn, tw2, y, n, C, N, L, nout,
                                 st);
        case 1024:
            return dispatch<1024>(odd, cl, x, Hp, wn, tw2, y, n, C, N, L,
                                  nout, st);
        case 2048:
            return dispatch<2048>(odd, cl, x, Hp, wn, tw2, y, n, C, N, L,
                                  nout, st);
        case 4096:
            return dispatch<4096>(odd, cl, x, Hp, wn, tw2, y, n, C, N, L,
                                  nout, st);
        case 8192:
            return dispatch<8192>(odd, cl, x, Hp, wn, tw2, y, n, C, N, L,
                                  nout, st);
        case 16384:
            return dispatch<16384>(odd, cl, x, Hp, wn, tw2, y, n, C, N, L,
                                   nout, st);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // extern "C"

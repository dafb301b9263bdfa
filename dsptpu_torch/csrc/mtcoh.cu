// K9: all-pairs multitaper coherence from the tapered spectra.
//
// Replaces no TPU kernel: dsptpu leaves the coherence to a jnp.einsum
// and elementwise passes (dsptpu/ops/multitaper.py:403).  It is added
// because, at path D's shape, those passes were the largest loss of any
// measured stage: the port made the full (C, C, nbins) complex64
// cross-spectral matrix (268 MB at C 64, nbins 8193), then the diagonal,
// the outer product, sqrt, abs, the division and the where, each a pass
// over 134-268 MB, for an output of 134 MB.
//
// Input: the tapered one-sided spectra F (C, K, nbins) complex64, each
// (l, k) row's bins adjacent, rows at any strides (the FFT of a
// transposed signal lays the tapers outermost), the taper weights w (K,)
// (2/r, all positive) and the one-sided edge correction corr (nbins,)
// (positive).  For each bin f:
//     g_lk    = sqrt(w_k) corr_f F_lk
//     d_l     = sum_k |g_lk|^2
//     coh_lm  = |sum_k g_lk conj(g_mk)| / sqrt(d_l d_m)   (l != m)
//     coh_ll  = 1
// Output: (C, C, nbins) float32, each element written once.
//
// Bound on an H100: the bytes, F read once and the coherence written
// once, 8 C K nbins + 4 C^2 nbins: 163.6 MB at C 64, K 7, nbins 8193,
// 0.049 ms at 3.35 TB/s, against 0.018 ms of float32 operations (4 FMAs
// a taper a pair).  The kernel is bound by its writes, so the design
// keeps every other cost under them:
//   * a block takes kTB = 32 consecutive bins, one a lane.  Its threads
//     load g for every (l, k) row of the tile, coalesced along the bins
//     (256 bytes a row), fold sqrt(w_k) corr_f into the load, and scale
//     each channel's K values by 1/sqrt(d_l) as they go into shared
//     memory (C K 32 float2: 114,688 bytes at C 64, K 7; one block of 16
//     warps an SM).  With h_lk = g_lk / sqrt(d_l), coh_lm =
//     |sum_k h_lk conj(h_mk)|: the division leaves the pair loop;
//   * the pairs l < m are cut into groups of R channels l.  A warp keeps
//     a group's R x K values in registers and walks the partner channels
//     m out of shared memory (conflict-free: a lane reads its own bin),
//     4 FMAs a taper a pair, R pairs a load of h_m.  The (group, m)
//     iterations, sum over groups of C - R G - 1, are split evenly over
//     the block's warps;
//   * each pair is stored twice, to (l, m, f) and (m, l, f), and the
//     lanes run along the bins, so each store is a 128-byte run.  Rows
//     of nbins floats are not 16-byte aligned (8193 is odd), so the
//     stores are 4-byte, coalesced across the lanes; the diagonal's 1s
//     are stored by the same warps;
//   * the last tile (8193 = 256 * 32 + 1) masks its empty lanes: they
//     load 0 and store nothing.
// What is left above the bound is the stores' alignment: a row starts
// r floats past a 128-byte line, so most runs share their end lines with
// the neighbouring blocks' runs.  At the cell's shape the kernel takes
// 0.106-0.112 ms, its stores alone (no pair sums) 0.109-0.113 and its
// pair sums alone (no stores) 0.062; into rows padded to whole lines it
// takes 0.083 (tools/probes/k9_variants.py).  Blocks 24 bins apart that
// each store only whole 32-byte sectors (32 bins computed, 24 stored)
// took 0.144: the stores no faster (0.109), the pair sums 4/3 as many.
// The sums are float32 FMAs (no TF32, no lower precision); the square
// roots and 1/sqrt(d_l) are IEEE.  A channel with d_l = 0 gives NaN off
// the diagonal, as the plain version's 0/0.  Register arrays are indexed
// by compile-time constants only (the taper loops unrolled to KMAX and
// guarded by k < K), so nothing goes to a stack frame.  Two instances:
// KMAX 8 with R 4 (K <= 8, the cell's 7), KMAX 16 with R 2 (K 9-16).

#include <cuda_runtime.h>

namespace {

constexpr int kTB = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTapers = 16;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's opt-in maximum

template <int KMAX, int R>
__global__ void __launch_bounds__(kThreads, 1)
mtcoh_kernel(const float2* __restrict__ F, long long sc, long long sk,
             const float* __restrict__ w, const float* __restrict__ corr,
             float* __restrict__ out, int C, int K, int nb) {
    extern __shared__ float2 h[];  // row (l, k) at (l K + k) kTB
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int f = blockIdx.x * kTB + lane;
    const bool live = f < nb;
    const long long nbl = nb;

    // g = sqrt(w_k) corr_f F_lk, then h = g / sqrt(d_l), one channel a
    // warp at a time; the diagonal's 1s
    float scale[KMAX];
    const float cf = live ? corr[f] : 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
        scale[k] = k < K ? sqrtf(w[k]) * cf : 0.f;
#pragma unroll 2
    for (int l = warp; l < C; l += kWarps) {
        float2 v[KMAX];
        float d = 0.f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
            v[k] = make_float2(0.f, 0.f);
            if (k < K && live) v[k] = F[l * sc + k * sk + f];
        }
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
            v[k].x *= scale[k];
            v[k].y *= scale[k];
            d = fmaf(v[k].x, v[k].x, fmaf(v[k].y, v[k].y, d));
        }
        const float s = 1.f / sqrtf(d);
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
            if (k < K)
                h[(l * K + k) * kTB + lane] =
                    make_float2(v[k].x * s, v[k].y * s);
        if (live) out[((long long)l * C + l) * nbl + f] = 1.f;
    }
    __syncthreads();

    // this warp's share of the (group, m) iterations
    int total = 0;
    for (int lo = 0; lo < C; lo += R) total += C - lo - 1;
    int it = (int)((long long)total * warp / kWarps);
    const int end = (int)((long long)total * (warp + 1) / kWarps);
    if (it >= end) return;
    int lo = 0, m = it;
    while (m >= C - lo - 1) {
        m -= C - lo - 1;
        lo += R;
    }
    m += lo + 1;

    float2 hl[R][KMAX];
    int held = -1;
    for (; it < end; ++it, ++m) {
        while (m >= C) {
            lo += R;
            m = lo + 1;
        }
        if (lo != held) {
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
                for (int k = 0; k < KMAX; ++k)
                    hl[r][k] = k < K && lo + r < C
                                   ? h[((lo + r) * K + k) * kTB + lane]
                                   : make_float2(0.f, 0.f);
            held = lo;
        }
        float2 hm[KMAX];
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
            hm[k] = k < K ? h[(m * K + k) * kTB + lane]
                          : make_float2(0.f, 0.f);
        float re[R], im[R];
#pragma unroll
        for (int r = 0; r < R; ++r) re[r] = im[r] = 0.f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
            if (k < K) {
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    re[r] = fmaf(hl[r][k].x, hm[k].x,
                                 fmaf(hl[r][k].y, hm[k].y, re[r]));
                    im[r] = fmaf(hl[r][k].y, hm[k].x,
                                 fmaf(-hl[r][k].x, hm[k].y, im[r]));
                }
            }
        }
        if (!live) continue;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int l = lo + r;
            if (l < m) {
                const float c = sqrtf(fmaf(re[r], re[r], im[r] * im[r]));
                out[((long long)l * C + m) * nbl + f] = c;
                out[((long long)m * C + l) * nbl + f] = c;
            }
        }
    }
}

template <int KMAX, int R>
cudaError_t launch(const float2* F, long long sc, long long sk,
                   const float* w, const float* corr, float* out, int C,
                   int K, int nb, cudaStream_t st) {
    const size_t smem = sizeof(float2) * (size_t)C * K * kTB;
    cudaError_t err = cudaFuncSetAttribute(
        mtcoh_kernel<KMAX, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    mtcoh_kernel<KMAX, R><<<(nb + kTB - 1) / kTB, kThreads, smem, st>>>(
        F, sc, sk, w, corr, out, C, K, nb);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// F: (C, K, nb) complex64 as interleaved float pairs, row (l, k) at
// F + l sc + k sk (in complex elements), its bins adjacent; w: (K,)
// float32; corr: (nb,) float32; out: (C, C, nb) float32.  1 <= K <= 16,
// C >= 1, nb >= 1, C K 32 float2 within a block's shared memory
// (C K <= 908).
int dsptpu_mtcoh(const void* F, long long sc, long long sk, const void* w,
                 const void* corr, void* out, int C, int K, int nb,
                 void* stream) {
    if (C < 1 || K < 1 || K > kMaxTapers || nb < 1 || sc < 0 || sk < 0 ||
        sizeof(float2) * (size_t)C * K * kTB > kMaxSmem)
        return cudaErrorInvalidValue;
    const auto* f = static_cast<const float2*>(F);
    const auto* wp = static_cast<const float*>(w);
    const auto* cp = static_cast<const float*>(corr);
    auto* o = static_cast<float*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if (K <= 8) return launch<8, 4>(f, sc, sk, wp, cp, o, C, K, nb, st);
    return launch<16, 2>(f, sc, sk, wp, cp, o, C, K, nb, st);
}

}  // extern "C"

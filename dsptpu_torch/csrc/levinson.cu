// K5: Levinson-Durbin recursion over a batch of channels.
//
// Replaces dsptpu/kernels/levinson.py:levinson_pallas (Pallas `_kernel`,
// :51).  For each channel c, from the autocorrelation lags R[0..p]:
//     k_1 = -R1 / R0,  err = R0 (1 - k_1^2),  a = [k_1]
//     for m = 2..p:
//         acc = R[m] + sum_{i=1}^{m-1} R[i] a[m-1-i]
//         k   = -acc / err
//         a[i] += k a[m-2-i] (i < m-1, all from the old a),  a[m-1] = k
//         err *= 1 - k^2
// The TPU kernel keeps a reversed copy ar of a beside it because Mosaic
// cannot reverse sublanes; here a thread updates a[i] and a[m-2-i] as a
// pair, which is the same arithmetic.
//
// One thread per channel.  The recursion is a chain of p orders, each
// waiting on the last, so at path B's shape (p 16, 2500 channels: 79
// warps on 132 SMs) the kernel is bound by latency, not by its bytes.
// The design keeps that chain short:
//   * the order is a compile-time value: one instance per order class
//     P in {8, 16, 32, 64} runs every p in (P/2, P] (2..8 for P = 8), its
//     orders unrolled by template recursion and left at the runtime p.
//     Every index into r and a is then a constant, so both live in
//     registers (at P = 64, 65 + 64 floats), with no stack frame.  The
//     launch bounds ask for one block of 128 an SM, which leaves each
//     thread up to 255 registers: without that minimum ptxas held the
//     P = 32 instance to 96 registers and spilled 16 bytes;
//   * the order-m dot runs on kAcc independent accumulators (term i in
//     accumulator i % kAcc), summed as a tree, and the pair updates are
//     independent of each other;
//   * k = -acc / err is IEEE division (no fast-math), so a zero or
//     non-finite column gives the plain version's NaN/Inf pattern.
// R (row stride ldr) and the outputs are lag-major, so a warp's reads
// and writes of one lag are coalesced across its 32 channels.  The
// outputs share one (2p+1, C) buffer: a in rows 0..p-1, refl in rows
// p..2p-1, err in row 2p.
//
// Bounds on an H100: bytes, 4 (3p + 2) C (R read once, a, refl, err
// written once), 0.0001 ms at p 16, C 2500; latency, one DRAM round
// trip and then, order by order, the dot's depth in FMA latencies and
// an IEEE division, about 0.0009 ms there (PERF.md, K5's row).  No block
// of 32-256 threads nor 1-8 accumulators ran faster than 128 and 4 past
// the spread between runs (tools/probes/k5_variants.py).  Several lanes
// a channel would need r and a indexed by lane, that is, out of
// registers or behind selects, for a dot only 4 multiply-adds deep.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAcc = 4;
constexpr int kMaxP = 64;

// acc = r[M] + sum_{i=1}^{M-1} r[i] a[M-1-i], term i in accumulator
// i % kAcc, the accumulators summed as a tree
template <int P, int M>
__device__ __forceinline__ float order_dot(const float (&r)[P + 1],
                                           const float (&a)[P]) {
    float s[kAcc];
    s[0] = r[M];
#pragma unroll
    for (int j = 1; j < kAcc; ++j) s[j] = 0.f;
#pragma unroll
    for (int i = 1; i < M; ++i)
        s[i % kAcc] = fmaf(r[i], a[M - 1 - i], s[i % kAcc]);
#pragma unroll
    for (int w = kAcc / 2; w > 0; w /= 2)
#pragma unroll
        for (int j = 0; j < w; ++j) s[j] += s[j + w];
    return s[0];
}

// orders M..p of the recursion; refl points at this channel's row 0 of
// refl, rows C apart
template <int P, int M>
__device__ __forceinline__ void orders(const float (&r)[P + 1],
                                       float (&a)[P], float& err,
                                       float* refl, long long C, int p) {
    if constexpr (M <= P) {
        if (M > p) return;
        const float k = -order_dot<P, M>(r, a) / err;
#pragma unroll
        for (int i = 0; i < (M - 1) / 2; ++i) {
            const float lo = a[i], hi = a[M - 2 - i];
            a[i] = fmaf(k, hi, lo);
            a[M - 2 - i] = fmaf(k, lo, hi);
        }
        if constexpr ((M - 1) % 2 == 1)
            a[(M - 2) / 2] = fmaf(k, a[(M - 2) / 2], a[(M - 2) / 2]);
        a[M - 1] = k;
        refl[(M - 1) * C] = k;
        err *= 1.f - k * k;
        orders<P, M + 1>(r, a, err, refl, C, p);
    }
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1)
levinson_kernel(const float* __restrict__ R, long long ldr,
                float* __restrict__ out, int p, int C) {
    const int c = blockIdx.x * kThreads + threadIdx.x;
    if (c >= C) return;
    float r[P + 1];
    float a[P];
#pragma unroll
    for (int l = 0; l <= P; ++l) r[l] = l <= p ? R[l * ldr + c] : 0.f;
    float* refl = out + (long long)p * C + c;
    const float k = -r[1] / r[0];
    float err = r[0] * (1.f - k * k);
    a[0] = k;
    refl[0] = k;
    orders<P, 2>(r, a, err, refl, C, p);
#pragma unroll
    for (int i = 0; i < P; ++i)
        if (i < p) out[(long long)i * C + c] = a[i];
    out[2LL * p * C + c] = err;
}

template <int P>
void launch(const float* R, long long ldr, float* out, int p, int C,
            cudaStream_t st) {
    levinson_kernel<P><<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        R, ldr, out, p, C);
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// R: p+1 rows of C float32, row l at R + l * ldr; out: (2p+1, C) float32,
// a in rows 0..p-1, refl in rows p..2p-1, err in row 2p.  2 <= p <= 64.
int dsptpu_levinson(const void* R, long long ldr, void* out, int p, int C,
                    void* stream) {
    if (p < 2 || p > kMaxP || C <= 0 || ldr < C) return cudaErrorInvalidValue;
    const auto* r = static_cast<const float*>(R);
    auto* o = static_cast<float*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if (p <= 8) launch<8>(r, ldr, o, p, C, st);
    else if (p <= 16) launch<16>(r, ldr, o, p, C, st);
    else if (p <= 32) launch<32>(r, ldr, o, p, C, st);
    else launch<64>(r, ldr, o, p, C, st);
    return cudaGetLastError();
}

}  // extern "C"

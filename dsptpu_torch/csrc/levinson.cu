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
// pair in place, which is the same arithmetic.  One thread per channel,
// R and a in local arrays (at most 65 + 64 floats).  R (p+1, C), a and
// refl (p, C) are lag-major, so a warp's reads and writes of one lag are
// coalesced across its 32 channels.
//
// Bound on an H100: the bytes of R, a, err and refl; at p = 16 and
// C = 2500 that is about 0.35 MB, a tenth of a microsecond at 3.35 TB/s,
// under the launch's own cost.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxP = 64;

__global__ void __launch_bounds__(kThreads)
levinson_kernel(const float* __restrict__ R, float* __restrict__ a_out,
                float* __restrict__ err_out, float* __restrict__ refl_out,
                int p, int C) {
    const int c = blockIdx.x * kThreads + threadIdx.x;
    if (c >= C) return;
    float r[kMaxP + 1];
    float a[kMaxP];
    for (int l = 0; l <= p; ++l) r[l] = R[(long long)l * C + c];
    float k = -r[1] / r[0];
    float err = r[0] * (1.f - k * k);
    a[0] = k;
    refl_out[c] = k;
    for (int m = 2; m <= p; ++m) {
        float acc = r[m];
        for (int i = 1; i < m; ++i) acc = fmaf(r[i], a[m - 1 - i], acc);
        k = -acc / err;
        for (int i = 0, j = m - 2; i <= j; ++i, --j) {
            const float lo = a[i], hi = a[j];
            a[i] = fmaf(k, hi, lo);
            if (i != j) a[j] = fmaf(k, lo, hi);
        }
        a[m - 1] = k;
        refl_out[(long long)(m - 1) * C + c] = k;
        err *= 1.f - k * k;
    }
    for (int i = 0; i < p; ++i) a_out[(long long)i * C + c] = a[i];
    err_out[c] = err;
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// R: (p+1, C) float32; a, refl: (p, C); err: (C,).  2 <= p <= 64.
int dsptpu_levinson(const void* R, void* a, void* err, void* refl, int p,
                    int C, void* stream) {
    if (p < 2 || p > kMaxP || C <= 0) return cudaErrorInvalidValue;
    levinson_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(R), static_cast<float*>(a),
        static_cast<float*>(err), static_cast<float*>(refl), p, C);
    return cudaGetLastError();
}

}  // extern "C"

// K2: block state-space pass of an LTI system (an SOS cascade stacked
// into one state of dimension p <= 32), y_t = d x_t + w'z_{t-1},
// z_t = A z_{t-1} + c x_t, over a time-major (n, C) float32 signal.
//
// Replaces dsptpu/kernels/biir.py:blockss_filt_pallas (Pallas `_kernel`,
// :60) in all its modes: forward, need_state, reverse and n_eff.  With
// V = 128-sample rows X_b:
//     U_b      = K X_b                   (row input -> state increment)
//     z_b      = AV z_{b-1} + U_b        (AV = A^128; z_{-1} = z0)
//     Y_b      = F X_b + G z_{b-1}       (F lower-triangular Toeplitz of
//                                         the impulse response h)
// The TPU kernel carries z across a sequential grid.  Blocks here run in
// no order, so the carry becomes a chunked scan over the rows:
//   1. inject:   U for every (row, channel), in parallel;
//   2. scan:     per (chunk of L rows, channel), the chunk's end state
//                from a zero start;
//   3. carry:    per channel, a short sequential pass over the chunk
//                ends with AV^L: the state entering each chunk;
//   4. scan:     per (chunk, channel) again from the true entering
//                state, writing z_{b-1} over U_b in place (and the state
//                after row `brow` when the caller needs it);
//   5. output:   Y = F X + G z_{b-1}, a 128-tap FIR truncated at each
//                row start plus the state term; or, for a stacked SOS
//                cascade (the wrapper passes its sections), the cascade
//                itself run per (row, channel) from z_{b-1}, whose rows
//                2k, 2k+1 are section k's DF2T state (s1, s2):
//                  y_k = b0 u + s1;  s1 <- s2 + b1 u - a1 y_k;
//                  s2 <- b2 u - a2 y_k;  u <- y_k;  output g u,
//                5 multiply-adds per section per sample against F's ~64
//                plus G's p (20 against 72 at 4 sections).
// All tables are built in float64 on the host and cast to float32.
//
// Reverse (the anti-causal pass rev(apply(rev(x))), z0 entering after the
// last sample; filtfilt's second pass): the kernels run over virtual time
// t' = 0..n-1 and read and write sample tbase - t' (tbase = n - 1, or
// n_eff - 1 when only the first n_eff samples are processed).  The rows
// are then those of dsptpu's reverse pass (aligned to the last processed
// sample, the ragged part processed last), the scans run right to left in
// real time, and the carry pass walks the chunk ends from the last to the
// first.  Reading a row in reverse order with the forward tables is the
// same product as reading it in order with dsptpu's mirrored tables
// (F', K's columns and G's rows reversed: _dev_tables(reverse=True)), so
// no table and no copy of the data is flipped.
//
// Bound on an H100: 8 bytes of HBM traffic per sample.  The cascade
// needs 5 multiply-adds per section per sample; the block form's step 5
// spends ~64 for F (triangular) and p for G, whose time on the CUDA
// cores about equals the bytes' (the SOS stage's cascade does not).  x is
// read twice (steps 1 and 5); the scan moves only p floats per row.  The
// F stage uses the register-window scheme of fir.cu; the SOS stage reads
// x once per (row, channel), a warp's lanes on neighbouring channels.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Memory row of virtual sample t: t itself, or tbase - t in reverse.
__device__ __forceinline__ long long row_of(long long t, long long tbase) {
    return tbase < 0 ? t : tbase - t;
}
constexpr int V = 128;
constexpr int R = 16;

__device__ __forceinline__ int skew(int row, int cw) {
    return cw < 32 ? row + (row >> 4) : row;
}

// U[b][a][c] = sum_u Kt[u][a] x[b*V + u][c]; one thread per (row, c).
template <int P>
__global__ void __launch_bounds__(kThreads)
inject_kernel(const float* __restrict__ x, const float* __restrict__ kt,
              float* __restrict__ U, long long n, long long tbase, int C,
              int B, int cw) {
    __shared__ float ks[V * P];
    for (int i = threadIdx.x; i < V * P; i += kThreads) ks[i] = kt[i];
    __syncthreads();
    const int cl = threadIdx.x & (cw - 1);
    const int rl = threadIdx.x / cw;
    const long long b = (long long)blockIdx.x * (kThreads / cw) + rl;
    const int c = blockIdx.y * cw + cl;
    if (b >= B || c >= C) return;
    float acc[P];
#pragma unroll
    for (int a = 0; a < P; ++a) acc[a] = 0.f;
    const long long t0 = b * V;
    for (int u = 0; u < V; ++u) {
        const long long t = t0 + u;
        const float xv = t < n ? x[row_of(t, tbase) * C + c] : 0.f;
#pragma unroll
        for (int a = 0; a < P; ++a) acc[a] = fmaf(ks[u * P + a], xv, acc[a]);
    }
#pragma unroll
    for (int a = 0; a < P; ++a) U[(b * P + a) * C + c] = acc[a];
}

// One thread per (chunk j, channel c) over rows [j*L, min(j*L+L, B)).
// zin == nullptr: end state of the chunk from a zero start -> E[j].
// else: start from zin[j], write the entering state over U in place and,
// for row `brow`, the state after it -> zrow.
template <int P>
__global__ void __launch_bounds__(kThreads)
scan_kernel(float* __restrict__ U, const float* __restrict__ av,
            const float* __restrict__ zin, float* __restrict__ E,
            float* __restrict__ zrow, int C, int B, int L, int nchunks,
            int brow) {
    __shared__ float as[P * P];
    for (int i = threadIdx.x; i < P * P; i += kThreads) as[i] = av[i];
    __syncthreads();
    const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (idx >= (long long)nchunks * C) return;
    const int c = (int)(idx % C);
    const int j = (int)(idx / C);
    float z[P];
#pragma unroll
    for (int a = 0; a < P; ++a)
        z[a] = zin ? zin[((long long)j * P + a) * C + c] : 0.f;
    const int b1 = min(B, (j + 1) * L);
    for (int b = j * L; b < b1; ++b) {
        float* u = U + (long long)b * P * C + c;
        float zn[P];
#pragma unroll
        for (int a = 0; a < P; ++a) {
            float s = u[(long long)a * C];
#pragma unroll
            for (int q = 0; q < P; ++q) s = fmaf(as[a * P + q], z[q], s);
            zn[a] = s;
        }
        if (zin) {
#pragma unroll
            for (int a = 0; a < P; ++a) u[(long long)a * C] = z[a];
            if (b == brow) {
#pragma unroll
                for (int a = 0; a < P; ++a) zrow[(long long)a * C + c] = zn[a];
            }
        }
#pragma unroll
        for (int a = 0; a < P; ++a) z[a] = zn[a];
    }
    if (!zin) {
#pragma unroll
        for (int a = 0; a < P; ++a) E[((long long)j * P + a) * C + c] = z[a];
    }
}

// Per channel: S_{-1} = z0, zin[j] = S_{j-1}, S_j = AV^L S_{j-1} + E[j].
template <int P>
__global__ void carry_kernel(const float* __restrict__ E,
                             const float* __restrict__ avl,
                             const float* __restrict__ z0,
                             float* __restrict__ zin, int C, int nchunks) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    float s[P];
#pragma unroll
    for (int a = 0; a < P; ++a) s[a] = z0[a * C + c];
    for (int j = 0; j < nchunks; ++j) {
        float sn[P];
#pragma unroll
        for (int a = 0; a < P; ++a) {
            zin[((long long)j * P + a) * C + c] = s[a];
            float v = E[((long long)j * P + a) * C + c];
#pragma unroll
            for (int q = 0; q < P; ++q) v = fmaf(avl[a * P + q], s[q], v);
            sn[a] = v;
        }
#pragma unroll
        for (int a = 0; a < P; ++a) s[a] = sn[a];
    }
}

// Y[b*V + v][c] = sum_{u<=v} h[v-u] x[b*V + u][c] + sum_a G[v][a] Z[b][a][c]
template <int P>
__global__ void __launch_bounds__(kThreads)
output_kernel(const float* __restrict__ x, const float* __restrict__ h,
              const float* __restrict__ gt, const float* __restrict__ Z,
              float* __restrict__ y, long long n, long long tbase, int C,
              int B, int cw, int rb) {
    extern __shared__ float smem[];
    const int tt = rb * V;
    float* hs = smem;                      // V
    float* gs = hs + V;                    // V x P
    float* zs = gs + V * P;                // rb x P x cw
    float* xs = zs + rb * P * cw;          // tt skewed rows x cw
    const int tid = threadIdx.x;
    const int cl = tid & (cw - 1);
    const int tl = tid / cw;
    const int tlanes = kThreads / cw;
    const long long b0 = (long long)blockIdx.x * rb;
    const long long t0 = b0 * V;
    const int cbase = blockIdx.y * cw;

    for (int i = tid; i < V; i += kThreads) hs[i] = h[i];
    for (int i = tid; i < V * P; i += kThreads) gs[i] = gt[i];
    for (int e = tid; e < rb * P * cw; e += kThreads) {
        const int l = e & (cw - 1);
        const int ra = e / cw;             // r * P + a
        const long long b = b0 + ra / P;
        const int c = cbase + l;
        zs[e] = (b < B && c < C) ? Z[(b * P + ra % P) * C + c] : 0.f;
    }
    for (int e = tid; e < tt * cw; e += kThreads) {
        const int r = e / cw, l = e & (cw - 1);
        const long long t = t0 + r;
        const int c = cbase + l;
        xs[skew(r, cw) * cw + l] =
            (t < n && c < C) ? x[row_of(t, tbase) * C + c] : 0.f;
    }
    __syncthreads();

    const int c = cbase + cl;
    for (int lt0 = tl * R; lt0 < tt; lt0 += tlanes * R) {
        const int r = lt0 / V;
        const int v0 = lt0 % V;
        float acc[R];
        float zr[P];
#pragma unroll
        for (int a = 0; a < P; ++a) zr[a] = zs[(r * P + a) * cw + cl];
#pragma unroll
        for (int j = 0; j < R; ++j) {
            float s = 0.f;
#pragma unroll
            for (int a = 0; a < P; ++a)
                s = fmaf(gs[(v0 + j) * P + a], zr[a], s);
            acc[j] = s;
        }
        for (int k0 = 0; k0 <= v0; k0 += R) {
            // w[i] = x at in-row index v0 - k0 - (R-1) + i, zero before
            // the row start (F is lower-triangular)
            const int base = v0 - k0 - (R - 1);
            float w[2 * R - 1];
#pragma unroll
            for (int i = 0; i < 2 * R - 1; ++i)
                w[i] = base + i >= 0
                           ? xs[skew(r * V + base + i, cw) * cw + cl] : 0.f;
#pragma unroll
            for (int kk = 0; kk < R; ++kk) {
                const float hk = hs[k0 + kk];
#pragma unroll
                for (int j = 0; j < R; ++j)
                    acc[j] = fmaf(hk, w[j - kk + R - 1], acc[j]);
            }
        }
        if (c < C) {
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const long long t = t0 + lt0 + j;
                if (t < n) y[row_of(t, tbase) * C + c] = acc[j];
            }
        }
    }
}

// The SOS output stage: Y for a stacked cascade of nsec <= P/2 sections,
// sec = (b0, b1, b2, a1, a2) per section, then the gain g; one thread per
// (row b, channel c) from the entering state Z[b].
template <int P>
__global__ void __launch_bounds__(kThreads)
sos_output_kernel(const float* __restrict__ x, const float* __restrict__ sec,
                  const float* __restrict__ Z, float* __restrict__ y,
                  long long n, long long tbase, int C, int B, int nsec,
                  int cw) {
    constexpr int NS = P / 2;
    constexpr int U = 16;                  // samples loaded ahead
    __shared__ float cs[5 * NS + 1];
    for (int i = threadIdx.x; i <= 5 * nsec; i += kThreads) cs[i] = sec[i];
    __syncthreads();
    const int cl = threadIdx.x & (cw - 1);
    const int rl = threadIdx.x / cw;
    const long long b = (long long)blockIdx.x * (kThreads / cw) + rl;
    const int c = blockIdx.y * cw + cl;
    if (b >= B || c >= C) return;
    float s1[NS], s2[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
        s1[k] = k < nsec ? Z[(b * P + 2 * k) * C + c] : 0.f;
        s2[k] = k < nsec ? Z[(b * P + 2 * k + 1) * C + c] : 0.f;
    }
    const float g = cs[5 * nsec];
    const long long t0 = b * V;
    const int len = n - t0 < V ? (int)(n - t0) : V;
    for (int v0 = 0; v0 < len; v0 += U) {
        float u[U];
#pragma unroll
        for (int i = 0; i < U; ++i)
            u[i] = v0 + i < len ? x[row_of(t0 + v0 + i, tbase) * C + c] : 0.f;
#pragma unroll
        for (int i = 0; i < U; ++i) {
            float w = u[i];
#pragma unroll
            for (int k = 0; k < NS; ++k) {
                if (k < nsec) {
                    const float* q = cs + 5 * k;
                    const float yk = fmaf(q[0], w, s1[k]);
                    s1[k] = fmaf(q[1], w, fmaf(-q[3], yk, s2[k]));
                    s2[k] = fmaf(q[2], w, -q[4] * yk);
                    w = yk;
                }
            }
            u[i] = g * w;
        }
#pragma unroll
        for (int i = 0; i < U; ++i)
            if (v0 + i < len) y[row_of(t0 + v0 + i, tbase) * C + c] = u[i];
    }
}

template <int P>
int run(const float* x, const float* h, const float* kt, const float* gt,
        const float* av, const float* avl, const float* z0, float* y,
        float* U, float* E, float* zin, float* zrow, long long n,
        long long tbase, int C, int L, int brow, const float* sec, int nsec,
        cudaStream_t st) {
    const int B = (int)((n + V - 1) / V);
    const int nchunks = (B + L - 1) / L;
    int cw = 1;
    while (cw < C && cw < 32) cw *= 2;
    const int cgroups = (C + cw - 1) / cw;
    const int rows_per_block = kThreads / cw;
    inject_kernel<P><<<dim3((B + rows_per_block - 1) / rows_per_block,
                            cgroups), kThreads, 0, st>>>(x, kt, U, n, tbase,
                                                          C, B, cw);
    const long long items = (long long)nchunks * C;
    const unsigned sblocks = (unsigned)((items + kThreads - 1) / kThreads);
    scan_kernel<P><<<sblocks, kThreads, 0, st>>>(U, av, nullptr, E, nullptr,
                                                 C, B, L, nchunks, -1);
    carry_kernel<P><<<(C + 63) / 64, 64, 0, st>>>(E, avl, z0, zin, C,
                                                  nchunks);
    scan_kernel<P><<<sblocks, kThreads, 0, st>>>(U, av, zin, E, zrow, C, B,
                                                 L, nchunks, brow);
    if (nsec > 0) {
        if (nsec > P / 2) return cudaErrorInvalidValue;
        sos_output_kernel<P><<<dim3((B + rows_per_block - 1) / rows_per_block,
                                    cgroups), kThreads, 0, st>>>(
            x, sec, U, y, n, tbase, C, B, nsec, cw);
        return cudaGetLastError();
    }
    int tt = (kThreads / cw) * R;
    if (tt < 512) tt = 512;
    const int rb = tt / V;
    const int rows = tt + tt / 16 + 1;
    const size_t smem =
        sizeof(float) * (V + V * P + (size_t)rb * P * cw + (size_t)rows * cw);
    cudaError_t err = cudaFuncSetAttribute(
        output_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    output_kernel<P><<<dim3((B + rb - 1) / rb, cgroups), kThreads, smem,
                       st>>>(x, h, gt, U, y, n, tbase, C, B, cw, rb);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, y: (n, C) forward (tbase = -1); in reverse the pass covers the
// samples tbase, tbase - 1, ..., tbase - n + 1 of x and y.  h: (V,);
// kt, gt: (V, P); av, avl: (P, P); z0: (P, C); scratch U: (B, P, C);
// E, zin: (nchunks, P, C); zrow: (P, C) or null (with brow = -1).  P is
// 8, 16 or 32 (tables zero-padded).  nsec > 0: the system is a stacked
// cascade of nsec sections, sec (5 nsec + 1,) their (b0, b1, b2, a1, a2)
// and the gain, and the SOS stage replaces the F stage (h unused).
int dsptpu_biir(const void* x, const void* h, const void* kt, const void* gt,
                const void* av, const void* avl, const void* z0, void* y,
                void* U, void* E, void* zin, void* zrow, long long n,
                long long tbase, int C, int P, int L, int brow,
                const void* sec, int nsec, void* stream) {
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    auto m = [](void* p) { return static_cast<float*>(p); };
    auto st = static_cast<cudaStream_t>(stream);
    switch (P) {
        case 8:
            return run<8>(f(x), f(h), f(kt), f(gt), f(av), f(avl), f(z0),
                          m(y), m(U), m(E), m(zin), m(zrow), n, tbase, C, L,
                          brow, f(sec), nsec, st);
        case 16:
            return run<16>(f(x), f(h), f(kt), f(gt), f(av), f(avl), f(z0),
                           m(y), m(U), m(E), m(zin), m(zrow), n, tbase, C, L,
                           brow, f(sec), nsec, st);
        case 32:
            return run<32>(f(x), f(h), f(kt), f(gt), f(av), f(avl), f(z0),
                           m(y), m(U), m(E), m(zin), m(zrow), n, tbase, C, L,
                           brow, f(sec), nsec, st);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // extern "C"

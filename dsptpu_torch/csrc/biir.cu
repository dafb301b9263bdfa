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
// no order, so the carry becomes a reduce-then-scan over chunks of L
// rows, three launches a pass on SOS routes:
//   1. chunk_reduce: per (chunk j, channel group), U_b for the chunk's
//      rows from x staged on chip (written once), and the chunk's end
//      state from a zero start, E_j = sum_r AV^{L-1-r} U_r, folded row
//      by row in the block;
//   2. carry:        per channel, S_j = AV^L S_{j-1} + E_j (S_{-1} = z0):
//      the state entering each chunk, zin[j] = S_{j-1}.  The 123 chunk
//      ends of a 1,000,000-sample pass (L = 64) are cut into NG groups
//      of GL; each group's end state from zero runs in parallel, the
//      states entering the groups follow in series with (AV^L)^GL, then
//      each group again from its entering state: a serial depth of about
//      2 GL + NG steps instead of 123, the E of the next steps loaded
//      while these run;
//   3. chunk_scan_sos_output: per (chunk, channel group), the chunk's U
//      in shared memory, walked from zin[j] to each row's entering state
//      z_{b-1} (kept on chip; the state after row `brow` goes to zrow),
//      then the cascade itself per (row, channel) from z_{b-1}, whose
//      rows 2k, 2k+1 are section k's DF2T state (s1, s2):
//        y_k = b0 u + s1;  s1 <- s2 + b1 u - a1 y_k;
//        s2 <- b2 u - a2 y_k;  u <- y_k;  output g u,
//      5 multiply-adds per section per sample, the coefficients of up to
//      4 sections in registers (read from shared memory each sample they
//      cost about a shared load a multiply-add: on an H100 at 1,000,000 x
//      64 this stage took 0.33 ms that way, 0.23 ms with them in
//      registers).
// A general (b, a) system (no sections) takes steps 1 and 2, then a scan
// from zin[j] that writes z_{b-1} over U_b, and Y = F X + G z_{b-1} (a
// 128-tap FIR truncated at each row start plus the state term; the
// register-window scheme of fir.cu).  Every fold runs its rows in a
// fixed order, so results repeat bit for bit.  All tables are built in
// float64 on the host and cast to float32.
//
// Steps 1 and 3 read x in tiles of RG rows x TS samples x cw channels
// (16 samples a thread), 16-byte cp.async pieces where C % 4 == 0, a
// ring of kStages tiles in shared memory (two in flight, one barrier a
// tile), rows padded so that a warp's reads hit 32 banks; the copies'
// offsets come from shifts (all sizes powers of two), not divisions.
//
// Reverse (the anti-causal pass rev(apply(rev(x))), z0 entering after the
// last sample; filtfilt's second pass): the kernels run over virtual time
// t' = 0..n-1 and read and write sample tbase - t' (tbase = n - 1, or
// n_eff - 1 when only the first n_eff samples are processed).  The rows
// are then those of dsptpu's reverse pass (aligned to the last processed
// sample, the ragged part processed last), the scans run right to left in
// real time, and the carry walks the chunk ends from the last to the
// first.  Reading a row in reverse order with the forward tables is the
// same product as reading it in order with dsptpu's mirrored tables
// (F', K's columns and G's rows reversed: _dev_tables(reverse=True)), so
// no table and no copy of the data is flipped.
//
// Back extension (filtfilt's forward pass, over its signal and then the
// pad samples of its odd extension): a forward pass over n samples may
// read the last n - nb from a second tensor `back` (the BACK instances of
// stage_tile's two callers and of output_kernel), so that no caller
// copies the whole signal to append them.  Without it (BACK false, the
// chain's and every other caller's) the instances are the plain ones.
//
// Bound on an H100: 8 bytes of HBM traffic per sample (x in, y out).  The
// cascade needs 5 multiply-adds per section per sample, far below the
// bytes' time.  The chain moves x twice (steps 1 and 3), U (p floats a
// row and channel, 1/16 of x at p = 8) twice and y once: about 800 MB a
// pass at 1,000,000 x 64, 0.24 ms at the HBM rate against the 0.153 ms
// bound.  A single pass that reads x once needs the chunk states of
// blocks that ran before it (a look-back between blocks), which makes the
// result depend on timing.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int V = 128;
constexpr int R = 16;
constexpr int kStages = 3;     // x tiles in shared memory, kStages - 1 ahead

// Memory row of virtual sample t: t itself, or tbase - t in reverse.
__device__ __forceinline__ long long row_of(long long t, long long tbase) {
    return tbase < 0 ? t : tbase - t;
}

__device__ __forceinline__ int skew(int row, int cw) {
    return cw < 32 ? row + (row >> 4) : row;
}

// W floats (4 or 1) from global to shared memory, asynchronously; zeros
// where !valid
template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (W == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A pointer the compiler cannot see through: loads from it are not
// hoisted out of a loop into registers (a P x P matrix at P = 16, 32
// would not fit).
__device__ __forceinline__ const float* opaque(const float* p) {
    asm volatile("" : "+l"(p));
    return p;
}

__host__ __device__ constexpr int ilog2(int v) {
    return v > 1 ? 1 + ilog2(v >> 1) : 0;
}

// Tile geometry of steps 1 and 3 (every size a power of two): RG rows of
// cw channels a row group, S = 256 / (RG cw) segments of 16 samples a row
// in step 1, TS = 16 S samples a tile, NK tiles a row group, rows padded
// by cw below 32 channels.
struct Tiles {
    int RG, S, TS, rs, xs, NK, lcw, lts, lnk;
    __host__ __device__ Tiles(int L, int cw) {
        RG = L < kThreads / cw ? L : kThreads / cw;
        S = kThreads / (RG * cw);
        TS = 16 * S;
        rs = TS * cw + (cw < 32 ? cw : 0);
        xs = RG * rs;
        NK = V / TS;
        lcw = ilog2(cw);
        lts = ilog2(TS);
        lnk = ilog2(NK);
    }
};

// Tile ti of the chunk from row bj (row group ti / NK, samples (ti % NK)
// TS ..), channels cbase .. cbase + cw - 1, into buffer ti % kStages of xs
// as [r * rs + u * cw + c]; zeros past n and C.  Offsets within the tile
// are 32-bit and found by shifts.  Commits one group of copies, empty past
// the last tile.  BACK (forward passes): samples nb .. n - 1 are the rows
// of `back`, those before nb the rows of x.
template <bool BACK>
__device__ __forceinline__ void stage_tile(
        float* xs, const float* __restrict__ x,
        const float* __restrict__ back, long long nb, int ti, int NT,
        const Tiles& T, long long bj, long long n, long long tbase, int C,
        int cbase, bool vec, int tid, int nth) {
    if (ti < NT) {
        xs += (ti % kStages) * T.xs;
        const long long t0 =
            (bj + (long long)(ti >> T.lnk) * T.RG) * V +
            (ti & (T.NK - 1)) * T.TS;
        const long long left = n - t0;     // offsets below it lie in x
        const int lim = left < (1 << 30) ? (int)left : (1 << 30);
        const float* xb = x + row_of(t0, tbase) * C + cbase;
        const long long nx = nb - t0;      // offsets from it lie in back
        const int sC = tbase < 0 ? C : -C;
        const int cw = 1 << T.lcw;
        const int lw = vec ? 2 : 0;        // log2 of floats a copy
        const int lq = T.lcw - lw;         // log2 of copies a sample
        for (int e = tid; e < (T.RG * T.TS) << lq; e += nth) {
            const int cl = (e & ((1 << lq) - 1)) << lw, rest = e >> lq;
            const int u = rest & (T.TS - 1), r = rest >> T.lts;
            const int off = r * V + u;
            const bool ok = off < lim && cbase + cl < C;
            float* d = xs + r * T.rs + u * cw + cl;
            const float* src = ok ? xb + (long long)off * sC + cl : x;
            if (BACK && ok && off >= nx)
                src = back + (off - nx) * C + cbase + cl;
            if (vec)
                cp_async<4>(d, src, ok);
            else
                cp_async<1>(d, src, ok);
        }
    }
    cp_async_commit();
}

// Step 1.  Block (chunk j, channel group): U for the chunk's rows,
// U[b][a][c] = sum_u Kt[u][a] x[b*V + u][c], thread (segment, row, c)
// summing its 16 samples of each tile, segments added in order; then the
// chunk's end state from zero, E[j] (rows folded in order, threads on
// (state, channel)).
template <int P, bool BACK = false>
__global__ void __launch_bounds__(kThreads)
chunk_reduce_kernel(const float* __restrict__ x,
                    const float* __restrict__ back,
                    const float* __restrict__ kt,
                    const float* __restrict__ av, float* __restrict__ U,
                    float* __restrict__ E, long long n, long long nb,
                    long long tbase, int C, int B, int L, int cw, bool vec) {
    extern __shared__ __align__(16) float sm[];
    const Tiles T(L, cw);
    const int RG = T.RG, NK = T.NK, NT = (L / RG) * NK, lcw = T.lcw;
    const int items = RG * cw;             // (row, channel) a row group
    const int li = ilog2(items);
    float* ks = sm;                        // V x P
    float* as = ks + V * P;                // P x P
    float* xs = as + P * P;                // kStages x T.xs
    float* ps = xs + kStages * T.xs;       // S x P x items, then U
    float* zs = ps + kThreads * P;         // 2 x P x cw
    const int tid = threadIdx.x;
    const int j = blockIdx.x;
    const int cbase = blockIdx.y * cw;
    const long long bj = (long long)j * L;
    for (int ti = 0; ti < kStages - 1; ++ti)
        stage_tile<BACK>(xs, x, back, nb, ti, NT, T, bj, n, tbase, C, cbase,
                         vec, tid, kThreads);
    for (int i = tid; i < V * P; i += kThreads) ks[i] = kt[i];
    for (int i = tid; i < P * P; i += kThreads) as[i] = av[i];
    for (int i = tid; i < P * cw; i += kThreads) zs[i] = 0.f;
    const int cl = tid & (cw - 1), item = tid & (items - 1), seg = tid >> li;
    const int r = item >> lcw;
    float acc[P];
    int cur = 0;
    for (int it = 0; it < NT; ++it) {
        const int g = it / NK, k = it & (NK - 1);
        // tile it has landed, and every thread is done with tile it - 1,
        // whose buffer takes tile it + kStages - 1
        cp_async_wait<kStages - 2>();
        __syncthreads();
        stage_tile<BACK>(xs, x, back, nb, it + kStages - 1, NT, T, bj, n,
                         tbase, C, cbase, vec, tid, kThreads);
        if (k == 0) {
#pragma unroll
            for (int a = 0; a < P; ++a) acc[a] = 0.f;
        }
        const float* xt = xs + (it % kStages) * T.xs + r * T.rs +
                          ((seg * 16) << lcw) + cl;
        const float* kr = ks + (k * T.TS + seg * 16) * P;
#pragma unroll
        for (int u = 0; u < 16; ++u) {
            const float xv = xt[u << lcw];
#pragma unroll
            for (int a = 0; a < P; a += 4) {
                const float4 kv = *reinterpret_cast<const float4*>(
                    kr + u * P + a);
                acc[a] = fmaf(kv.x, xv, acc[a]);
                acc[a + 1] = fmaf(kv.y, xv, acc[a + 1]);
                acc[a + 2] = fmaf(kv.z, xv, acc[a + 2]);
                acc[a + 3] = fmaf(kv.w, xv, acc[a + 3]);
            }
        }
        if (k == NK - 1) {
            const long long b0 = bj + (long long)g * RG;
#pragma unroll
            for (int a = 0; a < P; ++a)
                ps[(seg * P + a) * items + item] = acc[a];
            __syncthreads();
            // ps[a][row][c] = U of the row group, also written out
            for (int i = tid; i < P * items; i += kThreads) {
                float v = ps[i];
                for (int sg = 1; sg < T.S; ++sg) v += ps[sg * P * items + i];
                ps[i] = v;
                const int a = i >> li, rc = i & (items - 1);
                const long long b = b0 + (rc >> lcw);
                const int c = cbase + (rc & (cw - 1));
                if (b < B && c < C) U[(b * P + a) * C + c] = v;
            }
            __syncthreads();
            for (int rr = 0; rr < RG && b0 + rr < B; ++rr) {
                const float* z = zs + cur * P * cw;
                float* zn = zs + (cur ^ 1) * P * cw;
                for (int i = tid; i < P * cw; i += kThreads) {
                    const int a = i >> lcw, c = i & (cw - 1);
                    float v = ps[a * items + rr * cw + c];
#pragma unroll
                    for (int q = 0; q < P; ++q)
                        v = fmaf(as[a * P + q], z[q * cw + c], v);
                    zn[i] = v;
                }
                cur ^= 1;
                __syncthreads();
            }
        }
    }
    for (int i = tid; i < P * cw; i += kThreads) {
        const int a = i >> lcw, c = cbase + (i & (cw - 1));
        if (c < C) E[((long long)j * P + a) * C + c] = zs[cur * P * cw + i];
    }
}

// s <- m s + e.  Up to P = 8 the state and the products run in registers.
// Above, one state row at a time (a loop that is not unrolled) into this
// thread's column of shared memory sc (P x nth), so that no register
// array is indexed at run time and no P x P matrix is held in registers.
template <int P>
__device__ __forceinline__ void carry_step(float (&s)[P], const float* m,
                                           const float (&e)[P], float* sc,
                                           int nth, int tid) {
    if constexpr (P <= 8) {
        float sn[P];
#pragma unroll
        for (int a = 0; a < P; ++a) {
            float v = e[a];
#pragma unroll
            for (int q = 0; q < P; ++q) v = fmaf(m[a * P + q], s[q], v);
            sn[a] = v;
        }
#pragma unroll
        for (int a = 0; a < P; ++a) s[a] = sn[a];
    } else {
#pragma unroll
        for (int a = 0; a < P; ++a) sc[a * nth + tid] = e[a];
#pragma unroll 1
        for (int a = 0; a < P; ++a) {
            float v = sc[a * nth + tid];
#pragma unroll
            for (int q = 0; q < P; ++q) v = fmaf(m[a * P + q], s[q], v);
            sc[a * nth + tid] = v;
        }
#pragma unroll
        for (int a = 0; a < P; ++a) s[a] = sc[a * nth + tid];
    }
}

// The carry over `len` chunk ends from chunk j0: s <- m s + E[j], the E of
// the next KB steps loaded while these KB run; with zin, the state
// entering each chunk is written first.
template <int P>
__device__ __forceinline__ void carry_walk(float (&s)[P],
                                           const float* __restrict__ E,
                                           const float* m, int j0, int len,
                                           int c, int C, float* zin,
                                           float* sc, int nth, int tid) {
    constexpr int KB = P <= 8 ? 4 : 1;
    float e[KB][P], f[KB][P];
    auto load = [&](float (&d)[KB][P], int i0) {
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
#pragma unroll
            for (int a = 0; a < P; ++a)
                d[kb][a] = i0 + kb < len
                    ? E[((long long)(j0 + i0 + kb) * P + a) * C + c] : 0.f;
    };
    load(e, 0);
    for (int i0 = 0; i0 < len; i0 += KB) {
        load(f, i0 + KB);
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
            if (i0 + kb < len) {
                if (zin) {
#pragma unroll
                    for (int a = 0; a < P; ++a)
                        zin[((long long)(j0 + i0 + kb) * P + a) * C + c] =
                            s[a];
                }
                carry_step<P>(s, m, e[kb], sc, nth, tid);
            }
        }
#pragma unroll
        for (int kb = 0; kb < KB; ++kb)
#pragma unroll
            for (int a = 0; a < P; ++a) e[kb][a] = f[kb][a];
    }
}

// Step 2.  Block of cb channels x NG groups of GL chunk ends: each group's
// end state from zero (in parallel), the state entering each group (in
// series, one thread per channel, with (AV^L)^GL), then each group from
// its entering state, writing zin[j] = S_{j-1}.
template <int P>
__global__ void __launch_bounds__(kThreads)
carry_kernel(const float* __restrict__ E, const float* __restrict__ avl,
             const float* __restrict__ z0, float* __restrict__ zin, int C,
             int nchunks, int GL, int NG, int cb) {
    extern __shared__ __align__(16) float sm[];
    const int tid = threadIdx.x, nth = blockDim.x;
    float* as = sm;                        // AV^L
    float* pw = as + P * P;                // (AV^L)^m, two buffers
    float* T = pw + 2 * P * P;             // NG x P x cb, from zero
    float* Sg = T + NG * P * cb;           // NG x P x cb, entering
    float* sc = Sg + NG * P * cb;          // P x nth above P = 8
    for (int i = tid; i < P * P; i += nth) as[i] = pw[i] = avl[i];
    __syncthreads();
    int cur = 0;
    for (int m = 1; m < GL; ++m) {
        const float* a0 = pw + cur * P * P;
        float* a1 = pw + (cur ^ 1) * P * P;
        for (int i = tid; i < P * P; i += nth) {
            const int a = i / P, q = i % P;
            float v = 0.f;
            for (int k = 0; k < P; ++k)
                v = fmaf(as[a * P + k], a0[k * P + q], v);
            a1[i] = v;
        }
        cur ^= 1;
        __syncthreads();
    }
    const float* pg = pw + cur * P * P;
    const int cl = tid % cb, g = tid / cb;
    const int c = blockIdx.x * cb + cl;
    const int j0 = g * GL;
    const int len = nchunks - j0 < GL ? nchunks - j0 : GL;
    float s[P];
    if (c < C && g < NG - 1) {
#pragma unroll
        for (int a = 0; a < P; ++a) s[a] = 0.f;
        carry_walk<P>(s, E, as, j0, len, c, C, nullptr, sc, nth, tid);
#pragma unroll
        for (int a = 0; a < P; ++a) T[(g * P + a) * cb + cl] = s[a];
    }
    __syncthreads();
    if (g == 0 && c < C) {
#pragma unroll
        for (int a = 0; a < P; ++a) {
            s[a] = z0[a * C + c];
            Sg[a * cb + cl] = s[a];
        }
        for (int h = 0; h + 1 < NG; ++h) {
            float e[P];
#pragma unroll
            for (int a = 0; a < P; ++a) e[a] = T[(h * P + a) * cb + cl];
            carry_step<P>(s, pg, e, sc, nth, tid);
#pragma unroll
            for (int a = 0; a < P; ++a) Sg[((h + 1) * P + a) * cb + cl] = s[a];
        }
    }
    __syncthreads();
    if (c < C) {
#pragma unroll
        for (int a = 0; a < P; ++a) s[a] = Sg[(g * P + a) * cb + cl];
        carry_walk<P>(s, E, as, j0, len, c, C, zin, sc, nth, tid);
    }
}

// F route, after the carry: one thread per (chunk j, channel c) over rows
// [j*L, min(j*L+L, B)) from zin[j], writing the entering state over U in
// place and, for row `brow`, the state after it -> zrow.
template <int P>
__global__ void __launch_bounds__(kThreads)
scan_kernel(float* __restrict__ U, const float* __restrict__ av,
            const float* __restrict__ zin, float* __restrict__ zrow, int C,
            int B, int L, int nchunks, int brow) {
    __shared__ float as[P * P];
    for (int i = threadIdx.x; i < P * P; i += kThreads) as[i] = av[i];
    __syncthreads();
    const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (idx >= (long long)nchunks * C) return;
    const int c = (int)(idx % C);
    const int j = (int)(idx / C);
    float z[P];
#pragma unroll
    for (int a = 0; a < P; ++a) z[a] = zin[((long long)j * P + a) * C + c];
    const int b1 = min(B, (j + 1) * L);
    for (int b = j * L; b < b1; ++b) {
        float* u = U + (long long)b * P * C + c;
        const float* m = P > 8 ? opaque(as) : as;
        float zn[P];
#pragma unroll
        for (int a = 0; a < P; ++a) {
            float s = u[(long long)a * C];
#pragma unroll
            for (int q = 0; q < P; ++q) s = fmaf(m[a * P + q], z[q], s);
            zn[a] = s;
        }
#pragma unroll
        for (int a = 0; a < P; ++a) u[(long long)a * C] = z[a];
        if (b == brow) {
#pragma unroll
            for (int a = 0; a < P; ++a) zrow[(long long)a * C + c] = zn[a];
        }
#pragma unroll
        for (int a = 0; a < P; ++a) z[a] = zn[a];
    }
}

// Y[b*V + v][c] = sum_{u<=v} h[v-u] x[b*V + u][c] + sum_a G[v][a] Z[b][a][c]
// (BACK: samples from nb on are the rows of back, as in stage_tile)
template <int P, bool BACK = false>
__global__ void __launch_bounds__(kThreads)
output_kernel(const float* __restrict__ x, const float* __restrict__ back,
              const float* __restrict__ h, const float* __restrict__ gt,
              const float* __restrict__ Z, float* __restrict__ y, long long n,
              long long nb, long long tbase, int C, int B, int cw, int rb) {
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
            (t < n && c < C)
                ? (BACK && t >= nb ? back[(t - nb) * C + c]
                                   : x[row_of(t, tbase) * C + c])
                : 0.f;
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

// Step 3 on SOS routes.  Block (chunk j, channel group), one thread per
// (row, channel) of a row group: the group's U to shared memory, its rows
// walked from the entering state (threads on (state, channel)) to each
// row's entering state, then the cascade of nsec <= P/2 sections, sec =
// (b0, b1, b2, a1, a2) per section and the gain g last, per (row,
// channel) over the staged x tiles.
template <int P, bool BACK = false>
__global__ void __launch_bounds__(kThreads)
chunk_scan_sos_output_kernel(const float* __restrict__ x,
                             const float* __restrict__ back,
                             const float* __restrict__ sec,
                             const float* __restrict__ U,
                             const float* __restrict__ av,
                             const float* __restrict__ zin,
                             float* __restrict__ zrow, float* __restrict__ y,
                             long long n, long long nb, long long tbase,
                             int C, int B, int L, int nsec, int cw, int brow,
                             bool vec) {
    constexpr int NS = P / 2;
    constexpr int CS = (5 * NS + 4) & ~3;
    constexpr int KU = P <= 8 ? 16 : 4;    // samples loaded ahead
    // up to 4 sections the coefficients stay in registers (they are read
    // five times a section a sample); above, in shared memory
    constexpr int NR = P <= 8 ? NS : 0;
    extern __shared__ __align__(16) float sm[];
    const Tiles T(L, cw);
    const int RG = T.RG, NK = T.NK, NT = (L / RG) * NK, lcw = T.lcw;
    const int nth = RG * cw;
    const int pc = P * cw, lpc = ilog2(P) + lcw;
    float* cs = sm;                        // 5 nsec + 1
    float* as = cs + CS;                   // P x P
    float* xs = as + P * P;                // kStages x T.xs
    float* zs = xs + kStages * T.xs;       // (RG + 1) x P x cw
    float* us = zs + (RG + 1) * pc;        // RG x P x cw
    const int tid = threadIdx.x;
    const int j = blockIdx.x;
    const int cbase = blockIdx.y * cw;
    const long long bj = (long long)j * L;
    for (int ti = 0; ti < kStages - 1; ++ti)
        stage_tile<BACK>(xs, x, back, nb, ti, NT, T, bj, n, tbase, C, cbase,
                         vec, tid, nth);
    for (int i = tid; i <= 5 * nsec; i += nth) cs[i] = sec[i];
    for (int i = tid; i < P * P; i += nth) as[i] = av[i];
    for (int i = tid; i < pc; i += nth) {
        const int c = cbase + (i & (cw - 1));
        zs[i] = c < C ? zin[((long long)j * P + (i >> lcw)) * C + c] : 0.f;
    }
    const int cl = tid & (cw - 1), r = tid >> lcw;
    const int c = cbase + cl;
    const long long ys = tbase < 0 ? C : -C;
    float co[NR > 0 ? 5 * NR : 1], gr = 0.f;
#pragma unroll
    for (int i = 0; i < 5 * NR; ++i) {
        const float v = i < 5 * nsec ? sec[i] : 0.f;
        co[i] = i % 5 >= 3 ? -v : v;       // -a1, -a2
    }
    if (NR > 0) gr = sec[5 * nsec];
    float s1[NS], s2[NS];
    for (int it = 0; it < NT; ++it) {
        const int g = it / NK, k = it & (NK - 1);
        const long long b0 = bj + (long long)g * RG;
        if (k == 0) {
            for (int i = tid; i < RG * pc; i += nth) {
                const long long b = b0 + (i >> lpc);
                const int cc = cbase + (i & (cw - 1));
                us[i] = b < B && cc < C
                    ? U[(b * P + ((i & (pc - 1)) >> lcw)) * C + cc] : 0.f;
            }
        }
        // tile it has landed, and every thread is done with tile it - 1,
        // whose buffer takes tile it + kStages - 1
        cp_async_wait<kStages - 2>();
        __syncthreads();
        stage_tile<BACK>(xs, x, back, nb, it + kStages - 1, NT, T, bj, n,
                         tbase, C, cbase, vec, tid, nth);
        if (k == 0) {
            // zs[rr] = the state entering row b0 + rr
            for (int rr = 0; rr < RG && b0 + rr < B; ++rr) {
                for (int i = tid; i < pc; i += nth) {
                    const int a = i >> lcw, cc = i & (cw - 1);
                    float v = us[rr * pc + i];
#pragma unroll
                    for (int q = 0; q < P; ++q)
                        v = fmaf(as[a * P + q], zs[rr * pc + q * cw + cc], v);
                    zs[(rr + 1) * pc + i] = v;
                    if (b0 + rr == brow && cbase + cc < C)
                        zrow[(long long)a * C + cbase + cc] = v;
                }
                __syncthreads();
            }
#pragma unroll
            for (int q = 0; q < NS; ++q) {
                s1[q] = q < nsec ? zs[(r * P + 2 * q) * cw + cl] : 0.f;
                s2[q] = q < nsec ? zs[(r * P + 2 * q + 1) * cw + cl] : 0.f;
            }
            __syncthreads();
            for (int i = tid; i < pc; i += nth) zs[i] = zs[RG * pc + i];
        }
        const long long b = b0 + r;
        if (b < B && c < C) {
            const long long t0 = b * V + k * T.TS;
            const long long left = n - t0;
            const int len = left < T.TS ? (int)left : T.TS;
            const float* xt = xs + (it % kStages) * T.xs + r * T.rs + cl;
            float* yp = y + row_of(t0, tbase) * C + c;
            const float gn = NR > 0 ? gr : cs[5 * nsec];
            for (int u0 = 0; u0 < len; u0 += KU) {
                float wu[KU];
#pragma unroll
                for (int i = 0; i < KU; ++i) wu[i] = xt[(u0 + i) << lcw];
#pragma unroll
                for (int i = 0; i < KU; ++i) {
                    float w = wu[i];
#pragma unroll
                    for (int q = 0; q < NS; ++q) {
                        if (q < nsec) {
                            if constexpr (NR > 0) {
                                const float* o = co + 5 * q;
                                const float yk = fmaf(o[0], w, s1[q]);
                                s1[q] = fmaf(o[1], w, fmaf(o[3], yk, s2[q]));
                                s2[q] = fmaf(o[2], w, o[4] * yk);
                                w = yk;
                            } else {
                                const float* o = cs + 5 * q;
                                const float yk = fmaf(o[0], w, s1[q]);
                                s1[q] = fmaf(o[1], w, fmaf(-o[3], yk, s2[q]));
                                s2[q] = fmaf(o[2], w, -o[4] * yk);
                                w = yk;
                            }
                        }
                    }
                    wu[i] = gn * w;
                }
#pragma unroll
                for (int i = 0; i < KU; ++i) {
                    if (u0 + i < len) *yp = wu[i];
                    yp += ys;
                }
            }
        }
    }
}

template <typename K>
cudaError_t smem_limit(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

template <int P, bool BACK>
int run(const float* x, const float* back, const float* h, const float* kt,
        const float* gt, const float* av, const float* avl, const float* z0,
        float* y, float* U, float* E, float* zin, float* zrow, long long n,
        long long nb, long long tbase, int C, int L, int brow,
        const float* sec, int nsec, cudaStream_t st) {
    const int B = (int)((n + V - 1) / V);
    const int nchunks = (B + L - 1) / L;
    int cw = 1;
    while (cw < C && cw < 32) cw *= 2;
    const int cgroups = (C + cw - 1) / cw;
    const Tiles T(L, cw);
    if (L % T.RG || T.S > 8 || nsec > P / 2) return cudaErrorInvalidValue;
    const bool vec = cw % 4 == 0 && C % 4 == 0 &&
                     reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<std::uintptr_t>(back) % 16 == 0;
    const dim3 grid(nchunks, cgroups);
    const size_t sm1 = sizeof(float) *
        ((size_t)V * P + P * P + kStages * T.xs + kThreads * P + 2 * P * cw);
    cudaError_t err = smem_limit(chunk_reduce_kernel<P, BACK>, sm1);
    if (err != cudaSuccess) return err;
    chunk_reduce_kernel<P, BACK><<<grid, kThreads, sm1, st>>>(
        x, back, kt, av, U, E, n, nb, tbase, C, B, L, cw, vec);

    // carry: NG groups of GL chunk ends, NG near sqrt(2 nchunks)
    int NG = (int)std::ceil(std::sqrt(2.0 * nchunks));
    if (NG > kThreads) NG = kThreads;
    const int GL = (nchunks + NG - 1) / NG;
    NG = (nchunks + GL - 1) / GL;
    // one or two warps a block: its steps wait on few other warps
    const int cb = C < 64 / NG ? C : (64 / NG > 0 ? 64 / NG : 1);
    const size_t sm2 = sizeof(float) * (3 * P * P + 2 * (size_t)NG * P * cb +
                                         (P > 8 ? P * cb * NG : 0));
    err = smem_limit(carry_kernel<P>, sm2);
    if (err != cudaSuccess) return err;
    carry_kernel<P><<<(C + cb - 1) / cb, cb * NG, sm2, st>>>(
        E, avl, z0, zin, C, nchunks, GL, NG, cb);

    if (nsec > 0) {
        const int CS = (5 * (P / 2) + 4) & ~3;
        const size_t sm3 = sizeof(float) *
            (CS + P * P + kStages * T.xs + (2 * (size_t)T.RG + 1) * P * cw);
        err = smem_limit(chunk_scan_sos_output_kernel<P, BACK>, sm3);
        if (err != cudaSuccess) return err;
        chunk_scan_sos_output_kernel<P, BACK><<<grid, T.RG * cw, sm3, st>>>(
            x, back, sec, U, av, zin, zrow, y, n, nb, tbase, C, B, L, nsec,
            cw, brow, vec);
        return cudaGetLastError();
    }
    const long long items = (long long)nchunks * C;
    const unsigned sblocks = (unsigned)((items + kThreads - 1) / kThreads);
    scan_kernel<P><<<sblocks, kThreads, 0, st>>>(U, av, zin, zrow, C, B, L,
                                                 nchunks, brow);
    int tt = (kThreads / cw) * R;
    if (tt < 512) tt = 512;
    const int rb = tt / V;
    const int rows = tt + tt / 16 + 1;
    const size_t smem =
        sizeof(float) * (V + V * P + (size_t)rb * P * cw + (size_t)rows * cw);
    err = smem_limit(output_kernel<P, BACK>, smem);
    if (err != cudaSuccess) return err;
    output_kernel<P, BACK><<<dim3((B + rb - 1) / rb, cgroups), kThreads,
                             smem, st>>>(x, back, h, gt, U, y, n, nb, tbase,
                                         C, B, cw, rb);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, y: (n, C) forward (tbase = -1); in reverse the pass covers the
// samples tbase, tbase - 1, ..., tbase - n + 1 of x and y.  back: null, or
// (n - nb, C) in a forward pass without zrow: samples nb .. n - 1 are then
// read from back's rows, x holds the first nb (filtfilt's back extension,
// not appended to x).  h: (V,); kt, gt: (V, P); av, avl: (P, P); z0:
// (P, C); scratch U: (B, P, C); E, zin: (nchunks, P, C); zrow: (P, C) or
// null (with brow = -1).  P is 8, 16 or 32 (tables zero-padded).  nsec >
// 0: the system is a stacked cascade of nsec sections, sec (5 nsec + 1,)
// their (b0, b1, b2, a1, a2) and the gain, and the SOS stage replaces the
// F stage (h unused).
int dsptpu_biir(const void* x, const void* back, const void* h,
                const void* kt, const void* gt, const void* av,
                const void* avl, const void* z0, void* y, void* U, void* E,
                void* zin, void* zrow, long long n, long long nb,
                long long tbase, int C, int P, int L, int brow,
                const void* sec, int nsec, void* stream) {
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    auto m = [](void* p) { return static_cast<float*>(p); };
    auto st = static_cast<cudaStream_t>(stream);
    if (back && (tbase >= 0 || zrow || nb < 0 || nb > n))
        return cudaErrorInvalidValue;
    auto go = [&](auto run_p) {
        return run_p(f(x), f(back), f(h), f(kt), f(gt), f(av), f(avl),
                     f(z0), m(y), m(U), m(E), m(zin), m(zrow), n,
                     back ? nb : n, tbase, C, L, brow, f(sec), nsec, st);
    };
    switch (P) {
        case 8:
            return back ? go(run<8, true>) : go(run<8, false>);
        case 16:
            return back ? go(run<16, true>) : go(run<16, false>);
        case 32:
            return back ? go(run<32, true>) : go(run<32, false>);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // extern "C"

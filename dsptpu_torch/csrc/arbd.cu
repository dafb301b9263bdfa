// K7: near-unity arbitrary-rate dual-PFB resampling of a 1-D float32
// stream, its plan derived on the card from the stream's float64 anchor.
//
// Replaces dsptpu/kernels/arbd.py:arbd_resample_pallas (:359, pallas_call
// :332).  With xcat = hist ‖ x and (W, nphi) banks pfb and dpfb, output
// i < out_len is the stream's output J = j0 + i:
//
//     y_i = lo_i + alpha_i * hi_i,
//     lo_i = sum_{t < W} pfb[t, phi_i] * xcat[end0_i - (W - 1) + t],
//
// hi_i the same over dpfb (reference stream_filt.jl:579-625), zero where
// the window leaves xcat.  end0_i, phi_i and alpha_i come from the
// anchor (acc_base, delta, nphi, j0, end_off) by the closed form of
// FIRArbitrary.plan, in plan_at below:
//
//     acc = acc_base + J delta      (product and sum rounded apart)
//     q = floor(acc / nphi),  rem = acc - q nphi (+ nphi where < 0)
//     end0 = end_off + q,  phi = floor(rem),  alpha = float(rem - phi)
//
// The intrinsics keep nvcc from contracting the product and the sum
// into one DFMA, which rounds differently from numpy; rem is exact, and
// equals numpy's mod.  The same __device__ function writes the plan in
// the plan-only launch (dsptpu_arbd_plan), which the tests hold to the
// host plan bit for bit.
//
// Bound on an H100: the bytes, 4 per input sample and 4 per output
// (the 4 W + 2 flops per output take about as long on the CUDA cores).
// What held the parent kernel back was shared memory, three loads per
// multiply-add pair (a sample and a tap of each bank), and a plan read
// from device memory.  The design:
//   * no plan arrays: each thread evaluates the closed form for its own
//     outputs, and a tile's input span follows from its first and last
//     outputs' window ends, since end0 does not decrease with J;
//   * a thread owns a run of R consecutive outputs (R = 9: lanes read
//     windows R words apart, and an odd R keeps a warp's loads in 32
//     banks).  Near unity a run mostly holds one phase and consecutive
//     window ends, so its R outputs read window starts s0, ..., s0 + R -
//     1: one register window of R + 3 samples slides under all R slots,
//     each tap costs one shared load of x and (by 16-byte loads of four
//     taps) half a load of the phase's two tap rows, and each output-tap
//     two fused multiply-adds and nothing else;
//   * under dsptpu's gate (at most 40 drift segments per 32768 outputs,
//     no duplicates) a run holds at most two phases, A and then B from a
//     split ks, and at most one extra input step, at the split (phi
//     wraps from nphi - 1 to 0 and end0 moves by 2).  The window path
//     computes the outputs below ks; those from ks on (at 0.9997 about
//     4% of the outputs) go to the block's split pass, which counts them
//     by a prefix sum over its threads and computes them one a thread,
//     from shared memory, so that they take a few warps of the block,
//     not a few lanes of every warp.  A select of each slot's taps by
//     its own split cost more (two half-rate integer operations per pair
//     of multiply-adds), and so did a row address per slot;
//   * a run outside that geometry (more phases, other steps) is computed
//     by its thread one output at a time, so the kernel is right for any
//     anchor; counts[0] counts such runs (none under the gate),
//     counts[1] the split passes' outputs.  A tile whose span exceeds
//     the buffer reads xcat from global memory the same way;
//   * blocks are persistent, as many as fit on the card: each stages
//     both banks once, transposed to one row of Wp = W rounded up to 4
//     taps a phase, then walks tiles of 256 R outputs, staging the next
//     tile's span by 16-byte cp.async (a scalar head and tail, zero
//     outside xcat) while it computes this one, four barriers a tile;
//   * the tile's outputs gather in shared memory, so that the stores
//     are coalesced.
// Each output's sums run in ascending tap order with fused multiply-
// adds, then y = fmaf(alpha, hi, lo), on every path: an output has the
// same bits whichever path computes it and wherever the stream is cut.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 9;                     // R, outputs a thread
constexpr int kTile = kThreads * kRun;      // outputs a tile
constexpr int kStages = 2;                  // tile buffers: 1 computed,
                                            // kStages - 1 in flight

struct Anchor {
    double acc_base, delta, inv_nphi;
    long long j0, end_off;
    int nphi, pow2;
};

struct Args {
    const float* hist;
    const float* x;
    const float* pfb;
    const float* dpfb;
    float* y;
    int* counts;
    long long hl, n, out_len, tiles;
    Anchor an;
    int W, Wp, cap, cap_alloc;
};

// q = floor(acc / nphi) and rem = acc - q nphi (+ nphi where < 0) of
// the output with stream-global index jd (a double, exact below 2^53)
__device__ __forceinline__ void closed_form(const Anchor& a, double jd,
                                            double& q, double& rem) {
    const double acc = __dadd_rn(a.acc_base, __dmul_rn(jd, a.delta));
    const double np = (double)a.nphi;
    q = floor(a.pow2 ? __dmul_rn(acc, a.inv_nphi) : __ddiv_rn(acc, np));
    rem = __dsub_rn(acc, __dmul_rn(q, np));
    if (rem < 0.0) rem = __dadd_rn(rem, np);
}

// output J's window end (0-based in xcat), phase and fraction
__device__ __forceinline__ void plan_at(const Anchor& a, long long J,
                                        long long& end0, int& phi,
                                        float& alpha) {
    double q, rem;
    closed_form(a, __ll2double_rn(J), q, rem);
    const double p = floor(rem);
    phi = (int)p;
    alpha = __double2float_rn(__dsub_rn(rem, p));
    end0 = a.end_off + (long long)q;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(d), "l"(src));
}

// one float, or a zero where !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// all but the kStages - 1 groups committed last are complete
__device__ __forceinline__ void cp_async_wait_staged() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

__device__ __forceinline__ float load_cat(const Args& a, long long pos) {
    if (pos < 0 || pos >= a.hl + a.n) return 0.f;
    return pos < a.hl ? a.hist[pos] : a.x[pos - a.hl];
}

// A tile's span: xcat[base, base + span) sits at buf[sh, sh + span),
// sh chosen so that buf and x share their alignment mod 16 bytes.
// span = 0: the tile is not staged (its windows span more than cap).
struct Tile {
    long long base, e_first, e_last;
    int span, sh;
};

__device__ __forceinline__ Tile tile_at(const Args& a, long long t) {
    Tile T;
    int p;
    float al;
    const long long j = a.an.j0 + t * kTile;
    plan_at(a.an, j, T.e_first, p, al);
    plan_at(a.an, j + kTile - 1, T.e_last, p, al);
    T.base = T.e_first - (a.W - 1);
    const long long span = T.e_last - T.e_first + a.W + 1;
    T.span = span <= a.cap ? (int)span : 0;
    const long long xw = (long long)(reinterpret_cast<uintptr_t>(a.x) >> 2);
    T.sh = (int)((xw + T.base - a.hl) & 3);
    return T;
}

// cp.async copies of the tile's span into buf: 16 bytes where four
// words lie in x and in the span, else one word (zero outside xcat)
__device__ __forceinline__ void stage(const Args& a, const Tile& T,
                                      float* buf) {
    const int nw = T.span ? T.sh + T.span : 0;
    for (int c = threadIdx.x; 4 * c < nw; c += kThreads) {
        const int i0 = 4 * c;
        const long long p0 = T.base + i0 - T.sh;
        if (i0 >= T.sh && i0 + 4 <= nw && p0 >= a.hl
            && p0 + 4 <= a.hl + a.n) {
            cp_async16(buf + i0, a.x + (p0 - a.hl));
            continue;
        }
        for (int j = 0; j < 4; ++j) {
            const int i = i0 + j;
            if (i < T.sh || i >= nw) continue;
            const long long pos = p0 + j;
            const bool in = pos >= 0 && pos < a.hl + a.n;
            cp_async4(buf + i, !in ? a.x : pos < a.hl ? a.hist + pos
                                                      : a.x + (pos - a.hl),
                      in);
        }
    }
}

// taps t0 + j, j < NJ, of every slot: the run's phase row of pfb at h
// and of dpfb at g (one 16-byte load of each for four taps); slot m's
// window at w[m + j]
template <int R, int NJ>
__device__ __forceinline__ void taps(const float* h, const float* g, int t0,
                                     const float (&w)[R + 3],
                                     float (&lo)[R], float (&hi)[R]) {
    float hv[4], gv[4];
    if constexpr (NJ == 4) {
        const float4 a = *reinterpret_cast<const float4*>(h + t0);
        const float4 b = *reinterpret_cast<const float4*>(g + t0);
        hv[0] = a.x; hv[1] = a.y; hv[2] = a.z; hv[3] = a.w;
        gv[0] = b.x; gv[1] = b.y; gv[2] = b.z; gv[3] = b.w;
    } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            hv[j] = h[t0 + j];
            gv[j] = g[t0 + j];
        }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int m = 0; m < R; ++m) {
            lo[m] = fmaf(hv[j], w[m + j], lo[m]);
            hi[m] = fmaf(gv[j], w[m + j], hi[m]);
        }
}

// the last NJ < 4 taps, from t on
template <int R, int NJ>
__device__ __forceinline__ void tail(const float* xw, int t, const float* h,
                                     const float* g, float (&w)[R + 3],
                                     float (&lo)[R], float (&hi)[R]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) w[R + j - 1] = xw[t + R + j - 1];
    taps<R, NJ>(h, g, t, w, lo, hi);
}

// The window path: the sums of slots 0..R-1 of a run, slot m's window
// xw[m, m + W), one phase's rows h and g (Wp taps, 16-byte aligned).  A
// register window of R + 3 samples slides four samples a step.
template <int R>
__device__ __forceinline__ void slots(const float* xw, int W, const float* h,
                                      const float* g, float (&lo)[R],
                                      float (&hi)[R]) {
    float w[R + 3];
#pragma unroll
    for (int i = 0; i < R - 1; ++i) w[i] = xw[i];
#pragma unroll
    for (int m = 0; m < R; ++m) lo[m] = hi[m] = 0.f;
    int t = 0;
    for (; t + 4 <= W; t += 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i) w[R - 1 + i] = xw[t + R - 1 + i];
        taps<R, 4>(h, g, t, w, lo, hi);
#pragma unroll
        for (int i = 0; i < R - 1; ++i) w[i] = w[i + 4];
    }
    switch (W - t) {
        case 1: tail<R, 1>(xw, t, h, g, w, lo, hi); break;
        case 2: tail<R, 2>(xw, t, h, g, w, lo, hi); break;
        case 3: tail<R, 3>(xw, t, h, g, w, lo, hi); break;
        default: break;
    }
}

// One output's two sums, its window from shared memory (xw) or, where xw
// is null, from xcat at position start.
__device__ __forceinline__ float one(const Args& a, const float* xw,
                                     long long start, const float* h,
                                     const float* g, float alpha) {
    float lo = 0.f, hi = 0.f;
    for (int t = 0; t < a.W; ++t) {
        const float v = xw ? xw[t] : load_cat(a, start + t);
        lo = fmaf(h[t], v, lo);
        hi = fmaf(g[t], v, hi);
    }
    return fmaf(alpha, hi, lo);
}

// A thread's run of R outputs from local index i0, written to ys[0, R).
// Returns how many outputs from the run's split on (ks, set) the warp's
// split pass computes; runs outside the two-phase geometry are computed
// here one output at a time.
template <int R>
__device__ __forceinline__ int run(const Args& a, const Tile& T,
                                   const float* buf, const float* hbank,
                                   const float* gbank, float* ys,
                                   long long i0, int& ks) {
    ks = R;
    if (i0 >= a.out_len) return 0;
    const double j0 = __ll2double_rn(a.an.j0 + i0);
    double q0, rem, q, pf0, pb = 0.0, step = 0.0;
    float al[R];
    closed_form(a.an, j0, q0, rem);
    pf0 = floor(rem);
    al[0] = __double2float_rn(__dsub_rn(rem, pf0));
    const long long e0 = a.an.end_off + (long long)q0;
    bool ok = T.span > 0 && e0 >= T.e_first && e0 + R - 1 <= T.e_last;
#pragma unroll
    for (int k = 1; k < R; ++k) {
        closed_form(a.an, __dadd_rn(j0, (double)k), q, rem);
        const double pf = floor(rem);
        al[k] = __double2float_rn(__dsub_rn(rem, pf));
        const double d = q - q0 - k;
        if (ks == R) {
            if (pf != pf0) {
                ks = k;
                pb = pf;
                step = d;
                ok = ok && (d == 0.0 || d == 1.0);
            } else {
                ok = ok && d == 0.0;
            }
        } else {
            ok = ok && pf == pb && d == step;
        }
    }
    if (ok) {
        const int p0 = (int)pf0;
        float lo[R], hi[R];
        slots<R>(buf + (e0 - (a.W - 1) - T.base + T.sh), a.W,
                 hbank + p0 * a.Wp, gbank + p0 * a.Wp, lo, hi);
#pragma unroll
        for (int k = 0; k < R; ++k)
            if (k < ks) ys[k] = fmaf(al[k], hi[k], lo[k]);
        const long long n = a.out_len - i0;
        return n > ks ? (int)((n < R ? n : R) - ks) : 0;
    }
    if (a.counts) atomicAdd(a.counts, 1);
    ks = R;
    for (int k = 0; k < R && i0 + k < a.out_len; ++k) {
        long long e;
        int p;
        float alpha;
        plan_at(a.an, a.an.j0 + i0 + k, e, p, alpha);
        const long long start = e - (a.W - 1);
        ys[k] = one(a, T.span ? buf + (start - T.base + T.sh) : nullptr,
                    start, hbank + p * a.Wp, gbank + p * a.Wp, alpha);
    }
    return 0;
}

// The block's split pass: the nfix outputs from each thread's split ks
// on, one a thread, in rounds of kThreads; thread s's run starts at
// local index first + s R and writes ys[s R, (s + 1) R).  Ends with a
// barrier, after which ys holds the whole tile.
template <int R>
__device__ __forceinline__ void split_pass(const Args& a, const Tile& T,
                                           const float* buf,
                                           const float* hbank,
                                           const float* gbank, float* ys,
                                           long long first, int nfix,
                                           int ks) {
    __shared__ int s_pre[kThreads], s_ks[kThreads], s_warp[kThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int pre = nfix;                           // inclusive, in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, pre, o);
        if (lane >= o) pre += v;
    }
    if (lane == 31) s_warp[warp] = pre;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
        if (w < warp) pre += s_warp[w];
        total += s_warp[w];
    }
    s_pre[threadIdx.x] = pre - nfix;          // exclusive, in the block
    s_ks[threadIdx.x] = ks;
    __syncthreads();
    if (threadIdx.x == 0 && total && a.counts) atomicAdd(a.counts + 1, total);
    for (int i = threadIdx.x; i < total; i += kThreads) {
        int s = 0;                            // last thread with pre <= i
#pragma unroll
        for (int b = kThreads / 2; b > 0; b >>= 1)
            if (s_pre[s + b] <= i) s += b;
        const int k = s_ks[s] + i - s_pre[s];
        long long e;
        int p;
        float alpha;
        plan_at(a.an, a.an.j0 + first + s * R + k, e, p, alpha);
        const long long start = e - (a.W - 1);
        ys[s * R + k] = one(a, buf + (start - T.base + T.sh), start,
                            hbank + p * a.Wp, gbank + p * a.Wp, alpha);
    }
    __syncthreads();
}

template <int R>
__global__ void __launch_bounds__(kThreads)
arbd_kernel(const Args a) {
    extern __shared__ float4 smem4[];
    float* hbank = reinterpret_cast<float*>(smem4);
    float* gbank = hbank + a.an.nphi * a.Wp;
    float* bufs = gbank + a.an.nphi * a.Wp;       // kStages tile buffers
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* ys = bufs + kStages * a.cap_alloc;     // the tile's outputs

    // both banks, transposed: row p holds phase p's taps, zero past W
    for (int i = threadIdx.x; i < a.an.nphi * a.Wp; i += kThreads) {
        const int p = i / a.Wp, t = i - p * a.Wp;
        hbank[i] = t < a.W ? a.pfb[t * a.an.nphi + p] : 0.f;
        gbank[i] = t < a.W ? a.dpfb[t * a.an.nphi + p] : 0.f;
    }
    // the first kStages - 1 tiles in flight, one cp.async group each
    for (int s = 0; s < kStages - 1; ++s) {
        const long long tn = blockIdx.x + (long long)s * gridDim.x;
        if (tn < a.tiles) stage(a, tile_at(a, tn), bufs + s * a.cap_alloc);
        cp_async_commit();
    }
    long long t = blockIdx.x;
    for (int it = 0; t < a.tiles; ++it, t += gridDim.x) {
        const long long tn = t + (long long)(kStages - 1) * gridDim.x;
        if (tn < a.tiles)
            stage(a, tile_at(a, tn),
                  bufs + (it + kStages - 1) % kStages * a.cap_alloc);
        cp_async_commit();
        cp_async_wait_staged();
        __syncthreads();
        const long long first = t * kTile;
        const Tile T = tile_at(a, t);
        const float* cur = bufs + it % kStages * a.cap_alloc;
        int ks;
        const int nfix = run<R>(a, T, cur, hbank, gbank,
                                ys + threadIdx.x * R,
                                first + threadIdx.x * R, ks);
        split_pass<R>(a, T, cur, hbank, gbank, ys, first, nfix, ks);
        const long long wf = first + (long long)warp * 32 * R;
        for (int i = lane; i < 32 * R; i += 32)
            if (wf + i < a.out_len) a.y[wf + i] = ys[warp * 32 * R + i];
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kThreads)
arbd_plan_kernel(const Anchor an, long long out_len, long long* end0,
                 int* phi, float* alpha) {
    for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
         i < out_len; i += (long long)gridDim.x * kThreads) {
        long long e;
        int p;
        float al;
        plan_at(an, an.j0 + i, e, p, al);
        end0[i] = e;
        phi[i] = p;
        alpha[i] = al;
    }
}

// the buffer's samples, the tile's span cap (near unity a tile's windows
// span about kTile + W samples; the buffer takes rates down to about
// 8/9), and the block's shared memory: both banks, kStages buffers, the
// warps' outputs
void geometry(int W, int nphi, int& Wp, int& cap, int& cap_alloc,
              size_t& smem) {
    Wp = (W + 3) & ~3;
    cap = kTile + kTile / 8 + W + 8;
    cap_alloc = (cap + 4 + 3) & ~3;
    smem = sizeof(float) * (2 * (size_t)nphi * Wp + kStages * (size_t)cap_alloc
                            + kTile);
}

Anchor make_anchor(double acc_base, double delta, int nphi, long long j0,
                   long long end_off) {
    Anchor an;
    an.acc_base = acc_base;
    an.delta = delta;
    an.inv_nphi = 1.0 / nphi;
    an.j0 = j0;
    an.end_off = end_off;
    an.nphi = nphi;
    an.pow2 = (nphi & (nphi - 1)) == 0;
    return an;
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// hist (hl,) or null, x (n,), pfb and dpfb (W, nphi), y (out_len,):
// float32, contiguous.  The anchor (acc_base, delta, nphi, j0, end_off)
// is the stream's (kernels/arbd.py, Anchor).  counts: null, or two ints:
// [0] gains one per run computed one output at a time (outside the
// two-phase geometry), [1] the outputs the split passes compute.
int dsptpu_arbd(const void* hist, long long hl, const void* x, long long n,
                double acc_base, double delta, int nphi, long long j0,
                long long end_off, const void* pfb, const void* dpfb, int W,
                long long out_len, void* counts, void* y, void* stream) {
    Args a;
    a.hist = static_cast<const float*>(hist);
    a.x = static_cast<const float*>(x);
    a.pfb = static_cast<const float*>(pfb);
    a.dpfb = static_cast<const float*>(dpfb);
    a.y = static_cast<float*>(y);
    a.counts = static_cast<int*>(counts);
    a.hl = hl;
    a.n = n;
    a.out_len = out_len;
    a.tiles = (out_len + kTile - 1) / kTile;
    a.an = make_anchor(acc_base, delta, nphi, j0, end_off);
    a.W = W;
    size_t smem = 0;
    geometry(W, nphi, a.Wp, a.cap, a.cap_alloc, smem);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(
        arbd_kernel<kRun>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, arbd_kernel<kRun>, kThreads, smem);
    if (err != cudaSuccess) return err;
    long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
    if (blocks > a.tiles) blocks = a.tiles;
    arbd_kernel<kRun><<<(unsigned)blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
    return cudaGetLastError();
}

// The plan alone, for out_len outputs from the anchor: end0 int64, phi
// int32, alpha float32, each (out_len,).
int dsptpu_arbd_plan(double acc_base, double delta, int nphi, long long j0,
                     long long end_off, long long out_len, void* end0,
                     void* phi, void* alpha, void* stream) {
    const Anchor an = make_anchor(acc_base, delta, nphi, j0, end_off);
    long long blocks = (out_len + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    arbd_plan_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        an, out_len, static_cast<long long*>(end0), static_cast<int*>(phi),
        static_cast<float*>(alpha));
    return cudaGetLastError();
}

}  // extern "C"

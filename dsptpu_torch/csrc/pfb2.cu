// K6: rational L/M polyphase resampling of a 1-D float32 stream.
//
// Replaces dsptpu/kernels/pfb2.py:pfb2_resample_pallas (:487; both of
// its pallas_calls, the resident and the grouped kernel).  With
// xcat = hist ‖ x, q_j = phi0 - 1 + j M and w_j = deficit - taps +
// floor(q_j / L):
//
//     y_j = sum_{t < taps} pfb[t, q_j mod L] * xcat[w_j + t],
//
// zero where w_j + t lies outside xcat.  hist and x are read through two
// pointers, never concatenated.
//
// Bound on an H100: the bytes (4 per input sample, 4 per output).  What
// holds a dot of this shape back is shared memory: an SM serves one
// 32-bank wavefront a cycle, a quarter of its float32 FMA rate, so the
// design spends one shared word per multiply-add, and tries to spend
// one wavefront per warp load:
//   * one phase column per thread.  A tile is kRows rows of P = k L
//     consecutive outputs; output c of every row has the same column
//     (phi0 - 1 + c M) mod L, and its window moves by k M from one row
//     to the next.  Thread `slot` keeps column c = slot: its taps sit in
//     registers (loaded once per block from global memory, where L1
//     holds the bank), and the output loop has no division at all;
//   * taps are a compile-time count NT, a multiple of 8 up to 64, so
//     every register index is a constant (no local memory).  A bank of
//     more than 64 taps runs in nch chunks of consecutive taps, taps /
//     nch or one more each, accumulating in tap order, and reloads each
//     chunk's taps for every tile;
//   * a chunk of ct taps (NT - 8 <= ct <= NT) runs through a switch,
//     uniform over the block, into the row loop unrolled for exactly ct
//     taps (nine of them a template): no padding slot is multiplied, so
//     no sample past the window is read (an Inf or NaN there, times a
//     zero tap, would make the output NaN where the plain version's is
//     finite), and at 147/160 41 of 48 slots cost a shared load, not
//     48.  The 48-tap template has no register to spare at 80: a select
//     per slot, or this switch with the column loop's counter and row
//     length in 64 bits, put it in a stack frame;
//   * a tile stages its input span, (kRows - 1) k M + floor((phi0 - 1 +
//     (P - 1) M) / L) + nch NT samples, with coalesced cp.async copies
//     (zero outside xcat) into one of two buffers while the block
//     computes the tile before it from the other, one barrier a tile;
//     the inner loop reads one sample per multiply-add;
//   * W of a warp's 32 lanes take consecutive columns (the wrapper's
//     choice, kernels/pfb2.py:_launch_geometry): W lanes read window
//     starts that span ceil((W - 1) M / L) + 1 words, so at 147/160
//     W = 29 keeps a warp's loads in 32 banks, one wavefront, where 32
//     lanes would need two;
//   * the wrapper picks W, warps per block (<= 8) and k for the fewest
//     wavefronts per output; P > W x warps (L larger than a block) runs
//     in passes of W x warps columns, taps reloaded for each pass, and
//     the column walks on by adding (W warps M) mod L;
//   * blocks are persistent: as many as fit on the card, each walking
//     tiles blockIdx.x, + gridDim.x, ... so that a column's taps are
//     loaded once, and the last wave is short (tiles of kRows P outputs);
//   * up to 48 taps a pass, __launch_bounds__ asks for three blocks of
//     256 threads an SM (85 registers), so that at path C's two rates
//     (6 warps a block) four blocks fit; 56 and 64 taps keep two, where
//     the taps alone take 56-64 registers.
// Products and sums run in ascending tap order with fused multiply-adds,
// the same for every output wherever the stream is cut.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;        // rows of a tile, one accumulator each
constexpr int kMaxThreads = 256;

// one float from global to shared memory, or a zero where !valid (src
// is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// copies of xcat[w0, w0 + span) into dst, zero outside xcat, as one group
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ hist,
                                      long long hl,
                                      const float* __restrict__ x,
                                      long long n, long long w0, int span) {
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
        const long long pos = w0 + i;
        const bool in = pos >= 0 && pos < hl + n;
        cp_async4(dst + i, !in ? x : pos < hl ? hist + pos : x + (pos - hl),
                  in);
    }
    cp_async_commit();
}

// taps t0 .. t0 + NT - 1 of column col, zero from tap `end` on
template <int NT>
__device__ __forceinline__ void load_taps(float (&h)[NT],
                                          const float* __restrict__ pfb,
                                          int end, int L, int col, int t0) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
        h[t] = t0 + t < end ? __ldg(pfb + (long long)(t0 + t) * L + col)
                            : 0.f;
}

// the first CT taps of a pass for every row of a tile
template <int NT, int CT>
__device__ __forceinline__ void dot_rows(float (&acc)[kRows],
                                         const float (&h)[NT],
                                         const float* xw, int kM) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int t = 0; t < CT; ++t)
            acc[r] = fmaf(h[t], xw[r * kM + t], acc[r]);
    }
}

template <int NT>
__global__ void __launch_bounds__(kMaxThreads, NT <= 48 ? 3 : 2)
pfb2_kernel(const float* __restrict__ hist, long long hl,
            const float* __restrict__ x, long long n,
            const float* __restrict__ pfb, int taps, int nch, int L, int M,
            int phi0m1, long long base, long long out_len, int lanes, int k,
            int span, long long tiles, float* __restrict__ y) {
    extern __shared__ float xs[];
    const int lane = threadIdx.x & 31;
    const int slots = (blockDim.x >> 5) * lanes;
    const int slot = (threadIdx.x >> 5) * lanes + lane;
    const int P = k * L;
    const int kM = k * M;
    const bool active = lane < lanes && slot < P;
    // the first column and its window offset in a tile, and the step of
    // a pass, once per block
    const long long q0 = phi0m1 + (long long)slot * M;
    const int col0 = (int)(q0 % L);
    const int off0 = (int)(q0 / L);
    const long long qs = (long long)slots * M;
    const int dcol = (int)(qs % L);
    const int doff = (int)(qs / L);
    const bool resident = nch == 1 && P <= slots;
    const int cq = taps / nch, cr = taps % nch;   // taps a chunk: cq (+1)

    float h[NT];
    if (resident && active) load_taps<NT>(h, pfb, taps, L, col0, 0);

    if (blockIdx.x < tiles)
        stage(xs, hist, hl, x, n, base + blockIdx.x * kRows * kM, span);
    int buf = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long j0 = tile * kRows * P;
        cp_async_wait_all();
        // this tile's span has landed, and the other buffer's last tile
        // has been read by every thread
        __syncthreads();
        const long long next = tile + gridDim.x;
        if (next < tiles)
            stage(xs + (buf ^ 1) * span, hist, hl, x, n,
                  base + next * kRows * kM, span);
        const float* cur = xs + buf * span;
        buf ^= 1;
        if (!active) continue;
        int col = col0, off = off0;
        for (int c = slot; c < P; c += slots) {
            float acc[kRows];
#pragma unroll
            for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
            for (int ch = 0; ch < nch; ++ch) {
                const int t0 = ch * cq + min(ch, cr);
                const int ct = cq + (ch < cr ? 1 : 0);
                if (!resident) load_taps<NT>(h, pfb, t0 + ct, L, col, t0);
                const float* xw = cur + off + t0;
                switch (NT - ct) {   // the pass's padding slots
                    case 0: dot_rows<NT, NT>(acc, h, xw, kM); break;
                    case 1: dot_rows<NT, NT - 1>(acc, h, xw, kM); break;
                    case 2: dot_rows<NT, NT - 2>(acc, h, xw, kM); break;
                    case 3: dot_rows<NT, NT - 3>(acc, h, xw, kM); break;
                    case 4: dot_rows<NT, NT - 4>(acc, h, xw, kM); break;
                    case 5: dot_rows<NT, NT - 5>(acc, h, xw, kM); break;
                    case 6: dot_rows<NT, NT - 6>(acc, h, xw, kM); break;
                    case 7: dot_rows<NT, NT - 7>(acc, h, xw, kM); break;
                    default: dot_rows<NT, NT - 8>(acc, h, xw, kM); break;
                }
            }
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const long long j = j0 + c + r * P;
                if (j < out_len) y[j] = acc[r];
            }
            col += dcol;
            off += doff;
            if (col >= L) {
                col -= L;
                ++off;
            }
        }
    }
}

template <int NT>
int launch(const float* hist, long long hl, const float* x, long long n,
           const float* pfb, int taps, int nch, int L, int M, int phi0m1,
           long long base, long long out_len, int lanes, int warps, int k,
           int span, float* y, cudaStream_t stream) {
    const int threads = warps * 32;
    const size_t smem = 2 * (size_t)span * sizeof(float);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(
        pfb2_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, pfb2_kernel<NT>, threads, smem);
    if (err != cudaSuccess) return err;
    const long long tile = (long long)kRows * k * L;
    const long long tiles = (out_len + tile - 1) / tile;
    long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
    if (blocks > tiles) blocks = tiles;
    pfb2_kernel<NT><<<(unsigned)blocks, threads, smem, stream>>>(
        hist, hl, x, n, pfb, taps, nch, L, M, phi0m1, base, out_len, lanes,
        k, span, tiles, y);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// hist (hl,) or null, x (n,), pfb (taps, L), y (out_len,): float32,
// contiguous.  phi0m1 = phi0 - 1 in [0, L).  The wrapper chooses the
// geometry (kernels/pfb2.py, _launch_geometry): nt taps a pass (8, 16,
// ..., 64) in nch passes, `lanes` columns a warp, `warps` a block, k L
// outputs a row and the span a tile stages (at most 48 KB; two buffers).
int dsptpu_pfb2(const void* hist, long long hl, const void* x, long long n,
                const void* pfb, int taps, int L, int M, int phi0m1,
                long long deficit, long long out_len, int nt, int nch,
                int lanes, int warps, int k, int span, void* y,
                void* stream) {
    const float* h = static_cast<const float*>(hist);
    const float* xx = static_cast<const float*>(x);
    const float* b = static_cast<const float*>(pfb);
    float* yy = static_cast<float*>(y);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long base = deficit - taps;
#define DSPTPU_PFB2_CASE(NT)                                                \
    case NT:                                                                \
        return launch<NT>(h, hl, xx, n, b, taps, nch, L, M, phi0m1, base,   \
                          out_len, lanes, warps, k, span, yy, st);
    switch (nt) {
        DSPTPU_PFB2_CASE(8)
        DSPTPU_PFB2_CASE(16)
        DSPTPU_PFB2_CASE(24)
        DSPTPU_PFB2_CASE(32)
        DSPTPU_PFB2_CASE(40)
        DSPTPU_PFB2_CASE(48)
        DSPTPU_PFB2_CASE(56)
        DSPTPU_PFB2_CASE(64)
        default:
            return cudaErrorInvalidValue;
    }
#undef DSPTPU_PFB2_CASE
}

}  // extern "C"

// K8a-c: the layout kernels of dsptpu/kernels/transpose.py.
//
// Replaces transpose2d_pallas (:51), transpose_tall_pallas (:147) and
// spectro_permute_pallas (:193).  A transpose moves data and does no
// arithmetic, so every output equals its input element bit for bit.
//
//   * K8a, transpose2d:   out (N, M) = x (M, N) transposed.
//   * K8b, transpose_tall: out (C, L)[c][t] = x (M, C)[t][c] for t < M,
//     0 for M <= t < L (the zero padding is written by the kernel).
//   * K8c, spectro_permute: out (l2, N1, nb*TB, C)[k2][k1][b*TB + t][c]
//     = tile (C, nb, N1, TB, 128)[c][b][k1][t][k2] for k2 < l2.
//
// K8a is K8b with L = M, so both launch one tiled transpose: a block
// reads a 32 x 32 tile, rows along the input's contiguous axis, into
// shared memory with one padding column (a column read then touches 32
// banks, no conflicts), and writes it back along the output's contiguous
// axis, 32 threads by 8 rows, each thread four elements.  The TPU
// kernels' (TT, TT) padding and row-block tiling are not carried over.
// K8c stages a block of (frames x channels x bins) in shared memory and
// writes each bin's contiguous run (below, at permute_kernel).
//
// Bound on an H100: the bytes, each input element read once and each
// output element written once, at 3.35 TB/s.  Device time with the L2
// flushed before each call (torch.profiler, tools/k8_ab.py; NVIDIA H100
// 80GB HBM3, 700.00 W), at chip_smoke.py's K8 shapes: K8a 0.0334-0.0340
// ms for (3000, 3500), bound 0.0251; K8b 0.186-0.189 ms for (1,000,000,
// 64) -> (64, 1,007,616), bound 0.1534; K8c 0.224 ms for (64, 8, 8, 256,
// 128) at l2 65, bound 0.1628 (the 32 x 32 tile a block it replaced:
// 0.368-0.370).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;

// out[j][i] = i < M ? x[i][j] : 0 for i < L, j < N.  Tiles are numbered
// along the rows of x first: tile b covers rows (b / tj) * 32 and
// columns (b % tj) * 32, tj = ceil(N / 32).
__global__ void __launch_bounds__(kTile * kRows)
transpose_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long M, int N, long long L, int tj) {
    __shared__ float tile[kTile][kTile + 1];
    const long long i0 = (long long)(blockIdx.x / tj) * kTile;
    const int j0 = (blockIdx.x % tj) * kTile;
    const int tx = threadIdx.x, ty = threadIdx.y;
    for (int r = ty; r < kTile; r += kRows) {
        const long long i = i0 + r;
        const int j = j0 + tx;
        tile[r][tx] = (i < M && j < N) ? x[i * N + j] : 0.f;
    }
    __syncthreads();
    for (int r = ty; r < kTile; r += kRows) {
        const int j = j0 + r;
        const long long i = i0 + tx;
        if (j < N && i < L) out[(long long)j * L + i] = tile[tx][r];
    }
}

// K8c.  A block takes one (b, k1), a run of T frames t0 .. t0 + T and a
// chunk of channels c0 .. c0 + CC (all of them unless C * l2 is large).
// Its input is CC x T rows of the tile, each the first l2 bins of a
// 512-byte row, and its output is, for each k2 < l2, T runs of CC
// floats that lie back to back when CC = C: out[k2][k1][b*TB + t][c].
// The block stages it in shared memory as s[k][f], f = t * Cn + c (Cn
// the block's channels), one
// row of P floats (a multiple of 32) a bin, with f's bits 2-4 XORed by
// bits 2-4 of k: float (k, f) sits at k * P + (f ^ swz(k)), swz(k) =
// (k & 28).  The XOR keeps groups of 4 f together and permutes them
// within each group of 32.
//
// Phase 1: each warp reads 4 rows f0 .. f0 + 3 (f0 % 4 = 0), 8 lanes a
// row, each lane 16 bytes (bins 4 k4 .. 4 k4 + 3, k4 = 8 kl + lane % 8):
// a whole 128-byte line of each row.  Bins past l2 up to the next
// multiple of 4 are read too, within the 512-byte row.  A lane stores
// its 4 floats transposed, one bin row each; the four rows of the warp
// differ in f's bits 0-1 and the 8 lanes of a row in k's bits 2-4, so
// the 32 stores of each bin row land in 32 different banks.
// Phase 2: each bin row goes out with 16-byte loads and stores in order:
// a warp's stores are whole 128-byte lines of one bin's run, and its
// shared loads are conflict-free (the XOR permutes float4s within 32
// floats).
// Loads go through registers: staging the same lines by cp.async (into
// 16-byte slots in input order, gathered transposed in phase 2) took
// 0.283 ms against 0.224 at the K8 shape, and a lane pair a row reading
// one 32-byte sector each (16 rows a load) 0.265 (tools/k8_ab.py, NVIDIA
// H100 80GB HBM3, 700.00 W).
// Ragged edges (the last run of frames, the last channel chunk, bins
// past l2) stay inside the block.  An input whose rows are not 16-byte
// aligned (a view with a storage offset) is read one float a thread
// along the bins; a C that is not a multiple of 4 is written one float a
// thread.  Offsets into the tile and the output are 64-bit.
constexpr int kPermThreads = 256;
constexpr int kPermFloats = 12288;      // staged floats a block: 48 KB
constexpr int kPermLoads = 4;           // 16-byte loads in flight a thread

__device__ __forceinline__ int swz(int k) { return k & 28; }

template <bool VecIn, bool VecOut>
__global__ void __launch_bounds__(kPermThreads)
permute_kernel(const float* __restrict__ in, float* __restrict__ out, int C,
               int nb, int N1, int TB, int l2, int T, int CC, int nt,
               int nc) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    int blk = blockIdx.x;
    const int cj = blk % nc;
    blk /= nc;
    const int tr = blk % nt;
    blk /= nt;
    const int k1 = blk % N1, b = blk / N1;
    const int t0 = tr * T, c0 = cj * CC;
    const int Tn = min(T, TB - t0), Cn = min(CC, C - c0);
    const int S = Tn * Cn;                  // floats of one bin's output
    const int P = (S + 31) / 32 * 32;       // its row in s
    const long long plane = (long long)nb * N1 * TB * 128;
    // tile[c0 + c][b][k1][t0 + t][k] at src + c * plane + t * 128 + k
    const float* src = in + (long long)c0 * plane +
                       (((long long)b * N1 + k1) * TB + t0) * 128;
    if (VecIn) {
        const int nk4 = (l2 + 3) / 4, nkl = (nk4 + 7) / 8;
        const int items = (S + 3) / 4 * nkl * 32;
        const int lane = threadIdx.x % 32;
        for (int u0 = threadIdx.x; u0 < items;
             u0 += kPermLoads * kPermThreads) {
            float4 q[kPermLoads];
            int at[kPermLoads];
#pragma unroll
            for (int r = 0; r < kPermLoads; ++r) {
                const int i = (u0 + r * kPermThreads) / 32;
                const int rg = i / nkl, kl = i - rg * nkl;
                const int f = 4 * rg + lane / 8, k4 = 8 * kl + lane % 8;
                at[r] = -1;
                if (i * 32 < items && f < S && k4 < nk4) {
                    const int t = f / Cn, c = f - t * Cn;
                    q[r] = *reinterpret_cast<const float4*>(
                        src + c * plane + t * 128 + 4 * k4);
                    at[r] = 4 * k4 * P + (f ^ swz(4 * k4));
                }
            }
#pragma unroll
            for (int r = 0; r < kPermLoads; ++r) {
                if (at[r] >= 0) {
                    float* d = s + at[r];
                    d[0] = q[r].x;
                    d[P] = q[r].y;
                    d[2 * P] = q[r].z;
                    d[3 * P] = q[r].w;
                }
            }
        }
    } else {
        const int items = S * l2;
        for (int u = threadIdx.x; u < items; u += kPermThreads) {
            const int f = u / l2, k = u - f * l2;
            const int t = f / Cn, c = f - t * Cn;
            s[k * P + (f ^ swz(k))] = src[c * plane + t * 128 + k];
        }
    }
    __syncthreads();
    const long long kstride = (long long)N1 * nb * TB * C;   // per k2
    // out[k2][k1][b*TB + t0 + t][c0 + c] at dst + k2 * kstride + t * C + c
    float* dst = out + (((long long)k1 * nb + b) * TB + t0) * C + c0;
    if (VecOut) {
        const int n4 = Cn / 4, S4 = S / 4;
        const int items = l2 * S4;
        for (int u = threadIdx.x; u < items; u += kPermThreads) {
            const int k = u / S4, w = u - k * S4;
            const int t = w / n4, c4 = w - t * n4;
            *reinterpret_cast<float4*>(dst + k * kstride + t * C + 4 * c4) =
                *reinterpret_cast<const float4*>(s + k * P +
                                                 ((4 * w) ^ swz(k)));
        }
    } else {
        const int items = l2 * S;
        for (int u = threadIdx.x; u < items; u += kPermThreads) {
            const int k = u / S, f = u - k * S;
            const int t = f / Cn, c = f - t * Cn;
            dst[k * kstride + t * C + c] = s[k * P + (f ^ swz(k))];
        }
    }
}

template <bool VecIn, bool VecOut>
cudaError_t launch_permute(const float* in, float* out, int C, int nb,
                           int N1, int TB, int l2, int T, int CC, int nt,
                           int nc, long long blocks, size_t smem,
                           cudaStream_t st) {
    auto kern = permute_kernel<VecIn, VecOut>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e) return e;
    }
    kern<<<(unsigned)blocks, kPermThreads, smem, st>>>(
        in, out, C, nb, N1, TB, l2, T, CC, nt, nc);
    return cudaGetLastError();
}

cudaError_t launch_transpose(const void* x, void* out, long long M, int N,
                             long long L, void* stream) {
    if (M < 1 || N < 1 || L < M) return cudaErrorInvalidValue;
    const int tj = (N + kTile - 1) / kTile;
    const long long blocks = (L + kTile - 1) / kTile * tj;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    transpose_kernel<<<(unsigned)blocks, dim3(kTile, kRows), 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), M, N, L, tj);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (M, N) float32; out: (N, M).
int dsptpu_transpose2d(const void* x, void* out, long long M, int N,
                       void* stream) {
    return launch_transpose(x, out, M, N, M, stream);
}

// x: (M, C) float32; out: (C, L), L >= M, zero from column M on.
int dsptpu_transpose_tall(const void* x, void* out, long long M, int C,
                          long long L, void* stream) {
    return launch_transpose(x, out, M, C, L, stream);
}

// in: (C, nb, N1, TB, 128) float32; out: (l2, N1, nb * TB, C), l2 <= 128.
int dsptpu_spectro_permute(const void* in, void* out, int C, int nb, int N1,
                           int TB, int l2, void* stream) {
    if (C < 1 || nb < 1 || N1 < 1 || TB < 1 || l2 < 1 || l2 > 128)
        return cudaErrorInvalidValue;
    // the block's tile: every channel and T frames while C x l2p floats
    // fit in kPermFloats, else one frame and nc chunks of CC channels
    // (a multiple of 4) of about equal size
    const int l2p = (l2 + 3) / 4 * 4;
    int T = 1, CC = C;
    if ((long long)C * l2p <= kPermFloats) {
        T = min(TB, kPermFloats / (C * l2p));
    } else {
        const long long parts = ((long long)C * l2p + kPermFloats - 1) /
                                kPermFloats;
        CC = (int)((C + parts - 1) / parts + 3) / 4 * 4;
    }
    const int nt = (TB + T - 1) / T, nc = (C + CC - 1) / CC;
    const long long blocks = (long long)nb * N1 * nt * nc;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const size_t smem = (size_t)l2p * ((T * CC + 31) / 32 * 32) * 4;
    const bool vin = reinterpret_cast<unsigned long long>(in) % 16 == 0;
    const bool vout = C % 4 == 0 &&
                      reinterpret_cast<unsigned long long>(out) % 16 == 0;
    const float* x = static_cast<const float*>(in);
    float* y = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vin && vout)
        return launch_permute<true, true>(x, y, C, nb, N1, TB, l2, T, CC,
                                          nt, nc, blocks, smem, st);
    if (vin)
        return launch_permute<true, false>(x, y, C, nb, N1, TB, l2, T, CC,
                                           nt, nc, blocks, smem, st);
    if (vout)
        return launch_permute<false, true>(x, y, C, nb, N1, TB, l2, T, CC,
                                           nt, nc, blocks, smem, st);
    return launch_permute<false, false>(x, y, C, nb, N1, TB, l2, T, CC, nt,
                                        nc, blocks, smem, st);
}

}  // extern "C"

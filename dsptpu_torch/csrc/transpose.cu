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
// K8c is a batch of C x l2 transposes, one per (b, k1, t) row: a block
// takes one row and a 32 x 32 tile of (c, k2) the same way.
//
// Bound on an H100: the bytes, each input element read once and each
// output element written once, at 3.35 TB/s; both streams are
// coalesced in 128-byte rows.

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

// One row q = (b * N1 + k1) * TB + t per blockIdx.x, a (c, k2) tile per
// (blockIdx.z, blockIdx.y).  tile[c][q][k2] sits at c * nq * 128 +
// q * 128 + k2 with nq = nb * N1 * TB.
__global__ void __launch_bounds__(kTile * kRows)
permute_kernel(const float* __restrict__ in, float* __restrict__ out, int C,
               int N1, int TB, long long nq, int l2) {
    __shared__ float tile[kTile][kTile + 1];
    const long long q = blockIdx.x;
    const int k20 = blockIdx.y * kTile;
    const int c0 = blockIdx.z * kTile;
    const int tx = threadIdx.x, ty = threadIdx.y;
    for (int r = ty; r < kTile; r += kRows) {
        const int c = c0 + r, k2 = k20 + tx;
        tile[r][tx] = (c < C && k2 < l2) ? in[(c * nq + q) * 128 + k2] : 0.f;
    }
    __syncthreads();
    const long long rows = nq / N1;               // nb * TB frames
    const long long bt = q / ((long long)N1 * TB) * TB + q % TB;
    const int k1 = (int)((q / TB) % N1);
    for (int r = ty; r < kTile; r += kRows) {
        const int k2 = k20 + r, c = c0 + tx;
        if (k2 < l2 && c < C)
            out[(((long long)k2 * N1 + k1) * rows + bt) * C + c] = tile[tx][r];
    }
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
    const long long nq = (long long)nb * N1 * TB;
    if (nq > 0x7fffffffLL || C > 65535 * kTile) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)nq, (l2 + kTile - 1) / kTile,
                    (C + kTile - 1) / kTile);
    permute_kernel<<<grid, dim3(kTile, kRows), 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(in), static_cast<float*>(out), C, N1, TB,
        nq, l2);
    return cudaGetLastError();
}

}  // extern "C"

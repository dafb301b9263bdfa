// K1: causal FIR, y[t, c] = sum_k b[k] x[t - k, c], zero initial state,
// per channel of a time-major (n, C) float32 signal (no transpose on the
// way in or out).
//
// Replaces dsptpu/kernels/fir.py:fir_pallas (Pallas `_kernel`, :77), a
// banded matmul on the TPU's matrix unit.  Only what it computes is
// ported, not its geometry.
//
// Bound on an H100: 2 * nb flops per output in f32 on the CUDA cores
// (67 TFLOP/s) against 8 bytes per sample of HBM traffic (3.35 TB/s): at
// 127 taps the arithmetic bounds it, by about 8x.  So the instruction slots of
// the four schedulers of an SM have to go to FFMAs, fed from registers.
// The design (CUDA cores, full f32, accumulation tap by tap in ascending
// order):
//   * each thread owns R = 16 consecutive outputs of V adjacent channels
//     (V = 2, or 1 at C = 1).  For tap k it needs the window x[T0 - k + j],
//     j < R: as k rises by one the window moves down one sample, so a tap
//     costs one new sample per channel (a float2 shared load) and R V
//     FFMAs.  Taps go in chunks of R with two register arrays, `cur` (the
//     segment of rows T0 - k0 + i) and `nxt` (rows T0 - k0 - R + i, loaded
//     one row per tap as the window reaches it); the chunk loop is unrolled
//     by two so that the arrays swap roles with no register moves, and
//     every register index is a compile-time constant (full unrolling: no
//     stack frame);
//   * the taps are the same for every channel and are read from shared
//     memory as float4 broadcasts, one load per 4 taps; with the sample
//     load that is 1.25 shared loads per 32 FFMAs at V = 2, and FFMAs are
//     95% of the inner loop's instructions (SASS of the CW = 32 template:
//     1024 FFMAs, 32 LDS.64, 8 LDS.128 and 12 others per two chunks);
//   * a block of 256 threads takes CW = V * NCL channels (NCL threads per
//     time row, CW a power of two up to 32, fewer for long taps so that
//     the ring fits) and TT = (256 / NCL) * R output times a tile.  Blocks
//     are persistent: one wave (SMs x occupancy, from the wrapper) walks
//     the (channel group, run) pairs, and each block walks a contiguous run
//     of tiles of its group;
//   * the block keeps its input in a ring in shared memory of nbp + 2 TT
//     rows (nbp: taps padded with zeros to a multiple of 2R), in segments
//     of R rows.  The last nbp rows of a tile stay there as the next
//     tile's history, so a run loads its history once; the next tile is
//     staged with cp.async while the current one computes, one barrier per
//     tile: 16-byte copies where C is a multiple of 4 (4 bytes otherwise),
//     zero fill outside [0, n) x [0, C), a thread keeping one column;
//   * a segment is R rows of CW floats plus CW floats of padding when
//     CW < 32, so that the time lanes of one shared-memory wavefront fall on
//     distinct banks (at C = 1 a warp's lanes are 17 floats apart); at
//     CW = 32 a half-warp reads one 128-byte row.  At C = 1 a warp stages
//     a contiguous span of the stream;
//   * outputs go from registers straight to device memory (float2 stores
//     when C is even); at C = 1 through a small shared buffer per warp,
//     so that a warp's stores cover 128 contiguous bytes each.
// What bounds it as built: the schedulers' FFMA rate, and the stalls between
// FFMAs.  Registers cap occupancy at two blocks (16 warps) an SM, and so
// does the ring at 127 taps (82 KB a block).  Final build (nvcc -Xptxas -v,
// sm_90a): 127 registers for every V = 2 template, 114 for V = 1, a
// 0-byte stack frame and no spills in all six.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int R = 16;   // outputs a thread, rows a ring segment
constexpr int kOutWarp = 32 * (R + 1);   // V = 1 output staging, a warp

// W floats (4 or 16 bytes) from global to shared memory, asynchronously;
// zeros where !valid
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

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int V>
__device__ __forceinline__ void lds(const float* p, float (&w)[V]) {
    if constexpr (V == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        w[0] = v.x;
        w[1] = v.y;
    } else {
        w[0] = *p;
    }
}

// One chunk of R taps (h[0..R) = b[k0..k0+R)).  cur[i] holds x at time
// T0 - k0 + i, nxt receives x at T0 - k0 - R + i from the segment `seg`,
// so that x[T0 + j - k0 - kk] is cur[j - kk] for j >= kk and
// nxt[R - kk + j] below.
template <int V, int CW>
__device__ __forceinline__ void chunk(float (&acc)[R][V],
                                      const float (&cur)[R][V],
                                      float (&nxt)[R][V],
                                      const float* __restrict__ h,
                                      const float* __restrict__ seg) {
    float4 h4;
#pragma unroll
    for (int kk = 0; kk < R; ++kk) {
        if ((kk & 3) == 0) h4 = *reinterpret_cast<const float4*>(h + kk);
        const float hk = (kk & 3) == 0 ? h4.x : (kk & 3) == 1 ? h4.y
                       : (kk & 3) == 2 ? h4.z : h4.w;
        if (kk > 0) lds<V>(seg + (R - kk) * CW, nxt[R - kk]);
#pragma unroll
        for (int j = 0; j < R; ++j)
#pragma unroll
            for (int v = 0; v < V; ++v)
                acc[j][v] = fmaf(hk, j >= kk ? cur[j - kk][v]
                                             : nxt[R - kk + j][v],
                                 acc[j][v]);
    }
    lds<V>(seg, nxt[0]);
}

// floats a ring segment: R rows of cw floats, padded below cw = 32
__host__ __device__ constexpr int sseg_of(int cw) {
    return R * cw + (cw < 32 ? cw : 0);
}

// Ring row r holds x at time tbase + r; segment slot s holds rows
// r = R q + i with q = s (mod nseg), element (i, col) at s*SSEG + i*CW + col.
// Stage rows [r0, r0 + rows) (r0 a multiple of R, rows at most nseg R),
// t0 = tbase + r0, starting at slot slot0, W floats a copy: a thread keeps
// one column and steps down the rows.
template <int CW, int W>
__device__ __forceinline__ void stage(float* ring, const float* x,
                                      long long n, int C, int cbase,
                                      long long t0, int slot0, int nseg,
                                      int rows, int tid) {
    constexpr int kPerRow = CW / W;                // copies a row
    constexpr int SSEG = sseg_of(CW);
    const int col = tid % kPerRow * W;
    const bool cok = cbase + col < C;
    const float* xc = x + cbase + col;
    for (int r = tid / kPerRow; r < rows; r += kThreads / kPerRow) {
        int slot = slot0 + r / R;
        if (slot >= nseg) slot -= nseg;
        const long long t = t0 + r;
        const bool ok = cok && t >= 0 && t < n;
        cp_async<W>(ring + slot * SSEG + r % R * CW + col,
                    ok ? xc + t * C : x, ok);
    }
    cp_async_commit();
}

template <int V, int NCL>
__global__ void __launch_bounds__(kThreads, 2)
fir_kernel(const float* __restrict__ x, const float* __restrict__ taps,
           float* __restrict__ y, long long n, int C, int nb, int nbp,
           int nseg, long long ntiles, int runs, bool vec) {
    constexpr int CW = V * NCL;
    constexpr int TT = kThreads / NCL * R;
    constexpr int SSEG = sseg_of(CW);
    extern __shared__ float4 smem4[];
    float* hs = reinterpret_cast<float*>(smem4);   // nbp taps, zero past nb
    float* ring = hs + nbp;                        // nseg * SSEG floats
    float* obuf = ring + nseg * SSEG;              // V = 1: kOutWarp a warp
    const int tid = threadIdx.x;
    const int cbase = (blockIdx.x / runs) * CW;
    const int run = blockIdx.x % runs;
    const long long tile0 = ntiles * run / runs;
    const long long tile1 = ntiles * (run + 1) / runs;
    const long long tbase = tile0 * TT - nbp;

    for (int k = tid; k < nbp; k += kThreads) hs[k] = k < nb ? taps[k] : 0.f;

    // 16-byte copies where rows of the group are 16-byte aligned
    auto stage_rows = [&](long long r0, int rows) {
        const int slot0 = static_cast<int>((r0 / R) % nseg);
        if constexpr (CW >= 4) {
            if (vec) {
                stage<CW, 4>(ring, x, n, C, cbase, tbase + r0, slot0, nseg,
                             rows, tid);
                return;
            }
        }
        stage<CW, 1>(ring, x, n, C, cbase, tbase + r0, slot0, nseg, rows,
                     tid);
    };

    stage_rows(0, nbp + TT);
    const int tl = tid / NCL;
    const float* lane = ring + V * (tid % NCL);
    const int c = cbase + V * (tid % NCL);
    for (long long it = tile0; it < tile1; ++it) {
        cp_async_wait_all();
        __syncthreads();
        const long long rtile = nbp + (it - tile0) * TT;
        if (it + 1 < tile1) stage_rows(rtile + TT, TT);

        const long long rme = rtile + tl * R;
        int s = static_cast<int>((rme / R) % nseg);
        float acc[R][V], cur[R][V], nxt[R][V];
#pragma unroll
        for (int j = 0; j < R; ++j) {
            lds<V>(lane + s * SSEG + j * CW, cur[j]);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[j][v] = 0.f;
        }
        for (int k0 = 0; k0 < nbp; k0 += 2 * R) {
            s = s == 0 ? nseg - 1 : s - 1;
            chunk<V, CW>(acc, cur, nxt, hs + k0, lane + s * SSEG);
            s = s == 0 ? nseg - 1 : s - 1;
            chunk<V, CW>(acc, nxt, cur, hs + k0 + R, lane + s * SSEG);
        }

        if constexpr (V == 1) {
            // a warp's 32 lanes own 512 consecutive outputs: through
            // shared memory (17 floats a lane), so that each store
            // instruction writes 128 contiguous bytes
            float* ob = obuf + (tid / 32) * kOutWarp;
            const int wl = tid % 32;
#pragma unroll
            for (int j = 0; j < R; ++j) ob[wl * (R + 1) + j] = acc[j][0];
            __syncwarp();
            const long long tw = tbase + rtile + (tid / 32) * 32 * R;
#pragma unroll
            for (int q = 0; q < R; ++q) {
                const int m = wl + 32 * q;
                if (tw + m < n) y[tw + m] = ob[m / R * (R + 1) + m % R];
            }
        } else if (c < C) {
            const long long t0 = tbase + rme;
            const bool pair = (C & 1) == 0;
#pragma unroll
            for (int j = 0; j < R; ++j) {
                if (t0 + j < n) {
                    float* p = y + (t0 + j) * C + c;
                    if (pair) {
                        *reinterpret_cast<float2*>(p) =
                            make_float2(acc[j][0], acc[j][1]);
                    } else {
                        p[0] = acc[j][0];
                        if (c + 1 < C) p[1] = acc[j][1];
                    }
                }
            }
        }
    }
}

using Kernel = void (*)(const float*, const float*, float*, long long, int,
                        int, int, int, long long, int, bool);

Kernel kernel_of(int cw) {
    switch (cw) {
        case 1: return fir_kernel<1, 1>;
        case 2: return fir_kernel<2, 1>;
        case 4: return fir_kernel<2, 2>;
        case 8: return fir_kernel<2, 4>;
        case 16: return fir_kernel<2, 8>;
        case 32: return fir_kernel<2, 16>;
        default: return nullptr;
    }
}

}  // namespace

extern "C" {

const char* dsptpu_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Resident blocks per SM of the kernel for cw channels a block at smem
// bytes of dynamic shared memory.
int dsptpu_fir_blocks_per_sm(int cw, int smem, int* blocks) {
    const Kernel k = kernel_of(cw);
    if (!k) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads,
                                                         smem);
}

// x, y: (n, C) float32, contiguous; taps: (nb,) float32.  The plan comes
// from kernels/fir.py:_plan: cw channels a block, nbp padded taps, nseg
// ring segments, ntiles tiles of the time axis, runs blocks per channel
// group, smem bytes.
int dsptpu_fir(const void* x, const void* taps, void* y, long long n, int C,
               int nb, int nbp, int cw, int nseg, long long ntiles, int runs,
               int smem, void* stream) {
    const Kernel k = kernel_of(cw);
    if (!k || nbp % (2 * R) || nbp < nb || runs < 1 || C < 1 || n < 1)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const unsigned groups = static_cast<unsigned>((C + cw - 1) / cw);
    const bool vec = cw >= 4 && C % 4 == 0 &&
                     reinterpret_cast<unsigned long long>(x) % 16 == 0;
    k<<<groups * runs, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(taps),
        static_cast<float*>(y), n, C, nb, nbp, nseg, ntiles, runs, vec);
    return cudaGetLastError();
}

}  // extern "C"

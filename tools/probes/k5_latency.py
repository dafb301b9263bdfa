"""K5 probe: the latencies that bound the Levinson kernel's chain, timed
on the card by clock64() in one thread, for the latency bound of K5's
row in PERF.md:

  * fma: cycles of one float32 FMA in a dependent chain of 4096;
  * div: cycles of one IEEE float32 division (`x / y`, no fast-math, as
    the kernel divides) in a dependent chain of 1024;
  * dram_4k, dram_1m: cycles of one load in a dependent chase of 2048
    hops, 4224 or 1,048,704 bytes apart, over a 256 MB buffer that no
    earlier hop touched (each hop misses the 50 MB L2);
  * sm_mhz: the SM clock, 200,000,000 cycles of torch.cuda._sleep over
    their CUDA-event time, turns cycles into nanoseconds (nvidia-smi's
    clocks.sm and clocks.max.sm are printed beside it);
  * empty: device time of an empty kernel of 20 blocks of 128 threads by
    torch.profiler over 100 launches (the floor of any launch's device
    record).

Builds its source into build/probe/k5lat/ with nvcc (the flags of
dsptpu_torch/kernels/_build.py) and prints one JSON line.

    python3 tools/probes/k5_latency.py
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
OUT = os.path.join(ROOT, "build", "probe", "k5lat")

SRC = r'''
#include <cuda_runtime.h>
__global__ void fma_chain(float* out, long long* cyc, float y, float z) {
    float x = out[0];
    long long t0 = clock64();
#pragma unroll 64
    for (int i = 0; i < 4096; ++i) x = fmaf(x, y, z);
    long long t1 = clock64();
    out[0] = x;
    cyc[0] = t1 - t0;
}
__global__ void div_chain(float* out, long long* cyc, float y) {
    float x = out[0];
    long long t0 = clock64();
#pragma unroll 16
    for (int i = 0; i < 1024; ++i) x = y / x;
    long long t1 = clock64();
    out[0] = x;
    cyc[0] = t1 - t0;
}
__global__ void chase(const long long* buf, long long* cyc, long long start,
                      int hops) {
    long long i = start;
    long long t0 = clock64();
    for (int h = 0; h < hops; ++h) i = buf[i];
    long long t1 = clock64();
    cyc[0] = t1 - t0;
    cyc[1] = i;
}
__global__ void empty() {}
extern "C" {
int probe_fma(void* out, void* cyc) {
    fma_chain<<<1, 1>>>((float*)out, (long long*)cyc, 0.999f, 0.001f);
    return cudaGetLastError();
}
int probe_div(void* out, void* cyc) {
    div_chain<<<1, 1>>>((float*)out, (long long*)cyc, 1.25f);
    return cudaGetLastError();
}
int probe_chase(void* buf, void* cyc, long long start, int hops) {
    chase<<<1, 1>>>((const long long*)buf, (long long*)cyc, start, hops);
    return cudaGetLastError();
}
int probe_empty(void* stream) {
    empty<<<20, 128, 0, (cudaStream_t)stream>>>();
    return cudaGetLastError();
}
}
'''


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("k5_latency: CUDA is not available")
    sys.path.insert(0, ROOT)
    from dsptpu_torch.kernels import _build
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, "lat.cu"), os.path.join(OUT, "liblat.so")
    open(cu, "w").write(SRC)
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", so, cu],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for f in (lib.probe_fma, lib.probe_div):
        f.argtypes = [ctypes.c_void_p] * 2
    lib.probe_chase.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_longlong, ctypes.c_int]
    lib.probe_empty.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    out = torch.ones(1, device=dev)
    cyc = torch.zeros(2, dtype=torch.int64, device=dev)
    res = {}
    for name, call, n in [("fma", lambda: lib.probe_fma(out.data_ptr(),
                                                        cyc.data_ptr()), 4096),
                          ("div", lambda: lib.probe_div(out.data_ptr(),
                                                        cyc.data_ptr()), 1024)]:
        best = None
        for _ in range(5):
            assert call() == 0
            torch.cuda.synchronize()
            c = cyc[0].item() / n
            best = c if best is None else min(best, c)
        res[f"{name}_cycles"] = best
    n = 32 << 20                                    # 256 MB of int64
    hops = 2048
    for name, stride in [("dram_4k", 4224 // 8), ("dram_1m", 1_048_704 // 8)]:
        idx = torch.arange(n, device=dev, dtype=torch.int64)
        buf = (idx + stride) % n
        del idx
        best = None
        for rep in range(3):
            torch.empty(32 << 20, device=dev).zero_()     # flush the L2
            torch.cuda.synchronize()
            # start where no earlier run went
            assert lib.probe_chase(buf.data_ptr(), cyc.data_ptr(),
                                   rep * 97 * 16, hops) == 0
            torch.cuda.synchronize()
            c = cyc[0].item() / hops
            best = c if best is None else min(best, c)
        res[f"{name}_cycles"] = best
        del buf
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    res["nvidia_smi_name_limit_sm_maxsm"] = smi
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(200_000_000)
    b.record()
    b.synchronize()
    res["sm_mhz"] = 200_000_000 / a.elapsed_time(b) / 1e3
    st = torch.cuda.current_stream().cuda_stream
    lib.probe_empty(st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000)
        for _ in range(100):
            lib.probe_empty(st)
        torch.cuda.synchronize()
    res["empty_kernel_device_ms"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and "empty" in e.key) / 1e3 / 100
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

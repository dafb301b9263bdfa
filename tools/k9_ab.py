#!/usr/bin/env python3
"""Path D's coherence stage at the shape of `multitaper64.block1m`, for the
dsptpu_torch package under ROOT (default: this checkout):

    python3 tools/k9_ab.py [ROOT]

Builds ROOT's kernels, then on the card: `mt_coherence` of the first
16,384 rows of multitaper_entry()'s 1,000,000 x 64 float32 stream (7
DPSS tapers, nfft 16,384, 8,193 bins) by CUDA events (10 calls back to
back) and by device time per kernel (torch.profiler over 10 calls), the
peak memory it allocates above what it was given, and multitaper_entry()
end to end (events, device time, and the host's self time a call in
each of its spans under torch.profiler, as the benchmark's traced run
reads them). Where ROOT has K9 (kernels/mtcoh.py):
K9 alone on the stage's tapered spectra (events, device time), its plain
version (the einsum and coherence_from_cs: the library yardstick), K9
against that and against the float64 call, and mtcoh.cu's `-Xptxas -v`
lines. Prints the card (nvidia-smi name and power limit) and one JSON
line. To compare two checkouts, run it on both in one call, in the order
parent, change, change, parent.
"""

import json

from ab_common import device_ms_by_kernel, open_root, ptxas_lines, time_ms


def self_ms(forward, x, calls=100):
    """{span: mean host self ms a call} of `calls` calls of forward(x)
    under torch.profiler recording the device alone, as the benchmark's
    traced run profiles them (its `mt_host_ms` sums some of these)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dsptpu_torch import kernels
    from dsptpu_torch.utils import profiling
    forward(x)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(calls):
            forward(x)
        torch.cuda.synchronize()
    return {k: 1e3 * v for k, v in profiling.self_times(calls).items()}


def main():
    import torch
    root = open_root("k9_ab")
    import dsptpu_torch
    from dsptpu_torch import kernels

    forward, (x,) = dsptpu_torch.multitaper_entry(device="cuda")
    coh_n = 16384
    cfg = dsptpu_torch.MTCoherenceConfig.create(
        x.shape[1], mt_config=dsptpu_torch.MTConfig.create(
            coh_n, nfft=coh_n, nw=4, ntapers=7))
    s = x[:coh_n].T

    def stage():
        return dsptpu_torch.mt_coherence(s, config=cfg).coherence

    res = {"root": root}
    stage()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = stage()
    torch.cuda.synchronize()
    res["stage_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    res["stage_ms"] = time_ms(stage, reps=10, warmup=2, inner=10)
    res["stage_device"] = device_ms_by_kernel(stage, calls=10)
    res["stage_device_ms"] = sum(res["stage_device"].values())
    want = dsptpu_torch.mt_coherence(s.double(), config=cfg).coherence
    res["stage_vs_f64"] = (got.double() - want).abs().max().item()
    del got, want

    if hasattr(kernels, "mtcoh"):
        from dsptpu_torch.kernels import mtcoh
        from dsptpu_torch.ops.multitaper import _tapered_fft
        mtc = cfg.cs_config.mt_config
        F = _tapered_fft(s, mtc)
        w = mtc.const("w2", F.device, torch.float32)
        corr = mtc.const("corr", F.device, torch.float32)
        res["ptxas"] = ptxas_lines("mtcoh")
        res["k9_ms"] = time_ms(lambda: mtcoh.mtcoh(F, w, corr), reps=10,
                               warmup=2, inner=10)
        res["k9_device"] = device_ms_by_kernel(
            lambda: mtcoh.mtcoh(F, w, corr), calls=10)
        res["plain_ms"] = time_ms(lambda: mtcoh.mtcoh_reference(F, w, corr),
                                  reps=5, warmup=1)
        k9 = mtcoh.mtcoh(F, w, corr)
        ref = mtcoh.mtcoh_reference(F, w, corr)
        torch.cuda.synchronize()
        res["k9_vs_plain"] = (k9 - ref).abs().max().item()
        del k9, ref, F

    torch.cuda.empty_cache()
    res["path_d_self_ms"] = self_ms(forward, x)
    res["path_d_ms"] = time_ms(lambda: forward(x), reps=10, warmup=2)
    res["path_d_device"] = device_ms_by_kernel(lambda: forward(x), calls=10)
    res["path_d_device_ms"] = sum(res["path_d_device"].values())
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""K4's and K2's times at the shapes of the paths that run them, for the
dsptpu_torch package under ROOT (default: this checkout):

    python3 tools/k4_k2_ab.py [ROOT]

Builds ROOT's kernels, then times on the card (CUDA-event medians) K4 at
path A's shapes (16 x 10,000,000 float32, 4096 taps, nfft 16384) with
its device time by kernel (torch.profiler over 10 calls: the instance's
name shows its route), K2 forward at the main path's shapes (the
8th-order Butterworth cascade over 1,000,000 x 64, as sosfilt builds
it) and K2 forward and reverse (n_eff) at path B's (filtfilt's two
passes over the same stream; forward also with the back extension read
from its own tensor, where ROOT's K2 takes `back`), the
device time of K2's output stage in one forward call (torch.profiler:
the kernels whose name holds "output"), K2's device time per
`__global__` kernel of csrc/biir.cu in one call of each of those three
passes (so that builds with different kernels read side by side) and
their sum, and entry(), fftfilt_entry() and filtfilt_lpc_entry() end to
end, the last also by device time a call (all of it, and the
concatenation kernels') and kernel launches a call (memcpy and memset
records left out). Prints the card (nvidia-smi name and power limit), the `-Xptxas
-v` lines of biir.cu and osconv.cu and one JSON line. To compare two
checkouts, run it on both in one call, in the order parent, change,
change, parent.
"""

import importlib
import inspect
import json
import re

from ab_common import (device_by_kernel, device_ms, device_ms_by_kernel,
                       open_root, ptxas_lines, time_ms)


def k2_stages(fn):
    """K2's device ms per call by `__global__` kernel of biir.cu (the
    templates `name<P>`), and their sum under "total"."""
    ms = {k: v for k, v in device_ms_by_kernel(fn, calls=5).items()
          if re.fullmatch(r"\w+_kernel<\d+(?:, \w+)?>", k)}
    ms["total"] = sum(ms.values())
    return ms


def main():
    import numpy as np
    import torch
    root = open_root("k4_k2_ab")
    import dsptpu_torch
    from dsptpu_torch.kernels import biir, osconv
    from dsptpu_torch.ops.dspbase import optimal_os_nfft
    from dsptpu_torch.pipeline import chain_params, fftfilt_taps
    dev = torch.device("cuda")
    # the cascade's system as each package's sosfilt and filtfilt build it
    filt = importlib.import_module("dsptpu_torch.filters.filt")
    cascade = getattr(filt, "_cascade_ss", None) or (
        lambda sos, g: filt._blockss(*filt._stack_cascade(sos, g)))
    res = {"root": root}
    for source in ("biir", "osconv"):
        for line in ptxas_lines(source):
            print(f"{source} ptxas: {line}", flush=True)

    forward, (x,) = dsptpu_torch.fftfilt_entry(device="cuda")
    h = torch.as_tensor(fftfilt_taps(), device=dev)
    n = x.shape[0]
    nfft = optimal_os_nfft(n, h.shape[0])
    res["k4_ms"] = time_ms(lambda: osconv.osconv(x, h, nfft, n),
                          reps=10, warmup=2)
    res["k4_device_ms"] = device_ms_by_kernel(
        lambda: osconv.osconv(x, h, nfft, n), "osconv", calls=10)
    res["path_a_ms"] = time_ms(lambda: forward(x), reps=5, warmup=1)
    del forward, x
    torch.cuda.empty_cache()

    forward, (x,) = dsptpu_torch.entry(device="cuda")
    C = x.shape[1]
    ss = cascade(chain_params()[1].astype(np.float64), 1.0)
    z0 = torch.zeros((ss.p, C), device=dev)
    res["k2_main_ms"] = time_ms(lambda: biir.blockss_filt(ss, x, z0),
                                reps=10, warmup=2)
    res["k2_main_output_ms"] = device_ms(
        lambda: biir.blockss_filt(ss, x, z0), "output")
    res["k2_main_stages"] = k2_stages(lambda: biir.blockss_filt(ss, x, z0))
    res["main_ms"] = time_ms(lambda: forward(x), reps=5, warmup=1)
    del forward, x
    torch.cuda.empty_cache()

    forward, (x,) = dsptpu_torch.filtfilt_lpc_entry(device="cuda")
    n, C = x.shape
    f = dsptpu_torch.as_sos(dsptpu_torch.digitalfilter(
        dsptpu_torch.Lowpass(0.2), dsptpu_torch.Butterworth(8)))
    ss = cascade(f.sos_array(), f.g)
    pad = 6 * len(f.biquads)
    m = (n // 128) * 128
    xe = torch.cat([x, x[n - 1 - pad: n - 1].flip(0)], 0)
    z0 = torch.zeros((ss.p, C), device=dev)
    res["k2_b_forward_ms"] = time_ms(
        lambda: biir.blockss_filt(ss, xe, z0), reps=10, warmup=2)
    res["k2_b_forward_stages"] = k2_stages(
        lambda: biir.blockss_filt(ss, xe, z0))
    if "back" in inspect.signature(biir.blockss_filt).parameters:
        back = xe[n:].clone()
        res["k2_b_forward_back_ms"] = time_ms(
            lambda: biir.blockss_filt(ss, x, z0, back=back), reps=10,
            warmup=2)
        res["k2_b_forward_back_stages"] = k2_stages(
            lambda: biir.blockss_filt(ss, x, z0, back=back))
        del back
    y1 = biir.blockss_filt(ss, xe, z0)
    res["k2_b_reverse_ms"] = time_ms(lambda: biir.blockss_filt(
        ss, y1, z0, reverse=True, n_eff=m), reps=10, warmup=2)
    res["k2_b_reverse_output_ms"] = device_ms(
        lambda: biir.blockss_filt(ss, y1, z0, reverse=True, n_eff=m),
        "output")
    res["k2_b_reverse_stages"] = k2_stages(lambda: biir.blockss_filt(
        ss, y1, z0, reverse=True, n_eff=m))
    del xe, y1
    res["path_b_ms"] = time_ms(lambda: forward(x), reps=5, warmup=1)
    by = device_by_kernel(lambda: forward(x), calls=10)
    res["path_b_device_ms"] = sum(v[0] for v in by.values())
    res["path_b_cat_ms"] = device_ms(lambda: forward(x),
                                     "CatArrayBatchedCopy", calls=10)
    res["path_b_kernels"] = round(sum(
        v[1] for k, v in by.items() if not k.startswith(("Memcpy", "Memset"))))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

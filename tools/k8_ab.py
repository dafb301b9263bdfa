#!/usr/bin/env python3
"""K8a-c's times for the dsptpu_torch package under ROOT (default: this
checkout):

    python3 tools/k8_ab.py [ROOT]

Builds ROOT's kernels, then times on the card the three transpose
kernels at chip_smoke.py's K8 phase shapes, through their wrappers:
transpose2d of a (3000, 3500) float32 matrix, transpose_tall of
(1,000,000, 64) with TR 8192 (out (64, 1,007,616)) and spectro_permute
of a (64, 8, 8, 256, 128) tile with l2 65. For each:

  * the device time per call of the kernels whose name holds
    "transpose" (K8a, K8b) or "permute" (K8c), by torch.profiler over 10
    calls, each after a 128 MB write that flushes the 50 MB L2 (the
    number that decides: it leaves the wrapper's host time out);
  * CUDA events, median of 20 runs of 10 calls back to back, divided by
    10 (L2 not flushed);
  * bit-for-bit equality with the plain version;
  * the library call's device time, flushed the same way, by kernel
    (x.T.contiguous(), F.pad(x.T, ...) and the 5-D permute().contiguous());
  * a yardstick: the device time of one contiguous copy_ of as many
    floats as the output (a read and a write of each), flushed the same
    way: what the card's copy kernel reaches on the same bytes.

Prints the card (nvidia-smi name and power limit), the `-Xptxas -v`
lines of csrc/transpose.cu and one JSON line. To compare two checkouts,
run it on both in one call, in the order parent, change, change, parent.
"""

import json

from ab_common import device_ms_by_kernel, open_root, ptxas_lines, time_ms

FLUSH_FLOATS = 32 << 20          # 128 MB


def main():
    import torch
    import torch.nn.functional as F
    root = open_root("k8_ab")
    from dsptpu_torch.kernels import transpose as tp
    for line in ptxas_lines("transpose"):
        print(f"  transpose: {line}", flush=True)
    res = {"root": root}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(FLUSH_FLOATS, device=dev)

    a = torch.randn(3000, 3500, device=dev, generator=gen)
    n, C, TR = 1_000_000, 64, 8192
    x = torch.randn(n, C, device=dev, generator=gen)
    L = tp.tall_out_len(n, TR)
    Cp, nb, N1, TB, l2 = 64, 8, 8, 256, 65
    tile = torch.randn(Cp, nb, N1, TB, 128, device=dev, generator=gen)
    cases = [
        ("transpose2d", "transpose", lambda: tp.transpose2d(a),
         lambda: tp.transpose2d_reference(a), lambda: a.T.contiguous()),
        ("transpose_tall", "transpose", lambda: tp.transpose_tall(x, TR),
         lambda: tp.transpose_tall_reference(x, TR),
         lambda: F.pad(x.T, (0, L - n))),
        ("spectro_permute", "permute", lambda: tp.spectro_permute(tile, l2),
         lambda: tp.spectro_permute_reference(tile, l2),
         lambda: tile[..., :l2].permute(4, 2, 1, 3, 0).contiguous()),
    ]

    def flushed(fn):
        def call():
            flush.zero_()
            return fn()
        return call

    for name, kname, kern, plain, lib in cases:
        out = kern()
        want = plain()
        torch.cuda.synchronize()
        if not (out.shape == want.shape and torch.equal(out, want)):
            raise SystemExit(f"k8_ab: {name} differs from its plain version")
        res[f"{name}_exact"] = True
        src = torch.empty(out.numel(), device=dev)
        dst = torch.empty_like(src)
        del out, want
        by = device_ms_by_kernel(flushed(kern), kname, calls=10)
        res[f"{name}_device_ms_by_kernel"] = by
        res[f"{name}_device_ms"] = sum(by.values())
        res[f"{name}_events_ms"] = time_ms(kern, reps=20, warmup=3,
                                           inner=10)
        lib_by = device_ms_by_kernel(flushed(lib), "", calls=3,
                                     exclude=("FillFunctor",))
        res[f"{name}_library_device_ms_by_kernel"] = lib_by
        res[f"{name}_library_device_ms"] = sum(lib_by.values())
        res[f"{name}_copy_device_ms"] = sum(device_ms_by_kernel(
            flushed(lambda: dst.copy_(src)), "", calls=10,
            exclude=("FillFunctor",)).values())
        del src, dst
        print(f"  {name}: device {res[f'{name}_device_ms']:.4f} ms "
              f"{by}, events {res[f'{name}_events_ms']:.4f} ms, library "
              f"device {res[f'{name}_library_device_ms']:.4f} ms, copy of "
              f"the output's bytes {res[f'{name}_copy_device_ms']:.4f} ms",
              flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()

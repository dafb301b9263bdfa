"""Hand-written CUDA kernels (csrc/*.cu), one module each: K1 fir, K2
biir, K3 stft, K4 osconv, K5 levinson, K6 pfb2, K7 arbd, K8a-c
transpose (transpose2d, transpose_tall, spectro_permute) and K9 mtcoh.
Each module holds its wrappers, their plain PyTorch versions and
`launches`, a dict of launch counts keyed by kernel name."""

from . import (arbd, biir, fir, levinson, mtcoh, osconv, pfb2, stft,
               transpose)
from ..utils import profiling

# kernel name -> the module that holds it and counts its launches
KERNELS = {"fir": fir, "biir": biir, "stft": stft, "osconv": osconv,
           "levinson": levinson, "pfb2": pfb2, "arbd": arbd,
           "transpose2d": transpose, "transpose_tall": transpose,
           "spectro_permute": transpose, "mtcoh": mtcoh}


def reset_launches():
    """Zero the launch counters, and reset utils.profiling's counters and
    span ring: a window that starts here finds its calls' root spans
    first in the ring (the benchmark's device-alone profile does)."""
    for mod in KERNELS.values():
        mod.launches.update(dict.fromkeys(mod.launches, 0))
    profiling.reset()


def launch_counts():
    """Launches per kernel since the last reset; "biir_reverse" counts
    the reverse passes among biir's, "stft_fused" K3's fused launches
    (not among stft's)."""
    counts = {}
    for mod in KERNELS.values():
        counts.update(mod.launches)
    return counts

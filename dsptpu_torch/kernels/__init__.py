"""Hand-written CUDA kernels (csrc/*.cu), one module each: K1 fir, K2
biir, K3 stft, K4 osconv, K5 levinson, K6 pfb2, K7 arbd. Each holds its
wrapper, a plain PyTorch version and a launch counter."""

from . import arbd, biir, fir, levinson, osconv, pfb2, stft

KERNELS = {"fir": fir, "biir": biir, "stft": stft, "osconv": osconv,
           "levinson": levinson, "pfb2": pfb2, "arbd": arbd}


def reset_launches():
    for mod in KERNELS.values():
        mod.launches = 0
    biir.reverse_launches = 0


def launch_counts():
    """Launches per kernel module since the last reset; "biir_reverse"
    counts the reverse passes among biir's."""
    counts = {name: mod.launches for name, mod in KERNELS.items()}
    counts["biir_reverse"] = biir.reverse_launches
    return counts

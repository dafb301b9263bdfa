"""Hand-written CUDA kernels (csrc/*.cu), one module each: K1 fir, K2
biir, K3 stft. Each holds its wrapper, a plain PyTorch version and a
launch counter."""

from . import biir, fir, stft

KERNELS = {"fir": fir, "biir": biir, "stft": stft}


def reset_launches():
    for mod in KERNELS.values():
        mod.launches = 0


def launch_counts():
    return {name: mod.launches for name, mod in KERNELS.items()}

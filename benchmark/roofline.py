"""The card's peaks and the roofline bound of a call (a frozen copy of
dsptpu_torch/utils/profiling.py's peaks).

NVIDIA H100 SXM data sheet, at its 700 W power limit: HBM3 at 3.35
TB/s; float32 at 67 TFLOP/s on the CUDA cores, outside the tensor cores.
The peaks are the data sheet's, not measured; a run records the card's
power limit beside them. A stage moved onto the tensor cores at float32
accuracy (3xTF32) would run above the 67 TFLOP/s assumed here: a
`benchmark` change has to raise the compute peak before such a stage
lands, or its share would read above 100%.
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(nbytes, flops):
    """The least time a call can take: the larger of its bytes over the
    memory rate and its operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)

"""Plain reference of the `array64_chain_sharded` configuration: the
chain of `array64_chain` (the FIR and the Butterworth cascade as one
filter from rest, then the Welch PSD of the filtered block) over all
channels, on the block as one rank holds it. The configuration's output
is the PSD alone."""

from benchmark.reference import array64_chain


def reference(cfg, x, precision="float64"):
    """{"psd": (nfft//2+1, C)} of the block x (n, C) under the
    configuration `cfg` (its JSON file)."""
    return {"psd": array64_chain.reference(cfg, x, precision)["psd"]}

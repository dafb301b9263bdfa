"""dsptpu_torch: the PyTorch / CUDA port of dsptpu for NVIDIA Hopper.

Same layout as dsptpu (utils/, ops/, filters/, kernels/) plus csrc/, the
CUDA sources of the hand-written kernels. Axis 0 is time and trailing
dims are channels. A tensor argument stays on its device; a numpy array
or list goes to `device=`, "cuda" by default.

Ported so far: the host design layer that the flagship chain needs, and
the chain itself, filt (FIR, K1) -> sosfilt (SOS cascade, K2) ->
welch_pgram / stft / spectrogram (K3). See ROADMAP.md for the rest.
"""

from . import filters, kernels, ops, utils
from .ops import windows
from .filters import (filt, sosfilt, sos_arrays, ZeroPoleGain,
                      PolynomialRatio, Biquad, SecondOrderSections, coefb,
                      coefa, FilterCoefficients, FilterType, Butterworth,
                      Chebyshev1, Chebyshev2, Elliptic, Lowpass, Highpass,
                      Bandpass, Bandstop, ComplexBandpass, analogfilter,
                      digitalfilter, bilinear, iirnotch, kaiserord,
                      FIRWindow, resample_filter, as_sos, as_zpk)
from .ops.periodograms import (arraysplit, periodogram, welch_pgram,
                               spectrogram, stft, WelchConfig, Periodogram,
                               Spectrogram, power, freq, tfr_time)
from .utils.fftutil import nextfastfft, nextpow2
from .pipeline import entry

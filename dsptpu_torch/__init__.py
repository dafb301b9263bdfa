"""dsptpu_torch: the PyTorch / CUDA port of dsptpu for NVIDIA Hopper.

Same layout as dsptpu (utils/, ops/, filters/, kernels/) plus csrc/, the
CUDA sources of the hand-written kernels. Axis 0 is time and trailing
dims are channels. A tensor argument stays on its device; a numpy array
or list goes to `device=`, "cuda" by default.

Ported so far: the host design layer that the flagship chain needs; the
chain itself, filt (FIR, K1) -> sosfilt (SOS cascade, K2) ->
welch_pgram / stft / spectrogram (K3); overlap-save conv / fftfilt /
long-tap filt (K4) with direct and FFT conv, xcorr and deconv; the
zero-phase filtfilt (K2 forward and reverse), DF2TFilter and tdfilt;
LPC (Burg, Levinson-Durbin: K5); and streaming polyphase resampling,
FIRFilter / resample / polyphase_filt (rational K6, arbitrary rate K7).
See ROADMAP.md for the rest.
"""

from . import filters, kernels, ops, utils
from .ops import windows
from .filters import (filt, sosfilt, sos_arrays, ZeroPoleGain,
                      PolynomialRatio, Biquad, SecondOrderSections, coefb,
                      coefa, FilterCoefficients, FilterType, Butterworth,
                      Chebyshev1, Chebyshev2, Elliptic, Lowpass, Highpass,
                      Bandpass, Bandstop, ComplexBandpass, analogfilter,
                      digitalfilter, bilinear, iirnotch, kaiserord,
                      FIRWindow, resample_filter, as_sos, as_zpk,
                      DF2TFilter, filtfilt, fftfilt, tdfilt, FIRFilter,
                      taps2pfb, resample, polyphase_filt, outputlength,
                      inputlength, timedelay)
from .ops.dspbase import (conv, conv_with_offset, deconv, xcorr,
                          optimal_os_nfft)
from .ops.lpc import lpc, arburg, levinson, LPCBurg, LPCLevinson
from .ops.periodograms import (arraysplit, periodogram, welch_pgram,
                               spectrogram, stft, WelchConfig, Periodogram,
                               Spectrogram, power, freq, tfr_time)
from .utils.fftutil import nextfastfft, nextpow2
from .pipeline import (entry, fftfilt_entry, filtfilt_lpc_entry,
                       resample_entry)

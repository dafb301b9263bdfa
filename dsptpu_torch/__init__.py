"""dsptpu_torch: the PyTorch / CUDA port of dsptpu for NVIDIA Hopper.

Same layout as dsptpu (utils/, ops/, filters/, kernels/) plus csrc/, the
CUDA sources of the hand-written kernels. Axis 0 is time and trailing
dims are channels. A tensor argument stays on its device; a numpy array
or list goes to `device=`, "cuda" by default.

Ported: the single-chip library. The host design layer (windows, IIR
and FIR design, remez, order estimation, responses); filt (FIR, K1) and
sosfilt (SOS cascade, K2); welch_pgram / stft / spectrogram (K3), the
1-D and 2-D periodogram and fftshift_tfr; multitaper mt_pgram /
mt_spectrogram (K3's K-window stack) / cross spectra / coherence;
overlap-save conv / fftfilt / long-tap filt (K4) with direct and FFT
conv, xcorr and deconv; the zero-phase filtfilt (K2 forward and
reverse), DF2TFilter and tdfilt; LPC (Burg, Levinson-Durbin: K5);
streaming polyphase resampling, FIRFilter / resample / polyphase_filt
(rational K6, arbitrary rate K7); frequency estimation; the signal
utilities (hilbert, dB helpers, delay and alignment, unwrap, diric).
The layout kernels K8a-c (kernels/transpose.py) are on no route, as in
dsptpu.

Also the rest of dsptpu: parallel/, the sharded ops on a torch
DeviceMesh (halos and state chains on torch.distributed, NCCL on the
card, gloo on the CPU; simulate_hosts runs n gloo ranks on the CPU, and
sharded_entry / dryrun_multichip drive them); native/, the C++ prefetch
reader StreamReader, each chunk through a pinned buffer to the card; and
utils/profiling.py (torch.profiler traces, CUDA-event timing, the H100's
roofline).
"""

from . import filters, kernels, ops, parallel, utils
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
                      inputlength, timedelay, freqresp, phaseresp, grpdelay,
                      impresp, stepresp, buttord, ellipord, cheb1ord,
                      cheb2ord, remezord, remez, RemezFilterType,
                      filter_type_bandpass, filter_type_differentiator,
                      filter_type_hilbert)
from .ops.dspbase import (conv, conv_with_offset, deconv, xcorr,
                          optimal_os_nfft)
from .ops.periodograms import (arraysplit, periodogram, welch_pgram,
                               spectrogram, stft, WelchConfig, Periodogram,
                               Periodogram2, Spectrogram, power, freq,
                               tfr_time, fftshift_tfr)
time = tfr_time      # reference accessor name (Base.time(::Spectrogram))
from .ops.multitaper import (MTConfig, MTSpectrogramConfig,
                             MTCrossSpectraConfig, MTCoherenceConfig,
                             dpss_config, allocate_output,
                             mt_pgram, mt_spectrogram,
                             mt_cross_power_spectra, mt_coherence,
                             coherence, coherence_from_cs)
from .ops.lpc import lpc, arburg, levinson, LPCBurg, LPCLevinson
from .ops.windows import rect
from .ops.estimation import esprit, jacobsen, quinn
from .utils.util import (hilbert, db2pow, db2amp, pow2db, amp2db, dB, dBa,
                         rms, rmsfft, meanfreq, finddelay, shiftsignal,
                         alignsignals, shiftin, unsafe_dot)
from .utils.fftutil import (nextfastfft, nextpow2, fftintype, fftouttype,
                            fftabs2type)
from .utils.unwrap import unwrap
from .utils.diric import diric
from .pipeline import (entry, fftfilt_entry, filtfilt_lpc_entry,
                       resample_entry, multitaper_entry, sharded_entry,
                       dryrun_multichip)

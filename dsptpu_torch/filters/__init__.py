from .coefficients import (FilterCoefficients, ZeroPoleGain, PolynomialRatio,
                           Biquad, SecondOrderSections, coefb, coefa, convert,
                           as_zpk, as_polynomial_ratio, as_biquad, as_sos)
from .design import (Butterworth, Chebyshev1, Chebyshev2, Elliptic,
                     FilterType,
                     Lowpass, Highpass, Bandpass, Bandstop, ComplexBandpass,
                     analogfilter, digitalfilter, bilinear, transform_prototype,
                     iirnotch, kaiserord, FIRWindow, resample_filter)
from .filt import (filt, sosfilt, sos_arrays, DF2TFilter, filtfilt, fftfilt,
                   tdfilt, filt_stepstate, filt_stepstate_sos)
from .stream_filt import (FIRFilter, taps2pfb, outputlength, inputlength,
                          resample, polyphase_filt, timedelay)
from .response import freqresp, phaseresp, grpdelay, impresp, stepresp
from .filt_order import buttord, ellipord, cheb1ord, cheb2ord, remezord
from .remez_fir import (remez, RemezFilterType, filter_type_bandpass,
                        filter_type_differentiator, filter_type_hilbert)

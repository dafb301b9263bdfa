from .coefficients import (FilterCoefficients, ZeroPoleGain, PolynomialRatio,
                           Biquad, SecondOrderSections, coefb, coefa, convert,
                           as_zpk, as_polynomial_ratio, as_biquad, as_sos)
from .design import (Butterworth, Chebyshev1, Chebyshev2, Elliptic,
                     FilterType,
                     Lowpass, Highpass, Bandpass, Bandstop, ComplexBandpass,
                     analogfilter, digitalfilter, bilinear, transform_prototype,
                     iirnotch, kaiserord, FIRWindow, resample_filter)
from .filt import filt, sosfilt, sos_arrays

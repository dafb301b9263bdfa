from . import windows
from .dspbase import (filt, conv, conv_with_offset, deconv, xcorr,
                      optimal_os_nfft)
from .lpc import (lpc, arburg, levinson, LPCBurg, LPCLevinson)
from .periodograms import (arraysplit, periodogram, welch_pgram, spectrogram,
                           stft, WelchConfig, Periodogram, Spectrogram,
                           power, freq, tfr_time)

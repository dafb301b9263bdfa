from . import windows
from .dspbase import filt
from .periodograms import (arraysplit, periodogram, welch_pgram, spectrogram,
                           stft, WelchConfig, Periodogram, Spectrogram,
                           power, freq, tfr_time)

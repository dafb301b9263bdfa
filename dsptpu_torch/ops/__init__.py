from . import windows
from .dspbase import (filt, conv, conv_with_offset, deconv, xcorr,
                      optimal_os_nfft)
from .lpc import (lpc, arburg, levinson, LPCBurg, LPCLevinson)
from .periodograms import (arraysplit, periodogram, welch_pgram, spectrogram,
                           stft, WelchConfig, Periodogram, Periodogram2,
                           Spectrogram, power, freq, tfr_time, fftshift_tfr)
from .multitaper import (MTConfig, MTSpectrogramConfig, MTCrossSpectraConfig,
                         MTCoherenceConfig, dpss_config, allocate_output,
                         mt_pgram, mt_spectrogram, mt_cross_power_spectra,
                         mt_coherence, coherence, coherence_from_cs,
                         CrossPowerSpectra, Coherence)
from .estimation import esprit, jacobsen, quinn

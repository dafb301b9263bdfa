from .fftutil import nextfastfft, nextpow2, nextprod, fftintype
from .special import besseli0, ellipk
from . import profiling
from .device import (as_tensor, to_host, resolve_device, no_tf32,
                     full_f32, check_full_f32)
from .util import (hilbert, db2pow, db2amp, pow2db, amp2db, dB, dBa, rms,
                   rmsfft, meanfreq, finddelay, shiftsignal, alignsignals,
                   shiftin, unsafe_dot)
from .unwrap import unwrap
from .diric import diric

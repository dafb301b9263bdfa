from .fftutil import nextfastfft, nextpow2, nextprod, fftintype
from .special import besseli0, ellipk
from .device import as_tensor, resolve_device, no_tf32, check_full_f32

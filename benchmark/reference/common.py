"""Plain PyTorch building blocks of the references: filter design from
the textbook formulas, linear convolution by FFT, the one-sided PSD of
windowed frames, and the rounding that stands for TF32.

Nothing here comes from the program: taps, poles, gains, windows and
initial states are worked out again from the configuration's numbers.

Every function takes a `precision`:
- "float64": the reference. Data and coefficients in float64, FFTs in
  complex128.
- "tf32": the control, the reference one precision step below the
  float32 that the configurations state. Every operand that enters a
  product (the signal, taps, impulse responses, windows, autocorrelation
  lags) is rounded to TF32 (8 exponent bits, 10 mantissa bits, round to
  nearest even), as a tensor core rounds float32 inputs; the products
  and sums then run in float32.
"""

import math

import torch

PRECISIONS = ("float64", "tf32")


def real_dtype(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def to_tf32(x):
    """float32 x rounded to TF32: the low 13 mantissa bits dropped, with
    round to nearest even."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bias = 0x0FFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def operand(x, precision):
    """x as an operand of a product in `precision`."""
    if precision == "tf32":
        return to_tf32(x.to(torch.float32))
    return x.to(torch.float64)


def sym_window(kind, n, device):
    """Symmetric window of n points, float64: Hann 0.5 - 0.5 cos(2 pi
    k/(n-1)) or Hamming 0.54 - 0.46 cos(2 pi k/(n-1)), k = 0..n-1."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    c = torch.cos(2 * math.pi * k / (n - 1))
    if kind == "hanning":
        return 0.5 - 0.5 * c
    if kind == "hamming":
        return 0.54 - 0.46 * c
    raise ValueError(f"unknown window {kind!r}")


def fir_lowpass(ntaps, cutoff, window, device):
    """Windowed-sinc lowpass of ntaps taps, cutoff as a fraction of the
    Nyquist frequency, scaled to a DC gain of 1 (float64)."""
    k = torch.arange(ntaps, dtype=torch.float64, device=device)
    h = cutoff * torch.sinc(cutoff * (k - (ntaps - 1) / 2))
    h = h * sym_window(window, ntaps, device)
    return h / h.sum()


def butterworth_lowpass(order, cutoff):
    """Digital Butterworth lowpass by the bilinear transform with
    prewarping: (poles as complex numbers, gain g) such that
    H(z) = g (1 + 1/z)^order / prod_k (1 - p_k / z), with H(1) = 1."""
    t = math.tan(math.pi * cutoff / 2)
    poles = []
    for k in range(order):
        s = complex(math.cos(math.pi * (2 * k + order + 1) / (2 * order)),
                    math.sin(math.pi * (2 * k + order + 1) / (2 * order)))
        poles.append((1 + t * s) / (1 - t * s))
    g = 1.0
    for p in poles:
        g *= (1 - p)
    return poles, (g / 2 ** order).real


def iir_impulse(poles, order, gain, length, device):
    """The first `length` samples of the impulse response of
    gain (1 + 1/z)^order / prod (1 - p/z), float64, by sampling the
    response on a grid of 8 x length points (the tail folded back onto
    the kept samples has decayed far below float64's resolution; the
    caller checks that)."""
    m = 8 * length
    w = torch.arange(m // 2 + 1, dtype=torch.float64, device=device)
    zinv = torch.exp(-2j * math.pi * w / m)
    num = (1 + zinv) ** order
    den = torch.ones_like(zinv)
    for p in poles:
        den = den * (1 - p * zinv)
    h = torch.fft.irfft(gain * num / den, n=m)
    tail = h[length:].abs().max()
    if not tail <= 1e-13 * h.abs().max():
        raise ValueError("impulse response has not decayed within "
                         f"{length} samples (tail {float(tail):.3e})")
    return h[:length]


def fft_filter(x, h, precision, out_len=None, chunk=16):
    """Causal linear convolution along axis 0: y[t] = sum_k h[k] x[t-k]
    with zero initial state, the first out_len (default x's length)
    outputs; x (n, C), h (L,). Channels go in chunks of `chunk`."""
    n = x.shape[0]
    out_len = n if out_len is None else out_len
    m = 1 << max(1, (n + h.shape[0] - 1 - 1).bit_length())
    hf = torch.fft.rfft(operand(h, precision), n=m)
    outs = []
    for c0 in range(0, x.shape[1], chunk):
        xf = torch.fft.rfft(operand(x[:, c0:c0 + chunk], precision), n=m,
                            dim=0)
        outs.append(torch.fft.irfft(xf * hf[:, None], n=m,
                                    dim=0)[:out_len])
    return torch.cat(outs, 1)


def frame_psd(y, nfft, hop, window, precision, chunk=16):
    """One-sided PSD of each windowed frame of y (n, C): frames of nfft
    samples every hop samples, |rfft(w frame)|^2 / sum(w^2), doubled
    except at DC and Nyquist (fs 1). Returns (nfft//2+1, frames, C)."""
    w = operand(window, precision)
    scale = torch.full((nfft // 2 + 1,), 2.0, dtype=real_dtype(precision),
                       device=y.device)
    scale[0] = 1.0
    if nfft % 2 == 0:
        scale[-1] = 1.0
    scale = scale / (window.to(torch.float64) ** 2).sum().to(scale.dtype)
    outs = []
    for c0 in range(0, y.shape[1], chunk):
        fr = operand(y[:, c0:c0 + chunk], precision).unfold(0, nfft, hop)
        spec = torch.fft.rfft(fr * w, dim=-1)          # (frames, c, bins)
        p = spec.real ** 2 + spec.imag ** 2
        outs.append((p * scale).permute(2, 0, 1))
    return torch.cat(outs, 2)

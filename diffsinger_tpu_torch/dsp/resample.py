"""Polyphase resampling (counterpart of diffsinger_tpu/dsp/resample.py): scipy's
on the host, which ``load_wav`` uses, and a convolution on a tensor's device
with the same Kaiser-windowed sinc kernel as the JAX package's in-graph
resampler.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from diffsinger_tpu_torch.utils import no_tf32


def resample_poly_np(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Host resampler (scipy polyphase, Kaiser window)."""
    from scipy.signal import resample_poly

    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    return resample_poly(y, up, down).astype(np.float32)


def _design_kernel(up: int, down: int, width: int = 16, beta: float = 14.769656459379492):
    """Kaiser-windowed sinc lowpass for polyphase resampling (torchaudio's
    'kaiser_window' parameters). Returns (kernel, half length)."""
    max_rate = max(up, down)
    cutoff = 0.5 / max_rate
    half = width * max_rate
    n = np.arange(-half, half + 1, dtype=np.float64)
    window = np.kaiser(len(n), beta)
    t = 2 * cutoff * n
    sinc = np.sinc(t)
    kernel = 2 * cutoff * window * sinc
    return kernel.astype(np.float32), int(half)


@no_tf32()
def resample(y: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """[B, L] -> [B, ceil(L * target / orig)]: insert up - 1 zeros between
    samples, pad (half, half + down), correlate with the kernel at stride
    ``down``."""
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    kernel, half = _design_kernel(up, down)
    k = torch.from_numpy(kernel * up).to(y.device)
    B, L = y.shape
    stuffed = y.new_zeros(B, (L - 1) * up + 1)
    stuffed[:, ::up] = y
    stuffed = F.pad(stuffed, (half, half + down))
    out = F.conv1d(stuffed[:, None], k[None, None], stride=down)[:, 0]
    return out[:, : -(-L * up // down)]

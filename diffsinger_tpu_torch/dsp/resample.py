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


def polyphase_weights(up: int, down: int) -> tuple:
    """The kernel split by output phase: W [up, width] with
    W[r, j] = kernel[(lo + j) * up - r * down + half] (0 outside it), so that
    output q * up + r = sum_j W[r, j] * y[q * down + lo + j]. Returns (W, lo)."""
    kernel, half = _design_kernel(up, down)
    kernel = kernel * up
    r = np.arange(up)[:, None]
    lo = -(half // up)                              # the first input of phase 0
    width = -((half - (up - 1) * down) // up) - lo + 2 * half // up + 1
    k = (lo + np.arange(width))[None, :] * up - r * down + half
    w = np.where((k >= 0) & (k <= 2 * half), kernel[np.clip(k, 0, 2 * half)], 0.0)
    return w.astype(np.float32), lo


@no_tf32()
def resample(y: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """[B, L] -> [B, ceil(L * target / orig)]: the up-sample (insert up - 1
    zeros), pad (half, half + down) and strided correlation with the kernel
    of the JAX package's resampler, computed by phase: one convolution of
    the signal itself into ``up`` channels at stride ``down``, interleaved.
    (Correlating the zero-stuffed signal made cuDNN materialise taps x
    outputs: gigabytes for seconds of audio at 44.1 -> 16 kHz.)"""
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    w, lo = polyphase_weights(up, down)
    B, L = y.shape
    n_out = -(-L * up // down)
    n_q = -(-n_out // up)
    pad_r = max(0, (n_q - 1) * down + w.shape[1] - (L - lo))
    x = F.pad(y[:, None], (-lo, pad_r))
    out = F.conv1d(x, torch.from_numpy(w).to(y.device)[:, None], stride=down)[:, :, :n_q]
    return out.transpose(1, 2).reshape(B, n_q * up)[:, :n_out]

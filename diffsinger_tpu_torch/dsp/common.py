"""Curve helpers of the variance runtime (own copy of the parts of
diffsinger_tpu/dsp/common.py that inference uses): the half-sine smoothing of
the base pitch and the log-domain f0 interpolation through unvoiced frames.
The numpy versions run on the host in preprocessing; :func:`sinusoidal_smooth`
is the same smoothing on a tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def sinusoidal_smoothing_kernel(kernel_size: int) -> np.ndarray:
    """Half-sine window normalised to sum 1; size 1 is the identity tap."""
    if kernel_size <= 1:
        return np.ones((1,), np.float32)
    k = np.sin(np.linspace(0, 1, kernel_size, dtype=np.float32) * np.pi)
    return k / k.sum()


def sinusoidal_smooth_np(curve: np.ndarray, kernel_size: int) -> np.ndarray:
    """'same' convolution with edge padding over the last axis of [..., T]."""
    kernel = sinusoidal_smoothing_kernel(kernel_size)
    pad_l = (kernel_size - 1) // 2
    pad_r = kernel_size - 1 - pad_l
    x = np.pad(np.asarray(curve, np.float32),
               [(0, 0)] * (curve.ndim - 1) + [(pad_l, pad_r)], mode="edge")
    flat = x.reshape(-1, x.shape[-1])
    out = np.stack([np.convolve(v, kernel[::-1], mode="valid") for v in flat])
    return out.reshape(*curve.shape[:-1], -1).astype(np.float32)


def sinusoidal_smooth(curve: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """:func:`sinusoidal_smooth_np` on a float tensor [..., T]."""
    kernel = torch.from_numpy(sinusoidal_smoothing_kernel(kernel_size)).to(curve.device)
    pad_l = (kernel_size - 1) // 2
    flat = curve.float().reshape(-1, 1, curve.shape[-1])
    flat = F.pad(flat, (pad_l, kernel_size - 1 - pad_l), mode="replicate")
    return F.conv1d(flat, kernel[None, None]).reshape(curve.shape)


def norm_f0(f0: np.ndarray, uv: np.ndarray | None = None) -> np.ndarray:
    if uv is None:
        uv = f0 == 0
    out = np.log2(f0 + uv)
    out[uv] = -np.inf
    return out


def denorm_f0(f0: np.ndarray, uv, pitch_padding=None) -> np.ndarray:
    out = 2.0 ** f0
    if uv is not None:
        out[uv > 0] = 0
    if pitch_padding is not None:
        out[pitch_padding] = 0
    return out


def interp_f0(f0: np.ndarray, uv: np.ndarray | None = None):
    """Log-domain linear interpolation through unvoiced (zero) frames.
    Returns (f0, uv)."""
    if uv is None:
        uv = f0 == 0
    log_f0 = norm_f0(f0, uv)
    if uv.any() and not uv.all():
        log_f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], log_f0[~uv])
    return denorm_f0(log_f0, uv=None), uv

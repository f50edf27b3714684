"""Frame-level DSP helpers (own copy of diffsinger_tpu/dsp/common.py): RMS
energy, the half-sine smoothing of curves and the log-domain f0
interpolation through unvoiced frames.

The numpy versions run on the host in preprocessing; :func:`rms_frames` and
:func:`sinusoidal_smooth` run on a tensor's device, the card in binarization.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from diffsinger_tpu_torch.utils import no_tf32, resolve_device


def as_signal(x, device=None) -> torch.Tensor:
    """x as a float32 tensor. A tensor stays on its device unless ``device``
    names another; an array goes to ``device``, the card unless the caller
    names another."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


def rms_frames(y: torch.Tensor, *, frame_length: int, hop: int) -> torch.Tensor:
    """librosa.feature.rms: zero-pad by frame_length // 2 on both sides,
    frame, sqrt(mean(x^2)). [L] -> [F] with F = 1 + L // hop."""
    pad = frame_length // 2
    frames = F.pad(y, (pad, pad)).unfold(-1, frame_length, hop)
    return torch.sqrt(torch.mean(frames * frames, dim=-1))


def amplitude_to_db(x: np.ndarray, amin: float = 1e-5, top_db: float = 80.0) -> np.ndarray:
    """librosa.amplitude_to_db with ref=1.0: 20*log10(max(|x|, amin)), clipped to
    [max - top_db, max]."""
    db = 20.0 * np.log10(np.maximum(amin, np.abs(x)))
    if top_db is not None:
        db = np.maximum(db, db.max() - top_db)
    return db


def get_energy(waveform, length: int, *, hop_size: int, win_size: int, domain: str = "db",
               device=None) -> np.ndarray:
    """RMS energy per frame, padded or cut to ``length``, in dB or amplitude.
    ``waveform`` is a tensor (computed on its device) or an array (sent to
    ``device``)."""
    energy = rms_frames(as_signal(waveform, device), frame_length=win_size, hop=hop_size)
    energy = energy.cpu().numpy()
    if len(energy) < length:
        energy = np.pad(energy, (0, length - len(energy)))
    energy = energy[:length]
    if domain == "db":
        energy = amplitude_to_db(energy)
    elif domain != "amplitude":
        raise ValueError(f"Invalid domain: {domain}")
    return energy


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


@no_tf32()
def sinusoidal_smooth(curve: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """:func:`sinusoidal_smooth_np` on a float tensor [..., T], in float32."""
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

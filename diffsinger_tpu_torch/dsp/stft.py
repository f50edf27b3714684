"""Complex STFT and iSTFT (counterpart of diffsinger_tpu/dsp/stft.py), with
torch.stft/istft's conventions (center=True: reflect padding by n_fft // 2).

Used by the harmonic split. Frames are a strided view of the signal, the FFTs
batch over frames, and the iSTFT's overlap-add is one ``F.fold``; all of it
runs on the signal's device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def frame_signal(y: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[..., L] -> [..., F, frame_length], F = 1 + (L - frame_length) // hop (a view)."""
    return y.unfold(-1, frame_length, hop)


def windowed_frames(y: torch.Tensor, *, n_fft: int, hop: int, win_size: int,
                    window: torch.Tensor) -> torch.Tensor:
    """[B, L] -> windowed frames [B, F, n_fft], F = 1 + (L - win_size) // hop:
    frames of ``win_size``, the window applied, zero-padded on both sides to
    ``n_fft`` (torch's convention for a window shorter than the FFT)."""
    frames = frame_signal(y, win_size, hop) * window
    if win_size < n_fft:
        lpad = (n_fft - win_size) // 2
        frames = F.pad(frames, (lpad, n_fft - win_size - lpad))
    return frames


def stft_complex(y: torch.Tensor, *, n_fft: int, hop: int, win_size: int, window: torch.Tensor,
                 center: bool = True) -> torch.Tensor:
    """torch.stft parity: [B, L] -> complex [B, F, n_fft//2+1] (frame-major)."""
    if center:
        y = F.pad(y[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = windowed_frames(y, n_fft=n_fft, hop=hop, win_size=win_size, window=window)
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def istft(spec: torch.Tensor, *, n_fft: int, hop: int, win_size: int, window: torch.Tensor,
          center: bool = True, length: int | None = None) -> torch.Tensor:
    """torch.istft parity: complex [B, F, n_fft//2+1] -> [B, L].

    Overlap-add with squared-window normalisation; where the window's sum is
    under 1e-11 the output is 0 (the JAX package's floor, where torch.istft
    would raise)."""
    B, n_frames, _ = spec.shape
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    if win_size < n_fft:
        lpad = (n_fft - win_size) // 2
        frames = frames[:, :, lpad:lpad + win_size]
    frames = frames * window
    span = (n_frames - 1) * hop + win_size

    def overlap_add(x):  # [B, F, win] -> [B, span]
        return F.fold(x.transpose(1, 2), output_size=(1, span), kernel_size=(1, win_size),
                      stride=(1, hop)).reshape(x.shape[0], span)

    y = overlap_add(frames)
    norm = overlap_add((window * window).expand(1, n_frames, win_size))
    y = y / torch.clamp(norm, min=1e-11)
    # the JAX package's output runs on to whole hops past the last frame (zeros)
    total = (n_frames + -(-win_size // hop)) * hop
    y = F.pad(y, (0, total - span))
    if center:
        y = y[:, n_fft // 2:]
    return y if length is None else y[:, :length]


def nuttall_window(win_size: int) -> np.ndarray:
    """The Nuttall window of the kth-harmonic extractor."""
    phase = np.arange(win_size, dtype=np.float64) / win_size * 2 * np.pi
    return (
        0.355768
        - 0.487396 * np.cos(phase)
        + 0.144232 * np.cos(2 * phase)
        - 0.012604 * np.cos(3 * phase)
    ).astype(np.float32)

"""Log-mel spectrogram (counterpart of diffsinger_tpu/dsp/mel.py).

The conventions of the reference mel front end: reflect padding by
``((win - hop) // 2, (win - hop + 1) // 2)``, a periodic Hann window, a
``center=False`` STFT, its magnitude, librosa's Slaney filterbank and
``log(clamp(x, 1e-5))``. ``keyshift`` scales the FFT and window lengths by
``2 ** (keyshift / 12)`` and ``speed`` the hop, with the magnitude cut or
zero-padded back to ``n_fft // 2 + 1`` bins and scaled by ``win / win_new``.
The filterbank and windows are numpy constants, made on the host; the
transform runs on the signal's device in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from diffsinger_tpu_torch.dsp.common import as_signal
from diffsinger_tpu_torch.dsp.stft import windowed_frames
from diffsinger_tpu_torch.utils import no_tf32


def hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def hz_to_mel_htk(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
                   htk: bool = False) -> np.ndarray:
    """``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax, htk=htk)``:
    Slaney-normalised triangles, [n_mels, n_fft//2+1]."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    if htk:
        mel_pts = np.linspace(hz_to_mel_htk(fmin), hz_to_mel_htk(fmax), n_mels + 2)
        hz_pts = mel_to_hz_htk(mel_pts)
    else:
        mel_pts = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
        hz_pts = mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def hann_window_periodic(n: int) -> np.ndarray:
    """torch.hann_window(n) (periodic=True)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def stft_magnitude(y: torch.Tensor, *, n_fft: int, hop: int, win_size: int,
                   window: torch.Tensor) -> torch.Tensor:
    """|STFT| of [B, L] -> [B, n_fft//2+1, F], center=False (the caller pads)."""
    frames = windowed_frames(y, n_fft=n_fft, hop=hop, win_size=win_size, window=window)
    return torch.fft.rfft(frames, n=n_fft, dim=-1).abs().transpose(-2, -1)


class MelSpectrogram:
    """The reference ``STFT.get_mel``; the filterbank is made once on the host."""

    def __init__(
        self,
        sr: int = 44100,
        n_mels: int = 128,
        n_fft: int = 2048,
        win_size: int = 2048,
        hop_size: int = 512,
        fmin: float = 40.0,
        fmax: float = 16000.0,
        clip_val: float = 1e-5,
    ):
        self.sr = sr
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.win_size = win_size
        self.hop_size = hop_size
        self.fmin = fmin
        self.fmax = fmax
        self.clip_val = clip_val
        # numpy, so that the object pickles into spawned binarization workers
        self.mel_basis = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)

    def geometry(self, keyshift: float = 0.0, speed: float = 1.0) -> tuple:
        """(n_fft, window, hop) of a keyshift and speed."""
        factor = 2 ** (keyshift / 12)
        return (int(round(self.n_fft * factor)), int(round(self.win_size * factor)),
                int(round(self.hop_size * speed)))

    def num_frames(self, num_samples: int, *, keyshift: float = 0.0, speed: float = 1.0) -> int:
        _, win_new, hop_new = self.geometry(keyshift, speed)
        padded = num_samples + (win_new - hop_new) // 2 + (win_new - hop_new + 1) // 2
        return 1 + (padded - win_new) // hop_new

    @no_tf32()
    def __call__(self, y: torch.Tensor, *, keyshift: float = 0.0,
                 speed: float = 1.0) -> torch.Tensor:
        """[B, L] float32 in [-1, 1] -> log-mel [B, n_mels, F] (natural log,
        clamped at 1e-5), on y's device."""
        n_fft_new, win_new, hop_new = self.geometry(keyshift, speed)
        window = torch.from_numpy(hann_window_periodic(win_new)).to(y.device)
        pad_l = (win_new - hop_new) // 2
        pad_r = (win_new - hop_new + 1) // 2
        y = F.pad(y[:, None], (pad_l, pad_r), mode="reflect")[:, 0]
        spec = stft_magnitude(y, n_fft=n_fft_new, hop=hop_new, win_size=win_new, window=window)
        if keyshift != 0:
            size = self.n_fft // 2 + 1
            if spec.shape[1] < size:
                spec = F.pad(spec, (0, 0, 0, size - spec.shape[1]))
            spec = spec[:, :size, :] * (self.win_size / win_new)
        mel = torch.matmul(torch.from_numpy(self.mel_basis).to(y.device), spec)
        return torch.log(torch.clamp(mel, min=self.clip_val))

    def bucketed(self, y, *, keyshift: float = 0.0, speed: float = 1.0,
                 device=None) -> np.ndarray:
        """The log-mel of one waveform (a tensor, or an array sent to
        ``device``) as a numpy [n_mels, F].

        The JAX package pads lengths into buckets here to bound its compiles;
        torch compiles nothing, so this is the plain call, and the name stays
        so that the binarizers of both packages read alike."""
        return self(as_signal(y, device)[None], keyshift=keyshift, speed=speed)[0].cpu().numpy()


def get_mel(
    waveform,
    samplerate: int,
    *,
    num_mel_bins: int = 128,
    hop_size: int = 512,
    win_size: int = 2048,
    fft_size: int = 2048,
    fmin: float = 40,
    fmax: float = 16000,
    keyshift: float = 0,
    speed: float = 1,
    device=None,
) -> np.ndarray:
    """The reference's get_mel_torch: the log-mel of one waveform, [T, n_mels]."""
    stft = MelSpectrogram(samplerate, num_mel_bins, fft_size, win_size, hop_size, fmin, fmax)
    return stft.bucketed(waveform, keyshift=keyshift, speed=speed, device=device).T

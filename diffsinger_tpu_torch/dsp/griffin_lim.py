"""Griffin-Lim mel inversion, a vocoder that needs no checkpoint (counterpart
of diffsinger_tpu/dsp/griffin_lim.py).

    log-mel --(clipped filterbank pseudo-inverse, 30 NNLS updates)--> linear magnitude
            --(Griffin-Lim phase recovery, n_iter rounds)--> waveform

Evaluation-grade audio (phase-light), faithful in pitch, timing and timbre:
enough to hear whether a trained acoustic model sings the right song. The
mel conventions are ``dsp/mel.py``'s (natural log, clamp 1e-5, Slaney
filterbank), so ``spec2wav(get_mel(y))`` round-trips. The loops are Python
loops over ``torch.stft`` / ``torch.istft`` and matrix products, on the card
unless the caller asks for the CPU; float32 products run without TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from diffsinger_tpu_torch.dsp.mel import hann_window_periodic, mel_filterbank
from diffsinger_tpu_torch.utils import no_tf32, resolve_device

NNLS_STEPS = 30


def mel_pseudo_inverse(mel_basis: np.ndarray, reg: float = 1e-8) -> np.ndarray:
    """Non-negative-clipped Tikhonov pseudo-inverse of a mel filterbank:
    [n_mels, n_bins] -> [n_bins, n_mels], so that ``pinv @ mel_power``
    approximates the linear magnitude spectrum."""
    m = mel_basis.astype(np.float64)
    gram = m @ m.T + reg * np.eye(m.shape[0])
    pinv = m.T @ np.linalg.inv(gram)
    return np.maximum(pinv, 0.0).astype(np.float32)


def mel_to_linear(mel_amp: torch.Tensor, pinv: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Mel-domain amplitudes [B, T, M] -> linear magnitude [B, T, bins]: the
    clipped pseudo-inverse, then ``NNLS_STEPS`` multiplicative updates
    x <- x * B^T m / B^T B x (librosa's ``mel_to_stft`` fit; stays >= 0)."""
    x = torch.clamp(mel_amp @ pinv.T, min=1e-10)
    num = mel_amp @ basis
    for _ in range(NNLS_STEPS):
        denom = (x @ basis.T) @ basis
        x = x * num / torch.clamp(denom, min=1e-10)
    return x


def griffin_lim(mag: torch.Tensor, window: torch.Tensor, *, n_fft: int, hop: int,
                win_size: int, n_iter: int, length: int) -> torch.Tensor:
    """Phase recovery for magnitude frames [B, F, bins] -> waveform [B, length],
    from zero phase (deterministic), peak-limited to 0.95."""
    stft = dict(n_fft=n_fft, hop_length=hop, win_length=win_size, window=window, center=True)
    frames = mag.shape[1]

    def project(spec):  # spec [B, F, bins] -> (its consistent spectrum, the signal)
        y = torch.istft(spec.transpose(1, 2), length=length, **stft)
        return torch.stft(y, return_complex=True, **stft).transpose(1, 2)[:, :frames], y

    spec = mag.to(torch.complex64)
    for _ in range(n_iter):
        new_spec, _ = project(spec)
        spec = mag * (new_spec / torch.clamp(new_spec.abs(), min=1e-8))
    _, y = project(spec)
    peak = y.abs().amax(dim=-1, keepdim=True)
    return y / torch.clamp(peak / 0.95, min=1.0)


class GriffinLimVocoder:
    """Log-mel -> waveform without a checkpoint."""

    def __init__(self, sr: int = 44100, n_mels: int = 128, n_fft: int = 2048,
                 win_size: int = 2048, hop_size: int = 512, fmin: float = 40.0,
                 fmax: float = 16000.0, n_iter: int = 32, device=None):
        self.sr, self.hop_size = sr, hop_size
        self.n_fft, self.win_size, self.n_iter = n_fft, win_size, n_iter
        self.device = resolve_device(device)
        basis = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
        self.basis = torch.from_numpy(basis).to(self.device)
        self.pinv = torch.from_numpy(mel_pseudo_inverse(basis)).to(self.device)
        self.window = torch.from_numpy(hann_window_periodic(win_size)).to(self.device)

    @classmethod
    def from_hparams(cls, hp: dict, n_iter: int = 32, device=None) -> "GriffinLimVocoder":
        return cls(sr=hp["audio_sample_rate"], n_mels=hp["audio_num_mel_bins"],
                   n_fft=hp.get("fft_size", 2048), win_size=hp.get("win_size", 2048),
                   hop_size=hp.get("hop_size", 512), fmin=hp.get("fmin", 40),
                   fmax=hp.get("fmax", 16000), n_iter=n_iter, device=device)

    @torch.no_grad()
    @no_tf32()
    def spec2wav_torch(self, mel: torch.Tensor) -> torch.Tensor:
        """Log-e mel [B, T, n_mels] on the vocoder's device -> wav [B, T * hop]."""
        mag = mel_to_linear(torch.exp(mel.float()), self.pinv, self.basis)
        return griffin_lim(mag, self.window, n_fft=self.n_fft, hop=self.hop_size,
                           win_size=self.win_size, n_iter=self.n_iter,
                           length=mel.shape[1] * self.hop_size)

    def spec2wav(self, logmel, f0=None) -> np.ndarray:
        """[T, n_mels] (or [B, T, n_mels]) log-e mel -> float32 waveform.

        ``f0`` is taken for the vocoders' signature and ignored (Griffin-Lim
        needs no source signal)."""
        mel = torch.as_tensor(np.asarray(logmel, np.float32)).to(self.device)
        squeeze = mel.ndim == 2
        y = self.spec2wav_torch(mel[None] if squeeze else mel).cpu().numpy()
        return y[0] if squeeze else y

"""The trainable DDSP vocoder (counterpart of diffsinger_tpu/vocoders/ddsp_native.py).

mel [B, T, M] (natural log) + f0 [B, T] -> waveform [B, T * hop]:

* ``ControlNet``: mel -> per-frame harmonic amplitudes (K harmonics) and
  noise band magnitudes;
* ``harmonic_synth``: an additive sine bank over a [B, T * hop, K] layout,
  its phase summed in float64 and wrapped to [0, 1) before it is rounded to
  float32, the harmonics above Nyquist muted;
* ``filtered_noise``: uniform noise shaped per frame in the STFT domain;

and ``multi_resolution_stft_loss`` to train it. Stock PyTorch ops on the
mel's device. The JAX entry draws its noise from ``PRNGKey(0)``; here it
comes from a ``torch.Generator`` or is injected.
"""

from __future__ import annotations

import math
import pathlib
import warnings
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsinger_tpu_torch.dsp.stft import istft, stft_complex
from diffsinger_tpu_torch.utils import no_tf32, resolve_device, tracing
from diffsinger_tpu_torch.utils.frames import runs_with_room
from diffsinger_tpu_torch.vocoders.ddsp_combsub import hanning, to_bins
from diffsinger_tpu_torch.vocoders.registry import register_vocoder


class ControlNet(nn.Module):
    """mel [B, T, M] -> (harmonic amps [B, T, K], noise mags [B, T, N]).

    flax's defaults, kept: LayerNorm eps 1e-6 and GELU's tanh form."""

    def __init__(self, n_mels: int, n_harmonics: int = 64, n_noise_bands: int = 65,
                 hidden: int = 256, num_layers: int = 3):
        super().__init__()
        self.dense = nn.Linear(n_mels, hidden)
        self.convs = nn.ModuleList([nn.Conv1d(hidden, hidden, 3, padding=1)
                                    for _ in range(num_layers)])
        self.norms = nn.ModuleList([nn.LayerNorm(hidden, eps=1e-6) for _ in range(num_layers)])
        self.amp_out = nn.Linear(hidden, n_harmonics + 1)
        self.noise_out = nn.Linear(hidden, n_noise_bands)

    def forward(self, mel: torch.Tensor):
        x = self.dense(mel)
        for conv, norm in zip(self.convs, self.norms):
            y = norm(conv(x.transpose(1, 2)).transpose(1, 2))
            x = x + F.gelu(y, approximate="tanh")
        amp = self.amp_out(x)
        noise = self.noise_out(x)

        def scale(z):  # exp-sigmoid (DDSP's convention): smooth, positive
            return 2.0 * torch.sigmoid(z) ** math.log(10.0) + 1e-7

        master, harmonics = amp[..., :1], torch.softmax(amp[..., 1:], dim=-1)
        return scale(master) * harmonics, scale(noise)


def harmonic_synth(f0: torch.Tensor, amps: torch.Tensor, hop: int, sr: int) -> torch.Tensor:
    """Additive sine bank. f0 [B, T], amps [B, T, K] -> wav [B, T * hop].

    The sine bank is [B, T * hop, K], as in the JAX package; harmonics above
    Nyquist are muted. The phase is a cumulative sum in float64, wrapped to
    [0, 1), then cast to f0's dtype: the JAX package sums in float32, whose
    drift grows with the length, depends on the order of the sum (so on the
    device) and is multiplied by K in the K-th harmonic."""
    k = amps.shape[-1]
    up = torch.repeat_interleave(f0, hop, dim=1)  # [B, L]
    phase = torch.remainder(torch.cumsum(up.double() / sr, dim=1), 1.0).to(up.dtype)
    harm_idx = torch.arange(1, k + 1, dtype=torch.float32, device=f0.device)
    sines = torch.sin(2 * np.pi * (phase[:, :, None] * harm_idx))  # [B, L, K]
    amps_up = torch.repeat_interleave(amps, hop, dim=1)
    nyquist_mask = (up[:, :, None] * harm_idx) < (sr / 2)
    return torch.sum(sines * amps_up * nyquist_mask, dim=-1)


def filtered_noise(noise_mags: torch.Tensor, hop: int, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform noise shaped by a per-frame filter in the STFT domain.

    noise_mags [B, T, N]: N band magnitudes a mel frame, interpolated to the
    ``hop + 1`` bins of a ``2 * hop`` window. ``noise`` [B, T * hop] in
    [-1, 1] replaces the draw from ``generator``."""
    b, t, _ = noise_mags.shape
    n_fft = 2 * hop
    length = t * hop
    if noise is None:
        noise = torch.rand((b, length), generator=generator, device=noise_mags.device) * 2 - 1
    window = torch.from_numpy(hanning(n_fft)).to(noise_mags.device)
    stft = dict(n_fft=n_fft, hop=hop, win_size=n_fft, window=window, center=True)
    spec = stft_complex(noise, **stft)
    f = spec.shape[1]
    mags = noise_mags
    if f > t:  # edge padding to the STFT's frames
        mags = torch.cat([mags, mags[:, -1:].expand(b, f - t, mags.shape[-1])], dim=1)
    mags = to_bins(mags[:, :f], n_fft // 2 + 1)
    return istft(spec * mags, length=length, **stft)


class DDSPGenerator(nn.Module):
    """mel [B, T, M] + f0 [B, T] -> wav [B, T * hop]."""

    def __init__(self, n_mels: int, hop_size: int = 512, sampling_rate: int = 44100,
                 n_harmonics: int = 64, n_noise_bands: int = 65):
        super().__init__()
        self.hop_size = hop_size
        self.sampling_rate = sampling_rate
        self.control = ControlNet(n_mels, n_harmonics, n_noise_bands)

    def forward(self, mel: torch.Tensor, f0: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        amps, noise_mags = self.control(mel)
        harm = harmonic_synth(f0, amps, self.hop_size, self.sampling_rate)
        return harm + filtered_noise(noise_mags, self.hop_size, noise, generator)


def multi_resolution_stft_loss(pred: torch.Tensor, target: torch.Tensor,
                               fft_sizes: Sequence[int] = (512, 1024, 2048)) -> torch.Tensor:
    """Spectral convergence + log-magnitude loss, averaged over resolutions."""
    total = 0.0
    for n_fft in fft_sizes:
        window = torch.from_numpy(hanning(n_fft)).to(pred.device)
        stft = dict(n_fft=n_fft, hop=n_fft // 4, win_size=n_fft, window=window, center=True)
        sp = stft_complex(pred, **stft).abs()
        st = stft_complex(target, **stft).abs()
        sc = torch.linalg.vector_norm(st - sp) / torch.clamp(torch.linalg.vector_norm(st), min=1e-7)
        mag = torch.mean(torch.abs(torch.log(st + 1e-7) - torch.log(sp + 1e-7)))
        total = total + sc + mag
    return total / len(fft_sizes)


def generator_state_from_flax(params: dict, num_layers: int = 3) -> dict:
    """The JAX ``DDSPGenerator``'s parameters (its ``params`` tree) -> the
    port's state dict."""
    p = params["control"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    sd = {"control.dense.weight": t(np.transpose(p["Dense_0"]["kernel"])),
          "control.dense.bias": t(p["Dense_0"]["bias"])}
    for i in range(num_layers):
        sd[f"control.convs.{i}.weight"] = t(np.transpose(p[f"conv_{i}"]["kernel"], (2, 1, 0)))
        sd[f"control.convs.{i}.bias"] = t(p[f"conv_{i}"]["bias"])
        sd[f"control.norms.{i}.weight"] = t(p[f"LayerNorm_{i}"]["scale"])
        sd[f"control.norms.{i}.bias"] = t(p[f"LayerNorm_{i}"]["bias"])
    for name in ("amp_out", "noise_out"):
        sd[f"control.{name}.weight"] = t(np.transpose(p[name]["kernel"]))
        sd[f"control.{name}.bias"] = t(p[name]["bias"])
    return sd


@register_vocoder
class DDSPNative:
    """Registry entry 'ddspnative': the trainable DDSP vocoder.

    Loads a JAX trainer's ``.dsckpt`` (its parameters mapped) or a torch file
    holding the generator's state dict (``.ckpt``, ``.pt``); without one it
    keeps seeded random weights and warns, as the NSF wrapper does."""

    def __init__(self, hparams: dict, device=None):
        self.hparams = hparams
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)  # the weights a missing checkpoint leaves in place
            self.model = DDSPGenerator(hparams["audio_num_mel_bins"], hop_size=hparams["hop_size"],
                                       sampling_rate=hparams["audio_sample_rate"])
        ckpt = pathlib.Path(hparams.get("vocoder_ckpt") or "nonexistent")
        if ckpt.is_file() and ckpt.suffix == ".dsckpt":
            from diffsinger_tpu_torch.utils.ckpt import msgpack_restore

            params = msgpack_restore(ckpt.read_bytes())["params"]
            params = params.get("params", params)
            self.model.load_state_dict(generator_state_from_flax(params), strict=True)
        elif ckpt.is_file() and ckpt.suffix in (".ckpt", ".pt"):
            blob = torch.load(ckpt, map_location="cpu", weights_only=False)
            self.model.load_state_dict(blob.get("state_dict", blob), strict=True)
        else:
            warnings.warn(f"DDSPNative: no checkpoint at '{ckpt}'; using RANDOM weights.")
        self.model.to(self.device).eval()

    @torch.no_grad()
    @no_tf32()
    @runs_with_room
    def spec2wav_torch(self, mel: torch.Tensor, f0: torch.Tensor, *,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel [B, T, M] in the configured mel_base, f0 [B, T] -> wav [B, T * hop].

        A log10 mel becomes a natural-log one (the JAX entry's rule). The
        noise comes from a ``torch.Generator`` seeded 0 at every call, unless
        ``noise`` [B, T * hop] injects it."""
        with tracing.span("ds.vocoder"):
            mel = mel.float()
            if self.hparams.get("mel_base", 10) != "e":
                mel = 2.30259 * mel
            generator = torch.Generator(device=mel.device).manual_seed(0)
            return self.model(mel, f0.float(), noise=noise, generator=generator)

    def spec2wav(self, mel: np.ndarray, *, f0: np.ndarray, **kwargs) -> np.ndarray:
        """Single-item host API: mel [T, M], f0 [T] -> wav [T * hop] numpy."""
        wav = self.spec2wav_torch(
            torch.from_numpy(np.asarray(mel, np.float32))[None].to(self.device),
            torch.from_numpy(np.asarray(f0, np.float32))[None].to(self.device))
        return wav[0].cpu().numpy()

"""NSF-HiFiGAN vocoder wrapper (counterpart of diffsinger_tpu/vocoders/nsf_hifigan.py).

Reads ``config.json`` beside the checkpoint, loads ``ckpt["generator"]`` with
weight norm fused into the port's :class:`Generator`, and turns mel + f0 into
a waveform. When the checkpoint is absent the generator keeps seeded random
weights and a warning says so, so that the pipeline stays runnable without
assets.
"""

from __future__ import annotations

import json
import pathlib
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from diffsinger_tpu_torch.utils import resolve_device, resolve_precision, tracing
from diffsinger_tpu_torch.utils.frames import runs_with_room
from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import (
    Generator, NsfHifiGanConfig, VocoderNoise)
from diffsinger_tpu_torch.vocoders.registry import register_vocoder

_PARAM_WARN_KEYS = [
    ("sampling_rate", "audio_sample_rate"),
    ("num_mels", "audio_num_mel_bins"),
]


def fuse_weight_norm(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Replace ``{name}.weight_g`` / ``{name}.weight_v`` pairs with the fused
    weight (torch weight_norm, dim=0): W = g * v / ||v|| over the dims > 0,
    computed in float64 and stored as float32."""
    out = {}
    for k, t in state.items():
        if k.endswith(".weight_g"):
            base = k[: -len(".weight_g")]
            g = t.detach().double()
            v = state[base + ".weight_v"].detach().double()
            norm = v.pow(2).sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
            out[base + ".weight"] = (g * v / norm).float()
        elif not k.endswith(".weight_v"):
            out[k] = t.detach()
    return out


@register_vocoder
class NsfHifiGAN:
    def __init__(self, hparams: dict, device=None):
        self.hparams = hparams
        self.device = resolve_device(device)
        model_path = pathlib.Path(hparams["vocoder_ckpt"])
        config_path = model_path.with_name("config.json")
        if config_path.exists():
            with open(config_path) as f:
                self.config = NsfHifiGanConfig.from_json(json.load(f))
        else:
            self.config = NsfHifiGanConfig(
                num_mels=hparams.get("audio_num_mel_bins", 128),
                sampling_rate=hparams.get("audio_sample_rate", 44100),
            )
        for cfg_key, hp_key in _PARAM_WARN_KEYS:
            if hp_key in hparams and getattr(self.config, cfg_key) != hparams[hp_key]:
                print(
                    f"Mismatch parameters: hparams[{hp_key!r}]={hparams[hp_key]} != "
                    f"{getattr(self.config, cfg_key)} (vocoder)"
                )
        # infer_precision: bf16 runs the convolutions in bf16; the sine source
        # and its harmonic merge stay float32
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)  # the weights a missing checkpoint leaves in place
            self.model = Generator(self.config, dtype=resolve_precision(
                hparams.get("infer_precision")), device=self.device).eval()
        if model_path.exists():
            ckpt = torch.load(model_path, map_location="cpu", weights_only=False)
            self.model.load_state_dict(fuse_weight_norm(ckpt["generator"]), strict=True)
            print(f"| Load HifiGAN: {model_path}")
        else:
            warnings.warn(
                f"NSF-HiFiGAN checkpoint not found at '{model_path}'; "
                "using RANDOM weights — output will be noise. "
                "See docs/BestPractices.md#vocoders in the reference for checkpoints."
            )

    @torch.no_grad()
    @runs_with_room
    def spec2wav_torch(self, mel: torch.Tensor, f0: torch.Tensor, *,
                       noise: Optional[VocoderNoise] = None) -> torch.Tensor:
        """mel [B, T, M] in the configured mel_base; f0 [B, T] -> wav [B, T * hop].

        The generator's draws come from a ``torch.Generator`` seeded 0 at every
        call (the vocoder's noise does not depend on the request's seed, as in
        the JAX package), unless ``noise`` injects them.
        """
        with tracing.span("ds.vocoder"):
            mel_base = self.hparams.get("mel_base", 10)
            if mel_base != "e":
                assert mel_base in (10, "10"), "mel_base must be 'e', '10' or 10."
                mel = 2.30259 * mel  # log10 -> ln
            generator = torch.Generator(device=mel.device).manual_seed(0)
            return self.model(mel, f0, generator=generator, noise=noise)

    def spec2wav(self, mel: np.ndarray, *, f0: np.ndarray, **kwargs) -> np.ndarray:
        """Single-item host API: mel [T, M], f0 [T] -> wav [T * hop] numpy."""
        wav = self.spec2wav_torch(
            torch.from_numpy(np.asarray(mel, np.float32))[None].to(self.device),
            torch.from_numpy(np.asarray(f0, np.float32))[None].to(self.device))
        return wav[0].float().cpu().numpy()

"""DDSP vocoder (counterpart of diffsinger_tpu/vocoders/ddsp.py).

The reference runs a pc-ddsp TorchScript ``.jit`` bundle. The port, as the
JAX package, runs the bundle's weights in its native
:class:`~diffsinger_tpu_torch.vocoders.ddsp_combsub.CombSub`: it reads the
JAX package's converted ``<bundle>.dsckpt`` when one is present (through
``utils/ckpt.py::msgpack_restore``), else it converts the ``.jit`` bundle
(``vocoders/ddsp_convert.py``). Mismatched parameters are reported as the
reference reports them. mel [B, T, M] in the configured ``mel_base`` (a
natural-log mel is scaled to log10) + f0 [B, T] -> wav [B, T * hop], on the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np
import torch

from diffsinger_tpu_torch.utils import no_tf32, resolve_device
from diffsinger_tpu_torch.utils.frames import runs_with_room
from diffsinger_tpu_torch.vocoders.ddsp_combsub import CombSub
from diffsinger_tpu_torch.vocoders.registry import register_vocoder

_MISMATCH_KEYS = (("audio_sample_rate", "sampling_rate"), ("audio_num_mel_bins", "n_mels"),
                  ("hop_size", "block_size"), ("win_size", "win_length"))


def load_combsub(model_path) -> tuple:
    """(state dict, meta) of a DDSP vocoder: ``<bundle>.dsckpt`` (or the path
    itself when it is one) if present, else the ``.jit`` bundle converted."""
    from diffsinger_tpu_torch.vocoders import ddsp_convert

    model_path = pathlib.Path(model_path)
    native_path = (model_path if model_path.suffix == ".dsckpt"
                   else model_path.with_suffix(model_path.suffix + ".dsckpt"))
    if native_path.exists():
        from diffsinger_tpu_torch.utils.ckpt import msgpack_restore

        blob = msgpack_restore(native_path.read_bytes())
        return ddsp_convert.combsub_state_from_flax(blob["params"]), blob["meta"]
    if not model_path.exists():
        raise FileNotFoundError(f"DDSP model file is not found at '{model_path}'!")
    print(f"| converting DDSP TorchScript bundle '{model_path}' to native params")
    return ddsp_convert.convert_torchscript_ddsp(model_path)


@register_vocoder
class DDSP:
    def __init__(self, hparams: dict, device=None):
        self.hparams = hparams
        self.device = resolve_device(device)
        state, meta = load_combsub(hparams["vocoder_ckpt"])
        self.meta = meta
        for hp_key, meta_key in _MISMATCH_KEYS:
            if hparams.get(hp_key) is not None and int(hparams[hp_key]) != int(meta[meta_key]):
                print(f"Mismatch parameters: hparams['{hp_key}']=", hparams[hp_key],
                      "!=", meta[meta_key], "(vocoder)")
        self.model = CombSub(**{k: int(meta[k]) for k in (
            "sampling_rate", "block_size", "win_length", "n_mag_harmonic", "n_mag_noise",
            "n_mels")})
        self.model.load_state_dict(state, strict=True)
        self.model.to(self.device).eval()

    def mel_to_log10(self, mel: torch.Tensor) -> torch.Tensor:
        mel_base = self.hparams.get("mel_base", 10)
        if mel_base == "e":
            return 0.434294 * mel  # ln -> log10
        assert mel_base in (10, "10"), "mel_base must be 'e', '10' or 10."
        return mel

    @torch.no_grad()
    @no_tf32()
    @runs_with_room
    def spec2wav_torch(self, mel: torch.Tensor, f0: torch.Tensor, *,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel [B, T, M] in the configured mel_base, f0 [B, T] -> wav [B, T * hop].

        The noise comes from a ``torch.Generator`` seeded 0 at every call (the
        JAX package draws from ``PRNGKey(0)``), unless ``noise`` [B, T * hop]
        injects it."""
        generator = torch.Generator(device=mel.device).manual_seed(0)
        return self.model(self.mel_to_log10(mel.float()), f0.float(), noise=noise,
                          generator=generator)

    def spec2wav(self, mel: np.ndarray, *, f0: np.ndarray, **kwargs) -> np.ndarray:
        """Single-item host API: mel [T, M], f0 [T] -> wav [T * hop] numpy."""
        wav = self.spec2wav_torch(
            torch.from_numpy(np.asarray(mel, np.float32))[None].to(self.device),
            torch.from_numpy(np.asarray(f0, np.float32))[None].to(self.device))
        return wav[0].cpu().numpy()

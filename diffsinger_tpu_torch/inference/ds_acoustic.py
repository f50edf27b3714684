"""Acoustic inference runtime: .ds segments -> mel -> waveform
(counterpart of diffsinger_tpu/inference/ds_acoustic.py).

Preprocessing is host-side numpy, the JAX package's arithmetic, so both
packages feed their models bit-equal arrays. The model and the vocoder run on
the card unless the caller asks for the CPU.

Noise. The sampler's noise comes from a ``torch.Generator`` seeded by the
segment's ``seed`` field, else by ``seed``, else by a hash of title, run and
segment index (the JAX package's seed rules). That keeps its guarantee, the
same output for the same ``--seed``, but not its samples: a torch generator
cannot reproduce ``jax.random``. So every method that draws also takes a hook
that supplies the tensor instead (``noise=``, ``vocoder_noise=``, or the
``noise_fn`` / ``vocoder_noise_fn`` of :meth:`run_inference`), through which a
test feeds both packages the same numbers.
"""

from __future__ import annotations

import pathlib
import warnings
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from diffsinger_tpu_torch.inference.base_svs_infer import BaseSVSInfer, bucket_length
from diffsinger_tpu_torch.models.acoustic_encoder import VARIANCE_CHECKLIST
from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
from diffsinger_tpu_torch.utils import pad_to, resolve_device, resolve_precision
from diffsinger_tpu_torch.utils.ckpt import load_state_dict_for_inference
from diffsinger_tpu_torch.utils.infer_utils import cross_fade, resample_align_curve, save_wav
from diffsinger_tpu_torch.utils.text import load_phoneme_dictionary
from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import VocoderNoise
from diffsinger_tpu_torch.vocoders.registry import get_vocoder_cls

# (segment or chunk index, noise shape [B, T_mel, M]) -> the sampler's noise
NoiseFn = Callable[[int, tuple], torch.Tensor]
# (segment or chunk index, batch, padded frames) -> the vocoder's draws
VocoderNoiseFn = Callable[[int, int, int], VocoderNoise]


class DiffSingerAcousticInfer(BaseSVSInfer):
    def __init__(self, hparams: dict, load_model: bool = True, load_vocoder: bool = True,
                 ckpt_steps: Optional[int] = None, device=None):
        super().__init__(hparams)
        self.device = resolve_device(device)
        self.variances_to_embed = {
            v for v in VARIANCE_CHECKLIST if hparams.get(f"use_{v}_embed", False)
        }
        if load_model:
            self.phoneme_dictionary = load_phoneme_dictionary(hparams)
            self.load_maps()
            # float32 unless `infer_precision: bf16` opts the whole model into bf16
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)  # the weights a missing checkpoint leaves in place
                self.model = DiffSingerAcoustic(
                    hparams,
                    vocab_size=len(self.phoneme_dictionary),
                    out_dims=hparams["audio_num_mel_bins"],
                    dtype=resolve_precision(hparams.get("infer_precision")),
                    device=self.device,
                )
            try:
                load_state_dict_for_inference(
                    self.model.module, hparams["work_dir"], category="acoustic",
                    ckpt_steps=ckpt_steps, hp=hparams)
            except FileNotFoundError:
                warnings.warn(
                    f"No checkpoint in '{hparams['work_dir']}'; using RANDOM weights."
                )
        if load_vocoder:
            self.vocoder = get_vocoder_cls(hparams)(hparams, device=self.device)

    # ------------------------------------------------------------------
    def preprocess_input(self, param: dict, idx: int = 0) -> Dict[str, np.ndarray]:
        """One .ds segment -> model inputs as numpy arrays with a leading batch
        axis of 1 (the JAX package's arithmetic, line for line)."""
        hp = self.hparams
        batch: Dict[str, np.ndarray] = {}
        summary = OrderedDict()

        lang = param.get("lang")
        if lang is None:
            assert len(self.lang_map) <= 1, (
                "This is a multilingual model. Please specify a language by --lang option."
            )
        elif self.lang_map:
            assert lang in self.lang_map, f"Unrecognized language name: '{lang}'."
        if hp.get("use_lang_id", False):
            batch["languages"] = self.encode_languages(
                param["ph_seq"], lang, self.phoneme_dictionary
            )[None]

        tokens = np.asarray(
            self.phoneme_dictionary.encode(param["ph_seq"], lang=lang), np.int32
        )[None]
        batch["tokens"] = tokens

        ph_dur = np.asarray(param["ph_dur"].split(), np.float32)
        ph_acc = np.round(np.cumsum(ph_dur) / self.timestep + 0.5).astype(np.int64)
        durations = np.diff(ph_acc, prepend=0)
        mel2ph = np.repeat(np.arange(1, len(durations) + 1), durations).astype(np.int32)[None]
        batch["mel2ph"] = mel2ph
        length = mel2ph.shape[1]

        summary["tokens"] = tokens.shape[1]
        summary["frames"] = length
        summary["seconds"] = "%.2f" % (length * self.timestep)

        if hp.get("use_spk_id", False):
            spk_mix_id, spk_mix_value = self.load_speaker_mix(
                param_src=param, summary_dst=summary, mix_mode="frame", mix_length=length
            )
            batch["spk_mix_id"] = spk_mix_id
            batch["spk_mix_value"] = spk_mix_value

        batch["f0"] = resample_align_curve(
            np.asarray(param["f0_seq"].split(), np.float32),
            original_timestep=float(param["f0_timestep"]),
            target_timestep=self.timestep,
            align_length=length,
        )[None]

        for v_name in VARIANCE_CHECKLIST:
            if v_name in self.variances_to_embed:
                batch[v_name] = resample_align_curve(
                    np.asarray(param[v_name].split(), np.float32),
                    original_timestep=float(param[f"{v_name}_timestep"]),
                    target_timestep=self.timestep,
                    align_length=length,
                )[None]
                summary[v_name] = "manual"

        if hp.get("use_key_shift_embed", False):
            shift_min, shift_max = hp["augmentation_args"]["random_pitch_shifting"]["range"]
            gender = param.get("gender", 0.0)
            if isinstance(gender, (int, float, bool)):
                summary["gender"] = f"static({float(gender):.3f})"
                value = gender * shift_max if gender >= 0 else gender * abs(shift_min)
                batch["key_shift"] = np.full((1, length), value, np.float32)
            else:
                summary["gender"] = "dynamic"
                gender_seq = resample_align_curve(
                    np.asarray(gender.split(), np.float32),
                    original_timestep=float(param["gender_timestep"]),
                    target_timestep=self.timestep,
                    align_length=length,
                )
                mask = gender_seq >= 0
                key_shift_seq = gender_seq * (mask * shift_max + (1 - mask) * abs(shift_min))
                batch["key_shift"] = np.clip(
                    key_shift_seq.astype(np.float32), shift_min, shift_max
                )[None]

        if hp.get("use_speed_embed", False):
            if param.get("velocity") is None:
                summary["velocity"] = "default"
                batch["speed"] = np.full((1, length), 1.0, np.float32)
            else:
                summary["velocity"] = "manual"
                speed_min, speed_max = hp["augmentation_args"]["random_time_stretching"]["range"]
                speed_seq = resample_align_curve(
                    np.asarray(param["velocity"].split(), np.float32),
                    original_timestep=float(param["velocity_timestep"]),
                    target_timestep=self.timestep,
                    align_length=length,
                )
                batch["speed"] = np.clip(speed_seq.astype(np.float32), speed_min, speed_max)[None]

        print(f"[{idx}]\t" + ", ".join(f"{k}: {v}" for k, v in summary.items()))
        return batch

    # ------------------------------------------------------------------
    def _pad_batch(self, batch: Dict[str, np.ndarray]):
        """Pad the frame axis to a multiple of 128 and the token axis to a
        multiple of 16.

        The padding decides the numbers: the vocoder runs on the padded mel
        (padded frames are zero, their f0 is 0) and the waveform is cut to the
        true length afterwards, so a segment's last samples depend on how far
        it was padded. Only the JAX package's buckets give its samples.
        """
        length = batch["mel2ph"].shape[1]
        t_mel = bucket_length(length)
        t_txt = bucket_length(batch["tokens"].shape[1], step=16, minimum=16)
        out = dict(batch)
        out["tokens"] = pad_to(batch["tokens"], t_txt, axis=1)
        for key in ("mel2ph", "f0", "key_shift", "speed", *self.variances_to_embed):
            if key in out:
                out[key] = pad_to(out[key], t_mel, axis=1)
        if "languages" in out:
            out["languages"] = pad_to(out["languages"], t_txt, axis=1)
        if "spk_mix_value" in out and out["spk_mix_value"].shape[1] > 1:
            out["spk_mix_value"] = pad_to(out["spk_mix_value"], t_mel, axis=1)
        return out, length

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            # from pinned memory the copy does not wait for the kernels already queued
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _spk_mix_embed(self, spk_mix_id: torch.Tensor, spk_mix_value: torch.Tensor):
        """Mix speaker embeddings: ids [B, 1, N], values [B, T|1, N] -> [B, T|1, H]."""
        table = self.model.module.fs2.spk_embed.weight
        emb = table[spk_mix_id.long()]  # [B, 1, N, H]
        return torch.sum(emb * spk_mix_value.to(table.dtype)[..., None], dim=2)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed & 0xFFFF_FFFF)

    def _run_model(self, arrays: Dict[str, np.ndarray], generator, steps, noise, depth=None):
        """Padded (or stacked) arrays [B, ...] -> (mel [B, T_mel, M], f0 [B, T_mel]) on the device."""
        kwargs = {key: self._to_device(arrays[key])
                  for key in ("languages", "key_shift", "speed") if key in arrays}
        variances = {v: self._to_device(arrays[v]) for v in self.variances_to_embed if v in arrays}
        if variances:
            kwargs["variances"] = variances
        if "spk_mix_id" in arrays:
            kwargs["spk_mix_embed"] = self._spk_mix_embed(
                self._to_device(arrays["spk_mix_id"]), self._to_device(arrays["spk_mix_value"]))
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=torch.float32).to(self.device)
        f0 = self._to_device(arrays["f0"])
        out = self.model.forward_infer(
            self._to_device(arrays["tokens"]), self._to_device(arrays["mel2ph"]), f0,
            steps=steps, depth=depth, generator=generator, noise=noise, **kwargs)
        return out.diff_out, f0

    def _run_wav(self, arrays, generator, steps, noise, vocoder_noise, depth=None) -> torch.Tensor:
        """Sampler then vocoder on the device -> wav [B, T_mel * hop]."""
        mel, f0 = self._run_model(arrays, generator, steps, noise, depth)
        return self.vocoder.spec2wav_torch(mel, f0, noise=vocoder_noise)

    def forward_model(self, batch: Dict[str, np.ndarray],
                      generator: Optional[torch.Generator] = None,
                      steps: Optional[int] = None, *,
                      noise=None, depth: Optional[int] = None):
        """One segment, padded to its buckets -> (mel [1, T, M] numpy, f0 [1, T]).

        ``noise`` [1, T_mel_bucket, M] replaces the draw from ``generator``;
        ``depth`` (DDPM) overrides ``K_step_infer``.
        """
        padded, length = self._pad_batch(batch)
        mel, _ = self._run_model(padded, generator, steps, noise, depth)
        return mel[:, :length].float().cpu().numpy(), padded["f0"][:, :length]

    def forward_wav(self, batch: Dict[str, np.ndarray],
                    generator: Optional[torch.Generator] = None,
                    steps: Optional[int] = None, *,
                    noise=None, vocoder_noise: Optional[VocoderNoise] = None,
                    depth: Optional[int] = None) -> np.ndarray:
        """Sampler and vocoder on the padded segment -> wav [T * hop] numpy.

        The vocoder runs on the bucket-padded mel and the waveform is cut to
        the true length on the host (see :meth:`_pad_batch`).
        """
        padded, length = self._pad_batch(batch)
        wav = self._run_wav(padded, generator, steps, noise, vocoder_noise, depth)
        return wav[0, : length * self.hparams["hop_size"]].float().cpu().numpy()

    def run_vocoder(self, mel, f0) -> np.ndarray:
        """mel [1, T, M], f0 [1, T] (numpy) -> wav [T * hop] numpy."""
        wav = self.vocoder.spec2wav_torch(self._to_device(np.asarray(mel, np.float32)),
                                          self._to_device(np.asarray(f0, np.float32)))
        return wav[0].float().cpu().numpy()

    # ------------------------------------------------------------------
    def _concat_segments(self, params: List[dict], wavs: List[np.ndarray]) -> np.ndarray:
        """Offset-based concatenation with cross-fade on overlap."""
        sr = self.hparams["audio_sample_rate"]
        result = np.zeros(0)
        current_length = 0
        for param, wav in zip(params, wavs):
            silent_length = round(param.get("offset", 0) * sr) - current_length
            if silent_length >= 0:
                result = np.append(result, np.zeros(silent_length))
                result = np.append(result, wav)
            else:
                result = cross_fade(result, wav, current_length + silent_length)
            current_length = current_length + silent_length + wav.shape[0]
        return result

    def run_inference(
        self,
        params: List[dict],
        out_dir: pathlib.Path = None,
        title: str = None,
        num_runs: int = 1,
        spk_mix: Dict[str, float] = None,
        seed: int = -1,
        save_mel: bool = False,
        steps: Optional[int] = None,
        depth: Optional[int] = None,
        *,
        noise_fn: Optional[NoiseFn] = None,
        vocoder_noise_fn: Optional[VocoderNoiseFn] = None,
    ):
        """Synthesize all segments one by one and concatenate by offsets; writes
        ``<title>.wav``, or ``<title>.mel.npz`` with ``save_mel``.

        ``noise_fn`` and ``vocoder_noise_fn`` are called with the segment's
        index and supply the noise instead of the generators.
        """
        batches = [self.preprocess_input(p, idx=i) for i, p in enumerate(params)]
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = ".wav" if not save_mel else ".mel.npz"
        hp = self.hparams
        for run in range(num_runs):
            result = []
            wavs = []
            for i, (param, batch) in enumerate(zip(params, batches)):
                if "seed" in param:
                    generator = self._generator(param["seed"])
                elif seed >= 0:
                    generator = self._generator(seed)
                else:
                    generator = self._generator(hash((title, run, i)))
                t_mel = bucket_length(batch["mel2ph"].shape[1])
                noise = None
                if noise_fn is not None:
                    noise = noise_fn(i, (1, t_mel, hp["audio_num_mel_bins"]))
                if save_mel:
                    mel_pred, f0 = self.forward_model(batch, generator, steps=steps, noise=noise,
                                                      depth=depth)
                    result.append({
                        "offset": param.get("offset", 0.0),
                        "mel": mel_pred[0],
                        "f0": f0[0],
                    })
                else:
                    vocoder_noise = (vocoder_noise_fn(i, 1, t_mel)
                                     if vocoder_noise_fn is not None else None)
                    wavs.append(self.forward_wav(batch, generator, steps=steps, noise=noise,
                                                 vocoder_noise=vocoder_noise, depth=depth))
            if not save_mel:
                result = self._concat_segments(params, wavs)
            filename = (
                f"{title}-{str(run).zfill(3)}{suffix}" if num_runs > 1 else f"{title}{suffix}"
            )
            save_path = out_dir / filename
            if save_mel:
                np.savez(
                    save_path,
                    **{
                        f"{k}_{j}": seg[k]
                        for j, seg in enumerate(result)
                        for k in ("offset", "mel", "f0")
                    },
                    num_segments=len(result),
                )
                print(f"| save mel: {save_path}")
            else:
                print(f"| save audio: {save_path}")
                save_wav(result, save_path, hp["audio_sample_rate"])

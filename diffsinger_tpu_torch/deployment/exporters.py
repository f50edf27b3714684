"""Exporters (counterpart of diffsinger_tpu/deployment/exporters.py).

Each bundle holds, per shape bucket, ``torch.export`` programs saved as
``.pt2`` (where the JAX package writes StableHLO) and/or ONNX graphs lowered
from the same programs (``deployment/onnx/lowering.py``), plus the
attachments of the reference's ecosystem contract: ``dsconfig.yaml``,
``phonemes.json``, ``languages.json``, dictionaries and speaker ``.emb``
files (acoustic, variance), ``vocoder.yaml`` (vocoder).

* acoustic: ``fs2_aux`` (encoder + aux draft) and ``acoustic`` (the whole
  deployment forward, ``DiffSingerAcoustic.forward_infer_dynamic``, with
  ``depth`` and ``steps`` as inputs) views;
* variance: ``linguistic`` (encoder + duration predictor), ``pitch`` and
  ``variance`` (``DiffSingerVariance.forward_pitch_deployed`` /
  ``forward_variance_deployed``, with ``steps`` as an input) views;
* vocoder: mel + f0 -> waveform.

A ``.pt2`` is exported on the device it will run on (the card unless
``device='cpu'``), which the manifest records: in it LYNXNet's conv module is
K2 and the encoders' attention K3 (``ds::`` custom ops), launched on the
card. The ONNX graphs hold the kernels' plain versions, as the JAX package's
hold no Pallas. Artifacts are float32 whatever ``infer_precision`` says.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import time
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import yaml

from diffsinger_tpu_torch.models.acoustic_encoder import VARIANCE_CHECKLIST as VARIANCES
from diffsinger_tpu_torch.utils import resolve_device


class BaseExporter:
    FORMATS = ("pt2", "onnx", "both")

    def __init__(self, hparams: dict, export_dir, fmt: str = "pt2", device=None):
        if fmt not in self.FORMATS:
            raise ValueError(f"unknown export format {fmt!r}")
        # artifacts are float32 whatever infer_precision asks for: ONNX
        # consumers have no bfloat16, and the reference's artifacts are float32
        if hparams.get("infer_precision"):
            hparams = dict(hparams, infer_precision=None)
        self.hparams = hparams
        self.fmt = fmt
        self.device = resolve_device(device)
        self.export_dir = pathlib.Path(export_dir)
        self.export_dir.mkdir(parents=True, exist_ok=True)
        # seconds spent per step: tracing, writing .pt2, lowering + writing ONNX
        self.seconds = {"trace": 0.0, "pt2": 0.0, "onnx": 0.0}

    @property
    def want_pt2(self) -> bool:
        return self.fmt in ("pt2", "both")

    @property
    def want_onnx(self) -> bool:
        return self.fmt in ("onnx", "both")

    def export(self):
        self.export_model()
        self.export_attachments()

    def export_model(self):
        raise NotImplementedError()

    def export_attachments(self):
        raise NotImplementedError()

    # ------------------------------------------------------------------
    def _trace(self, module: nn.Module, args) -> "torch.export.ExportedProgram":
        t0 = time.perf_counter()
        with torch.no_grad():
            ep = torch.export.export(module, tuple(args))
        self.seconds["trace"] += time.perf_counter() - t0
        return ep

    def _save_pt2(self, ep, path: pathlib.Path):
        t0 = time.perf_counter()
        torch.export.save(ep, str(path))
        self.seconds["pt2"] += time.perf_counter() - t0
        print(f"| export: {path} ({path.stat().st_size / 1e6:.2f} MB)")

    def _save_onnx(self, ep, path: pathlib.Path, *, input_names, output_names,
                   internal_noise=(), internal_constants=None):
        """Lower ``ep`` to ONNX, check the bytes with the structural checker
        against the emitted-op set, and write them. ``internal_noise`` names
        inputs replaced by an in-graph ``RandomNormalLike`` source and
        ``internal_constants`` inputs baked as values, so that the public
        signature is the reference's."""
        from diffsinger_tpu_torch.deployment.onnx import EMITTED_OPS, lower_program
        from diffsinger_tpu_torch.deployment.onnx.checker import check_model

        t0 = time.perf_counter()
        gb = lower_program(ep, name=path.stem, input_names=list(input_names),
                           output_names=list(output_names))
        for noise_name in internal_noise:
            gb.internalize_noise(noise_name)
        for const_name, value in (internal_constants or {}).items():
            gb.internalize_constant(const_name, value)
        data = gb.model_bytes()
        check_model(data, known_ops=EMITTED_OPS)
        path.write_bytes(data)
        self.seconds["onnx"] += time.perf_counter() - t0
        print(f"| export: {path} ({path.stat().st_size / 1e6:.2f} MB)")

    def _export_dictionaries(self):
        hp = self.hparams
        for lang, dict_path in (hp.get("dictionaries") or {}).items():
            shutil.copy(dict_path, self.export_dir / f"dictionary-{lang}.txt")
        if hp.get("dictionary"):
            shutil.copy(hp["dictionary"], self.export_dir / "dictionary.txt")

    def _export_phonemes(self, phoneme_dictionary):
        path = self.export_dir / "phonemes.json"
        phoneme_dictionary.dump(path)
        print(f"| export: {path}")

    def _export_languages(self, lang_map: dict):
        """languages.json for multi-lingual models, beside phonemes.json."""
        if not lang_map:
            return None
        path = self.export_dir / "languages.json"
        with open(path, "w", encoding="utf8") as f:
            json.dump(lang_map, f, ensure_ascii=False, indent=2)
        print(f"| export: {path}")
        return path.name

    # -- speaker policy (reference {acoustic,variance}_exporter.py:58-83) ----
    def _resolve_spk_settings(self, export_spk, freeze_spk, spk_map):
        """With no settings, a single-speaker model freezes its one speaker and
        a multi-speaker model exports every speaker. Returns
        ``(export_mixes, freeze_mix | None)``, each mix ``(alias, {name: weight})``."""
        from diffsinger_tpu_torch.utils.infer_utils import parse_spk_settings

        if not self.hparams.get("use_spk_id", False):
            return [], None
        export_mix, freeze_mix = parse_spk_settings(export_spk, freeze_spk)
        if export_mix and freeze_mix:
            raise ValueError("--export_spk is exclusive to --freeze_spk.")
        if not export_mix and freeze_mix is None:
            if len(spk_map) == 1:
                only = next(iter(spk_map))
                freeze_mix = (only, {only: 1.0})
            else:
                export_mix = [(name, {name: 1.0}) for name in spk_map]
        return export_mix, freeze_mix

    @staticmethod
    def _spk_mix_embed(table: torch.Tensor, spk_map: dict, mix: dict) -> np.ndarray:
        """Weighted speaker embedding [H] of a parsed mix."""
        table = table.detach().float().cpu().numpy()
        out = np.zeros(table.shape[1], np.float32)
        for name, weight in mix.items():
            if name not in spk_map:
                raise ValueError(f"Unknown speaker '{name}'.")
            out += weight * table[spk_map[name]]
        return out

    def _export_spk_embeds(self, table, spk_map: dict, export_mixes, model_name: str):
        """One ``{model_name}.{alias}.emb`` (float32 [H]) per exported mix."""
        for alias, mix in export_mixes:
            emb_path = self.export_dir / f"{model_name}.{alias}.emb"
            self._spk_mix_embed(table, spk_map, mix).tofile(emb_path)
            print(f"| export speaker: {emb_path}")


class AcousticProgram(nn.Module):
    """A traceable view of the acoustic model with the deployed inputs.

    ``view`` 'acoustic': (tokens, mel2ph, f0, depth, steps, noise, *extras)
    -> mel, through ``forward_infer_dynamic``; 'fs2_aux': (tokens, mel2ph,
    f0, *extras) -> condition (and the aux mel of a shallow model). The
    extras follow ``extra_names``: ``languages``, ``spk_embed`` (the
    frame-level speaker mix), the variance curves, ``gender`` (a [-1, 1]
    curve mapped onto key_shift through the pitch-shift range) and
    ``velocity`` (the speed, clipped into the stretching range); ``frozen``
    holds the values of embeds that are on but not exposed.
    """

    def __init__(self, model, view: str, extra_names, frozen: dict, shift_range, speed_range):
        super().__init__()
        # the parameters the view reads, so that a program holds no others
        if view == "fs2_aux":
            self.fs2 = model.module.fs2
            self.aux_decoder = model.module.aux_decoder
        else:
            self.module = model.module
        self.model = model
        self.view = view
        self.extra_names = list(extra_names)
        self.frozen_names = list(frozen)
        for name, value in frozen.items():
            self.register_buffer("frozen_" + name, value)
        self.shift_range = shift_range
        self.speed_range = speed_range

    def encode_kwargs(self, extras) -> dict:
        kwargs = {name: getattr(self, "frozen_" + name) for name in self.frozen_names}
        variances = {}
        for name, value in zip(self.extra_names, extras):
            if name in VARIANCES:
                variances[name] = value
            elif name == "gender":
                lo, hi = self.shift_range
                g = torch.clamp(value, -1.0, 1.0)
                kwargs["key_shift"] = torch.where(g >= 0, g * hi, g * abs(lo))
            elif name == "velocity":
                kwargs["speed"] = torch.clamp(value, *self.speed_range)
            elif name == "spk_embed":
                kwargs["spk_mix_embed"] = value
            else:
                kwargs[name] = value
        if variances:
            kwargs["variances"] = variances
        return kwargs

    def forward(self, tokens, mel2ph, f0, *rest):
        if self.view == "fs2_aux":
            m = self.model.module
            cond = m.encode(tokens, mel2ph, f0, **self.encode_kwargs(rest))
            if not self.model.use_shallow_diffusion:
                return cond
            return cond, m.aux(cond, infer=True)
        depth, steps, noise, *extras = rest
        return self.model.forward_infer_dynamic(
            tokens, mel2ph, f0, depth=depth, steps=steps, noise=noise,
            **self.encode_kwargs(extras)).diff_out


class DiffSingerAcousticExporter(BaseExporter):
    DEFAULT_BUCKETS = ((64, 512),)

    def __init__(self, hparams, export_dir, ckpt_steps: Optional[int] = None,
                 freeze_gender: Optional[float] = None, freeze_velocity=False,
                 export_spk=None, freeze_spk=None, buckets=None, fmt: str = "pt2",
                 device=None):
        super().__init__(hparams, export_dir, fmt=fmt, device=device)
        from diffsinger_tpu_torch.inference.ds_acoustic import DiffSingerAcousticInfer

        self.infer = DiffSingerAcousticInfer(self.hparams, load_vocoder=False,
                                             ckpt_steps=ckpt_steps, device=self.device)
        self.model = self.infer.model
        self.model.module.requires_grad_(False)
        # the gender / velocity inputs exist unless frozen: --freeze_gender g
        # bakes the mapped key shift, --freeze_velocity bakes speed 1
        self.expose_gender = freeze_gender is None
        self.freeze_gender = 0.0 if freeze_gender is None else float(freeze_gender)
        if not -1.0 <= self.freeze_gender <= 1.0:
            raise ValueError("freeze_gender must be in [-1, 1]")
        self.expose_velocity = not freeze_velocity
        self.export_spk, self.freeze_spk = self._resolve_spk_settings(
            export_spk, freeze_spk, self.infer.spk_map)
        # (t_txt, t_mel) buckets, one artifact each; the runtime picks the
        # smallest that fits. The first keeps unsuffixed file names.
        self.buckets = [tuple(b) for b in (buckets or self.DEFAULT_BUCKETS)]
        self.bucket_files: dict = {}
        self._extra_names: list = []

    @property
    def model_name(self) -> str:
        """Artifact file stem; a frozen speaker adds its alias."""
        name = self.hparams["exp_name"] or "acoustic"
        if self.freeze_spk is not None:
            name += "." + self.freeze_spk[0]
        return name

    def _spk_table(self):
        return self.model.module.fs2.spk_embed.weight

    def _conditioning(self):
        """(extra input specs [(name, example(t_txt, t_mel))], frozen values)."""
        hp = self.hparams
        dev = self.device
        specs, frozen = [], {}
        if hp.get("use_lang_id", False):
            specs.append(("languages", lambda tt, tm: torch.zeros((1, tt), dtype=torch.int32,
                                                                  device=dev)))
        if hp.get("use_spk_id", False):
            hidden = hp["hidden_size"]
            if self.freeze_spk is not None:
                emb = self._spk_mix_embed(self._spk_table(), self.infer.spk_map,
                                          self.freeze_spk[1])
                frozen["spk_mix_embed"] = torch.from_numpy(emb)[None, None, :].to(dev)
            else:
                specs.append(("spk_embed", lambda tt, tm: torch.zeros((1, tm, hidden),
                                                                      device=dev)))
        for v in VARIANCES:
            if hp.get(f"use_{v}_embed", False):
                specs.append((v, lambda tt, tm: torch.zeros((1, tm), device=dev)))
        shift_range = speed_range = None
        if hp.get("use_key_shift_embed", False):
            shift_min, shift_max = hp["augmentation_args"]["random_pitch_shifting"]["range"]
            shift_range = (float(shift_min), float(shift_max))
            if self.expose_gender:
                specs.append(("gender", lambda tt, tm: torch.zeros((1, tm), device=dev)))
            else:
                g = self.freeze_gender
                shift = 0.0 if g == 0.0 else (g * shift_range[1] if g >= 0
                                              else g * abs(shift_range[0]))
                frozen["key_shift"] = torch.full((1, 1), shift, device=dev)
        if hp.get("use_speed_embed", False):
            speed_min, speed_max = hp["augmentation_args"]["random_time_stretching"]["range"]
            speed_range = (float(speed_min), float(speed_max))
            if self.expose_velocity:
                specs.append(("velocity", lambda tt, tm: torch.ones((1, tm), device=dev)))
            else:
                frozen["speed"] = torch.ones((1, 1), device=dev)
        return specs, frozen, shift_range, speed_range

    def _depth0(self) -> float:
        hp = self.hparams
        return min(hp.get("K_step_infer", hp.get("K_step", 1000)),
                   hp.get("K_step", 1000)) / hp.get("timesteps", 1000)

    def export_model(self):
        hp = self.hparams
        name = self.model_name
        dev = self.device
        specs, frozen, shift_range, speed_range = self._conditioning()
        self._extra_names = extra_names = [s[0] for s in specs]
        views = {view: AcousticProgram(self.model, view, extra_names, frozen, shift_range,
                                       speed_range)
                 for view in ("fs2_aux", "acoustic")}
        shallow = self.model.use_shallow_diffusion
        # example values only: depth and steps are inputs of the programs; they
        # stay on the host, where the samplers keep their counters
        depth0 = torch.tensor(self._depth0(), dtype=torch.float32)
        steps0 = torch.tensor(hp.get("sampling_steps", 20), dtype=torch.int32)
        n_mels = hp["audio_num_mel_bins"]
        for i, (t_txt, t_mel) in enumerate(self.buckets):
            suffix = "" if i == 0 else f".b{t_txt}x{t_mel}"
            tokens = torch.zeros((1, t_txt), dtype=torch.int32, device=dev)
            mel2ph = torch.zeros((1, t_mel), dtype=torch.int32, device=dev)
            f0 = torch.full((1, t_mel), 220.0, device=dev)
            noise = torch.zeros((1, t_mel, n_mels), device=dev)
            extras = [ex(t_txt, t_mel) for _, ex in specs]
            fs2_ep = self._trace(views["fs2_aux"], (tokens, mel2ph, f0, *extras))
            ac_ep = self._trace(views["acoustic"],
                                (tokens, mel2ph, f0, depth0, steps0, noise, *extras))
            files = {}
            if self.want_pt2:
                files["fs2_aux"] = f"{name}.fs2_aux{suffix}.pt2"
                files["acoustic"] = f"{name}.diffusion{suffix}.pt2"
                self._save_pt2(fs2_ep, self.export_dir / files["fs2_aux"])
                self._save_pt2(ac_ep, self.export_dir / files["acoustic"])
            if self.want_onnx:
                files["fs2_aux_onnx"] = f"{name}.fs2_aux{suffix}.onnx"
                files["acoustic_onnx"] = f"{name}.acoustic{suffix}.onnx"
                self._save_onnx(fs2_ep, self.export_dir / files["fs2_aux_onnx"],
                                input_names=["tokens", "mel2ph", "f0", *extra_names],
                                output_names=["condition", "aux_mel"] if shallow
                                else ["condition"])
                # `depth` is a public input only of shallow models; otherwise
                # it is baked in, as in the reference's signature
                self._save_onnx(ac_ep, self.export_dir / files["acoustic_onnx"],
                                input_names=["tokens", "mel2ph", "f0", "depth", "steps",
                                             "noise", *extra_names],
                                output_names=["mel"], internal_noise=["noise"],
                                internal_constants=({} if shallow else
                                                    {"depth": np.float32(depth0.item())}))
            self.bucket_files[f"{t_txt}x{t_mel}"] = files

    def export_attachments(self):
        hp = self.hparams
        first = next(iter(self.bucket_files.values()), {})
        manifest = {
            "flavor": self.fmt,
            "device": self.device.type,
            "acoustic": first.get("acoustic_onnx" if self.fmt == "onnx" else "acoustic",
                                  f"{self.model_name}.diffusion.pt2"),
            "vocoder": hp.get("vocoder", "NsfHifiGAN"),
            "phonemes": "phonemes.json",
            "hidden_size": hp["hidden_size"],
            "mel_base": str(hp.get("mel_base", "e")),
            "sample_rate": hp["audio_sample_rate"],
            "hop_size": hp["hop_size"],
            "win_size": hp["win_size"],
            "fft_size": hp["fft_size"],
            "num_mel_bins": hp["audio_num_mel_bins"],
            "mel_fmin": hp["fmin"],
            "mel_fmax": (hp["fmax"] if hp.get("fmax") is not None
                         else hp["audio_sample_rate"] / 2),
            "mel_scale": "slaney",
            "use_lang_id": bool(hp.get("use_lang_id", False)),
            # exposure, not training config: the consumer feeds gender /
            # velocity only when the graphs have those inputs
            "use_key_shift_embed": bool(
                hp.get("use_key_shift_embed", False) and self.expose_gender),
            "use_speed_embed": bool(
                hp.get("use_speed_embed", False) and self.expose_velocity),
            "use_shallow_diffusion": hp.get("use_shallow_diffusion", False),
            **{f"use_{v}_embed": bool(hp.get(f"use_{v}_embed", False)) for v in VARIANCES},
            "use_continuous_acceleration": True,
            "use_variable_depth": hp.get("use_shallow_diffusion", False),
            "sampling_steps": hp.get("sampling_steps", 20),
            "max_depth": (
                self._depth0() if hp.get("diffusion_type", "ddpm") == "ddpm"
                else 1.0 - float(hp.get("T_start_infer", hp.get("T_start", 0.4)))),
            "speakers": [f"{hp['exp_name'] or 'acoustic'}.{alias}"
                         for alias, _ in self.export_spk],
            # the ordered conditioning inputs after (tokens, mel2ph, f0[, depth,
            # steps, noise]) in every program's signature
            "extra_inputs": list(self._extra_names),
            "buckets": self.bucket_files,
        }
        if hp.get("use_key_shift_embed", False) and self.expose_gender:
            manifest["augmentation_args"] = {"random_pitch_shifting": {
                "range": list(hp["augmentation_args"]["random_pitch_shifting"]["range"])}}
        lang_file = self._export_languages(self.infer.lang_map)
        if lang_file:
            manifest["languages"] = lang_file
        with open(self.export_dir / "dsconfig.yaml", "w") as f:
            yaml.safe_dump(manifest, f)
        print(f"| export: {self.export_dir / 'dsconfig.yaml'}")
        self._export_phonemes(self.infer.phoneme_dictionary)
        self._export_dictionaries()
        if self.export_spk:
            self._export_spk_embeds(self._spk_table(), self.infer.spk_map, self.export_spk,
                                    hp["exp_name"] or "acoustic")


class VarianceProgram(nn.Module):
    """A traceable view of the variance model with the deployed inputs, in the
    order of ``input_names`` (the manifest's ``inputs`` of the view, then
    ``noise`` for the sampling views).

    ``view`` 'linguistic': (tokens, midi, ph2word, word_dur[, ph_spk_embed][,
    languages]) -> (encoder_out, ph_dur_pred); 'pitch': the inputs of
    ``DiffSingerVariance.forward_pitch_deployed``, ``steps`` and ``noise`` ->
    the absolute pitch; 'variance': those of ``forward_variance_deployed`` ->
    the curves in ``var_list`` order. A sampling view draws nothing: its
    ``noise`` is an input. ``frozen_spk`` [1, 1, H] stands for the speaker
    inputs of a frozen speaker mix; ``glide_frozen`` feeds the glide embed
    its 'none' row.
    """

    PARTS = {"linguistic": ("fs2",),
             "pitch": ("melody_encoder", "delta_pitch_embed", "base_pitch_embed",
                       "pitch_retake_embed", "pitch_predictor"),
             "variance": ("pitch_embed", "variance_embeds", "variance_predictor")}

    def __init__(self, model, view: str, input_names, frozen_spk=None,
                 glide_frozen: bool = False):
        super().__init__()
        # the parameters the view reads, so that a program holds no others
        for part in self.PARTS[view]:
            if hasattr(model.module, part):
                setattr(self, part, getattr(model.module, part))
        self.model = model
        self.view = view
        self.input_names = list(input_names)
        self.glide_frozen = glide_frozen
        self.register_buffer("frozen_spk", frozen_spk)

    def forward(self, *args):
        a = dict(zip(self.input_names, args))
        spk = a.get("spk_embed", self.frozen_spk)
        if self.view == "linguistic":
            kwargs = {"languages": a.get("languages"),
                      "ph_spk_mix_embed": a.get("ph_spk_embed", self.frozen_spk)}
            return self.model.module.encode(a["tokens"], a["midi"], a["ph2word"],
                                            word_dur=a["word_dur"], **kwargs)
        if self.view == "pitch":
            glide = a.get("note_glide")
            if glide is None and self.glide_frozen:
                glide = torch.zeros_like(a["note_dur"])
            return self.model.forward_pitch_deployed(
                a["encoder_out"], a["ph_dur"], a["note_midi"], a["note_dur"], a["pitch"],
                a["retake"], note_rest=a.get("note_rest"), note_glide=glide, expr=a.get("expr"),
                spk_mix_embed=spk, steps=a["steps"], noise=a["noise"])
        return self.model.forward_variance_deployed(
            a["encoder_out"], a["ph_dur"], a["pitch"],
            {v: a[v] for v in self.model.var_list}, a["retake"], spk_mix_embed=spk,
            steps=a["steps"], noise=a["noise"])


class DiffSingerVarianceExporter(BaseExporter):
    """The variance model's bundle: per bucket (t_ph, t_mel) the linguistic
    view (encoder and duration predictor) and, where the model predicts
    them, the pitch and variance views, as ``.pt2`` programs and/or ONNX
    graphs, with ``dsconfig.yaml`` (the per-view ``inputs``), phonemes,
    dictionaries and speaker ``.emb`` files.

    ``freeze_expr`` drops the pitch view's ``expr`` input (the retake
    embedding's own rows), ``freeze_glide`` its ``note_glide`` input (glide
    'none'); a frozen speaker mix replaces the speaker inputs of every view.
    """

    DEFAULT_BUCKETS = ((64, 512),)

    def __init__(self, hparams, export_dir, ckpt_steps: Optional[int] = None,
                 freeze_expr: bool = False, freeze_glide: bool = False, export_spk=None,
                 freeze_spk=None, buckets=None, fmt: str = "pt2", device=None):
        super().__init__(hparams, export_dir, fmt=fmt, device=device)
        from diffsinger_tpu_torch.inference.ds_variance import DiffSingerVarianceInfer

        self.infer = DiffSingerVarianceInfer(self.hparams, ckpt_steps=ckpt_steps,
                                             device=self.device)
        self.model = self.infer.model
        self.model.module.requires_grad_(False)
        self.expose_expr = not freeze_expr
        self.freeze_glide = bool(freeze_glide)
        self.export_spk, self.freeze_spk = self._resolve_spk_settings(
            export_spk, freeze_spk, self.infer.spk_map)
        self.buckets = [tuple(b) for b in (buckets or self.DEFAULT_BUCKETS)]
        self.bucket_files: dict = {}
        self._input_names: dict = {}

    @property
    def model_name(self) -> str:
        name = self.hparams["exp_name"] or "variance"
        if self.freeze_spk is not None:
            name += "." + self.freeze_spk[0]
        return name

    def _specs(self, frozen: bool) -> dict:
        """{view: [(input name, example(t_ph, t_mel))]}, the manifest's order."""
        hp = self.hparams
        model = self.model
        dev = self.device
        hidden = hp["hidden_size"]
        spk_input = hp.get("use_spk_id", False) and not frozen
        use_melody = model.use_melody_encoder
        use_glide = use_melody and hp.get("use_glide_embed", False) and not self.freeze_glide
        i32 = torch.int32

        def full(shape_fn, value=0, dtype=torch.float32):
            return lambda tp, tm: torch.full(shape_fn(tp, tm), value, dtype=dtype, device=dev)

        ph, mel = (lambda tp, tm: (1, tp)), (lambda tp, tm: (1, tm))
        spk = [("spk_embed", full(lambda tp, tm: (1, 1, hidden)))] if spk_input else []
        # steps stays on the host, where the samplers keep their counters
        steps = ("steps", lambda tp, tm: torch.tensor(hp.get("sampling_steps", 20), dtype=i32))
        linguistic = ([("tokens", full(ph, 0, i32)), ("midi", full(ph, 0, i32)),
                       ("ph2word", full(ph, 0, i32)), ("word_dur", full(ph, 1.0))]
                      + ([("ph_spk_embed", full(lambda tp, tm: (1, 1, hidden)))]
                         if spk_input else [])
                      + ([("languages", full(ph, 0, i32))] if hp.get("use_lang_id", False)
                         else []))
        pitch = ([("encoder_out", full(lambda tp, tm: (1, tp, hidden))),
                  ("ph_dur", full(ph, 1, i32)), ("note_midi", full(ph, 60.0))]
                 + ([("note_rest", full(ph, False, torch.bool))] if use_melody else [])
                 + [("note_dur", full(ph, 1, i32))]
                 + ([("note_glide", full(ph, 0, i32))] if use_glide else [])
                 + [("pitch", full(mel, 60.0))]
                 + ([("expr", full(mel, 1.0))] if self.expose_expr else [])
                 + [("retake", full(mel, True, torch.bool))] + spk + [steps])
        n_var = len(model.var_list)
        variance = ([("encoder_out", full(lambda tp, tm: (1, tp, hidden))),
                     ("ph_dur", full(ph, 1, i32)), ("pitch", full(mel, 60.0))]
                    + [(v, full(mel)) for v in model.var_list]
                    + [("retake", full(lambda tp, tm: (1, tm, n_var), True, torch.bool))]
                    + spk + [steps])
        return {"linguistic": linguistic, "pitch": pitch, "variance": variance}

    def export_model(self):
        hp = self.hparams
        model = self.model
        name = self.model_name
        frozen_spk = None
        if hp.get("use_spk_id", False) and self.freeze_spk is not None:
            emb = self._spk_mix_embed(model.module.spk_embed.weight, self.infer.spk_map,
                                      self.freeze_spk[1])
            frozen_spk = torch.from_numpy(emb)[None, None, :].to(self.device)
        specs = self._specs(frozen_spk is not None)
        self._input_names = {view: [n for n, _ in spec] for view, spec in specs.items()}
        glide_frozen = (model.use_melody_encoder and hp.get("use_glide_embed", False)
                        and self.freeze_glide)
        views = (["linguistic"] + (["pitch"] if model.predict_pitch else [])
                 + (["variance"] if model.var_list else []))
        widths = {"pitch": hp["pitch_prediction_args"]["repeat_bins"] if model.predict_pitch
                  else 0,
                  "variance": (hp["variances_prediction_args"]["total_repeat_bins"]
                               if model.var_list else 0)}
        outputs = {"linguistic": ["encoder_out", "ph_dur_pred"], "pitch": ["pitch_pred"],
                   "variance": [f"{v}_pred" for v in model.var_list]}
        for i, (t_ph, t_mel) in enumerate(self.buckets):
            suffix = "" if i == 0 else f".b{t_ph}x{t_mel}"
            files = {}
            for view in views:
                names = list(self._input_names[view])
                examples = [ex(t_ph, t_mel) for _, ex in specs[view]]
                if view != "linguistic":
                    names.append("noise")
                    examples.append(torch.zeros((1, t_mel, widths[view]), device=self.device))
                ep = self._trace(VarianceProgram(model, view, names, frozen_spk, glide_frozen),
                                 examples)
                if self.want_pt2:
                    stem = "linguistic_dur" if view == "linguistic" else view
                    files[view] = f"{name}.{stem}{suffix}.pt2"
                    self._save_pt2(ep, self.export_dir / files[view])
                if self.want_onnx:
                    files[f"{view}_onnx"] = f"{name}.{view}{suffix}.onnx"
                    self._save_onnx(ep, self.export_dir / files[f"{view}_onnx"],
                                    input_names=names, output_names=outputs[view],
                                    internal_noise=["noise"] if view != "linguistic" else ())
            self.bucket_files[f"{t_ph}x{t_mel}"] = files

    def export_attachments(self):
        hp = self.hparams
        first = next(iter(self.bucket_files.values()), {})
        manifest = {
            "flavor": self.fmt,
            "device": self.device.type,
            "linguistic": first.get("linguistic_onnx" if self.fmt == "onnx" else "linguistic",
                                    f"{self.model_name}.linguistic_dur.pt2"),
            "phonemes": "phonemes.json",
            "hidden_size": hp["hidden_size"],
            "predict_dur": hp["predict_dur"],
            "predict_pitch": hp["predict_pitch"],
            **{f"predict_{v}": v in self.model.var_list for v in VARIANCES},
            # steps is an input of the sampling views
            "use_continuous_acceleration": True,
            "sampling_steps": hp.get("sampling_steps", 20),
            "sample_rate": hp["audio_sample_rate"],
            "hop_size": hp["hop_size"],
            "speakers": [f"{hp['exp_name'] or 'variance'}.{alias}"
                         for alias, _ in self.export_spk],
            "buckets": self.bucket_files,
            "use_lang_id": bool(hp.get("use_lang_id", False)),
            # each view's ordered inputs (the sampling views' ``noise`` after
            # them: an input of a .pt2, drawn inside an ONNX graph)
            "inputs": self._input_names,
        }
        if hp["predict_pitch"]:
            melody = self.model.use_melody_encoder
            manifest["use_expr"] = bool(self.expose_expr)
            manifest["use_note_rest"] = bool(melody)
            manifest["use_glide_embed"] = bool(melody and hp.get("use_glide_embed", False)
                                               and not self.freeze_glide)
        lang_file = self._export_languages(self.infer.lang_map)
        if lang_file:
            manifest["languages"] = lang_file
        with open(self.export_dir / "dsconfig.yaml", "w") as f:
            yaml.safe_dump(manifest, f)
        print(f"| export: {self.export_dir / 'dsconfig.yaml'}")
        self._export_phonemes(self.infer.phoneme_dictionary)
        self._export_dictionaries()
        if self.export_spk:
            self._export_spk_embeds(self.model.module.spk_embed.weight, self.infer.spk_map,
                                    self.export_spk, hp["exp_name"] or "variance")


class VocoderProgram(nn.Module):
    """(mel, f0, *draws) -> waveform. A full-NSF generator's draws are inputs
    (``noise_names``: ``rand_ini``, ``source``, and ``sigma`` when
    ``noise_sigma`` > 0), so the program itself draws nothing."""

    def __init__(self, generator, noise_names):
        super().__init__()
        self.generator = generator
        self.noise_names = list(noise_names)

    def forward(self, mel, f0, *draws):
        from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import VocoderNoise

        return self.generator(mel, f0, noise=VocoderNoise(**dict(zip(self.noise_names, draws))))


class NSFHiFiGANExporter(BaseExporter):
    DEFAULT_BUCKETS = (512,)

    def __init__(self, hparams, export_dir, buckets=None, fmt: str = "pt2", device=None):
        super().__init__(hparams, export_dir, fmt=fmt, device=device)
        from diffsinger_tpu_torch.vocoders.nsf_hifigan import NsfHifiGAN

        self.vocoder = NsfHifiGAN(self.hparams, device=self.device)
        self.vocoder.model.requires_grad_(False)
        cfg = self.vocoder.config
        self.noise_names = [] if cfg.mini_nsf else ["rand_ini", "source"]
        if cfg.noise_sigma:
            self.noise_names.append("sigma")
        if self.want_onnx and self.noise_names:
            raise ValueError(
                "this vocoder draws random numbers (the full-NSF source or noise_sigma), "
                "which the ONNX lowering cannot hold, as the JAX package's cannot: export "
                "it with --format pt2, or a mini-NSF vocoder to ONNX")
        self.buckets = [int(b) for b in (buckets or self.DEFAULT_BUCKETS)]
        self.bucket_files: dict = {}

    def export_model(self):
        cfg = self.vocoder.config
        dev = self.device
        program = VocoderProgram(self.vocoder.model, self.noise_names)
        for i, t_mel in enumerate(self.buckets):
            suffix = "" if i == 0 else f".b{t_mel}"
            draws = {"rand_ini": torch.zeros((1, 1, 9), device=dev),
                     "source": torch.zeros((1, t_mel * cfg.hop_size, 9), device=dev),
                     "sigma": torch.zeros((1, t_mel, cfg.upsample_initial_channel),
                                          device=dev)}
            ep = self._trace(program, (torch.zeros((1, t_mel, cfg.num_mels), device=dev),
                                       torch.full((1, t_mel), 220.0, device=dev),
                                       *(draws[n] for n in self.noise_names)))
            files = {}
            if self.want_pt2:
                files["model"] = f"nsf_hifigan{suffix}.pt2"
                self._save_pt2(ep, self.export_dir / files["model"])
            if self.want_onnx:
                files["model_onnx"] = f"nsf_hifigan{suffix}.onnx"
                self._save_onnx(ep, self.export_dir / files["model_onnx"],
                                input_names=["mel", "f0"], output_names=["waveform"])
            self.bucket_files[str(t_mel)] = files

    def export_attachments(self):
        cfg = self.vocoder.config
        first = next(iter(self.bucket_files.values()), {})
        manifest = {
            "flavor": self.fmt,
            "device": self.device.type,
            "model": first.get("model_onnx" if self.fmt == "onnx" else "model",
                               "nsf_hifigan.pt2"),
            "sample_rate": cfg.sampling_rate,
            "hop_size": cfg.hop_size,
            "num_mel_bins": cfg.num_mels,
            "mel_base": "e",
            # the draws a .pt2 takes after mel and f0, in order
            "noise_inputs": list(self.noise_names),
            "buckets": self.bucket_files,
        }
        with open(self.export_dir / "vocoder.yaml", "w") as f:
            yaml.safe_dump(manifest, f)
        print(f"| export: {self.export_dir / 'vocoder.yaml'}")

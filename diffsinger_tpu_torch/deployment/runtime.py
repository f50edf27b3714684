"""Artifact runtimes: serve exported ``.pt2`` bundles without model code
(counterpart of diffsinger_tpu/deployment/runtime.py): acoustic, variance
and vocoder bundles.

A runtime reads the manifest the exporter wrote (``dsconfig.yaml`` or
``vocoder.yaml``), picks the smallest bucket that fits the input, pads,
runs the loaded program (``torch.export.load(...).module()``) and trims the
output. The programs call the kernels' custom ops (``ds::``), which the
imports below register: on the card they launch K2 and K3. Programs are
called from a roomy frame (``utils.frames.with_room``). A runtime serves
only a bundle exported for its own device type: it does not move a program
between devices. Float32 programs run with TF32 off (``utils.no_tf32``), as
the eager float32 models do.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import yaml

from diffsinger_tpu_torch.models.acoustic_encoder import VARIANCE_CHECKLIST
# registers the ds:: custom ops that the programs call
from diffsinger_tpu_torch.ops import depthwise_conv, flash_attention, lynx_fused  # noqa: F401
from diffsinger_tpu_torch.utils import no_tf32, resolve_device
from diffsinger_tpu_torch.utils.frames import with_room


def _pad_axis1(arr: np.ndarray, length: int, value=0) -> np.ndarray:
    pad = length - arr.shape[1]
    if pad < 0:
        raise ValueError(f"input length {arr.shape[1]} exceeds bucket {length}")
    if pad == 0:
        return arr
    widths = [(0, 0), (0, pad)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, widths, constant_values=value)


def _check_bundle(manifest: dict, device: torch.device):
    """Refuse an ONNX-only bundle (it has no .pt2 programs) and one exported
    for another device type than the runtime's."""
    flavor = manifest.get("flavor", "pt2")
    if flavor not in ("pt2", "both"):
        raise ValueError(
            f"bundle flavor is {flavor!r}; the artifact runtimes load .pt2 bundles only: "
            "re-export with --format pt2 (or 'both'), or serve the .onnx graphs with an "
            "ONNX runtime.")
    exported_on = manifest.get("device")
    if exported_on != device.type:
        raise ValueError(
            f"the bundle was exported for {exported_on!r}, this runtime runs on "
            f"{device.type!r}: export it again on that device (--device)")


class _Programs:
    """Loaded programs of a bundle, by file name."""

    def __init__(self, bundle_dir: pathlib.Path):
        self.dir = bundle_dir
        self._loaded: Dict[str, torch.nn.Module] = {}

    def __getitem__(self, filename: str) -> torch.nn.Module:
        if filename not in self._loaded:
            self._loaded[filename] = torch.export.load(str(self.dir / filename)).module()
        return self._loaded[filename]


class _BundleRuntime:
    """Load a bundle's ``dsconfig.yaml``, refuse what the runtime cannot
    serve, and hold its bucket table: [(t_short, t_mel, files), ...] sorted
    by mel length, then by the text or phoneme length ``t_short``."""

    def __init__(self, bundle_dir, device=None):
        self.dir = pathlib.Path(bundle_dir)
        self.device = resolve_device(device)
        with open(self.dir / "dsconfig.yaml") as f:
            self.manifest = yaml.safe_load(f)
        _check_bundle(self.manifest, self.device)
        buckets = self.manifest.get("buckets") or {}
        if not buckets:
            raise ValueError("manifest has no bucket table")
        self.buckets = sorted((tuple(int(d) for d in key.split("x")) + (files,)
                               for key, files in buckets.items()),
                              key=lambda b: (b[1], b[0]))
        self.programs = _Programs(self.dir)

    def pick_bucket(self, t_short: int, t_mel: int) -> Tuple[int, int, dict]:
        """The smallest bucket that holds ``t_short`` tokens and ``t_mel`` frames."""
        for bt, bm, files in self.buckets:
            if t_short <= bt and t_mel <= bm:
                return bt, bm, files
        raise ValueError(f"no exported bucket fits (t_short={t_short}, t_mel={t_mel}); "
                         f"available: {[(b[0], b[1]) for b in self.buckets]}")


class AcousticArtifactRuntime(_BundleRuntime):
    """Serve an exported acoustic bundle: (tokens, mel2ph, f0) -> mel.

    :param bundle_dir: the folder with ``dsconfig.yaml`` and the ``.pt2``
        programs of ``DiffSingerAcousticExporter``
    :param device: the device to run on: the card unless the caller names
        another; it must be the one the bundle was exported for
    """

    def synthesize_mel(self, tokens: np.ndarray, mel2ph: np.ndarray, f0: np.ndarray,
                       seed: int = 0, depth: Optional[float] = None,
                       steps: Optional[int] = None, gender: Optional[np.ndarray] = None,
                       velocity: Optional[np.ndarray] = None,
                       noise: Optional[torch.Tensor] = None, **extras) -> np.ndarray:
        """tokens [1, T_txt] int; mel2ph [1, T_mel] int; f0 [1, T_mel] Hz ->
        mel [1, T_mel, M] float32, trimmed to the input's length.

        ``depth`` and ``steps`` default to the manifest's ``max_depth`` and
        ``sampling_steps``. The sampler's noise [1, bucket T_mel, M] is drawn
        from a ``torch.Generator`` on the device seeded with ``seed``, unless
        ``noise`` gives it. ``gender`` and ``velocity`` [1, T_mel] default to
        their neutral values (0 and 1); other conditioning inputs of the
        manifest's ``extra_inputs`` (``languages``, ``spk_embed``, variance
        curves) are keyword arguments.
        """
        if depth is None:
            depth = float(self.manifest.get("max_depth", 1.0))
        if steps is None:
            steps = int(self.manifest.get("sampling_steps", 20))
        t_txt, t_mel = tokens.shape[1], mel2ph.shape[1]
        bt, bm, files = self.pick_bucket(t_txt, t_mel)
        dev = self.device

        def on_device(arr, length, value=0, dtype=np.float32):
            return torch.from_numpy(_pad_axis1(np.asarray(arr, dtype), length, value)).to(dev)

        args = []
        for name in self.manifest.get("extra_inputs", []):
            if name == "gender":
                g = np.zeros((1, t_mel), np.float32) if gender is None else gender
                args.append(on_device(g, bm))
            elif name == "velocity":
                v = np.ones((1, t_mel), np.float32) if velocity is None else velocity
                args.append(on_device(v, bm, value=1.0))
            elif name == "languages":
                args.append(on_device(extras[name], bt, dtype=np.int32))
            elif name in extras:
                args.append(on_device(extras[name], bm))
            else:
                raise ValueError(f"the bundle takes a '{name}' input, which has no neutral "
                                 "value: pass it as a keyword argument")
        if noise is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            noise = torch.randn((1, bm, int(self.manifest["num_mel_bins"])), generator=gen,
                                device=dev)
        program = self.programs[files["acoustic"]]
        with torch.no_grad(), no_tf32():
            mel = with_room(program, on_device(tokens, bt, dtype=np.int32),
                            on_device(mel2ph, bm, dtype=np.int32),
                            on_device(f0, bm, value=220.0),
                            torch.tensor(depth, dtype=torch.float32),
                            torch.tensor(steps, dtype=torch.int32), noise.to(dev), *args)
        return mel[:, :t_mel].cpu().numpy()


class VarianceArtifactRuntime(_BundleRuntime):
    """Serve an exported variance bundle through its deployed views: the
    linguistic view (tokens -> encoder_out, ph_dur_pred), then the pitch and
    variance views, which take ``encoder_out``, frame durations, the notes,
    the current pitch and curves, a retake mask and ``expr``, and align,
    smooth and blend inside the program.

    Each view's inputs come in the manifest's ``inputs`` order, padded to the
    bucket; what the caller leaves out takes its neutral value (retake all
    frames, expr 1, note_rest and glide 0, curves 0). The sampling views'
    noise is drawn from a ``torch.Generator`` on the device seeded with
    ``seed`` unless ``noise`` gives it.
    """

    # input -> (axis-1 length: 'ph' or 'mel', pad value, dtype)
    PADS = {"tokens": ("ph", 0, np.int32), "midi": ("ph", 0, np.int32),
            "ph2word": ("ph", 0, np.int32), "word_dur": ("ph", 0, np.float32),
            "languages": ("ph", 0, np.int32), "encoder_out": ("ph", 0, np.float32),
            "ph_dur": ("ph", 0, np.int32), "note_midi": ("ph", 0, np.float32),
            "note_rest": ("ph", True, np.bool_), "note_dur": ("ph", 0, np.int32),
            "note_glide": ("ph", 0, np.int32), "pitch": ("mel", 0, np.float32),
            "expr": ("mel", 1.0, np.float32), "retake": ("mel", True, np.bool_)}

    def __init__(self, bundle_dir, device=None):
        super().__init__(bundle_dir, device)
        if "linguistic" not in self.manifest:
            raise ValueError("not a variance bundle: its manifest has no 'linguistic' view")
        self.inputs = self.manifest.get("inputs") or {}

    def variance_names(self) -> list:
        return [v for v in VARIANCE_CHECKLIST if self.manifest.get(f"predict_{v}", False)]

    def _collect(self, view: str, given: dict, bp: int, bm: int) -> list:
        """The view's inputs before ``steps`` as tensors on the device, padded
        to the bucket, with the neutral value of each one not given."""
        t_mel = given["pitch"].shape[1] if "pitch" in given else bm
        args = []
        for name in self.inputs[view]:
            if name == "steps":
                continue
            val = given.get(name)
            if isinstance(val, torch.Tensor):  # encoder_out from encode(), on the device
                args.append(val.to(self.device))
                continue
            if val is None:
                if name == "retake":
                    shape = (1, t_mel) if view == "pitch" else (1, t_mel,
                                                                len(self.variance_names()))
                    val = np.ones(shape, bool)
                elif name == "expr":
                    val = np.ones((1, t_mel), np.float32)
                elif name in ("note_rest", "note_glide"):
                    val = np.zeros((1, given["note_midi"].shape[1]), np.int32)
                elif name in VARIANCE_CHECKLIST:
                    val = np.zeros((1, t_mel), np.float32)
                else:
                    raise ValueError(f"view '{view}' takes input '{name}', which has no "
                                     "neutral value: pass it as a keyword argument")
            if name in ("spk_embed", "ph_spk_embed"):  # one mix [H] or [1, 1, H]
                val = np.asarray(val, np.float32).reshape(1, 1, -1)
            else:
                axis, fill, dtype = self.PADS.get(name, ("mel", 0, np.float32))
                val = _pad_axis1(np.asarray(val, dtype), bp if axis == "ph" else bm, fill)
            args.append(torch.from_numpy(val).to(self.device))
        return args

    def _run(self, view: str, files: dict, args: list, steps: Optional[int], seed: int,
             noise: Optional[torch.Tensor]):
        program = self.programs[files[view]]
        if steps is None:
            steps = int(self.manifest.get("sampling_steps", 20))
        if noise is None:  # the shape of the program's last input
            shape = [n.meta["val"].shape for n in program.graph.nodes
                     if n.op == "placeholder"][-1]
            gen = torch.Generator(device=self.device).manual_seed(seed)
            noise = torch.randn(tuple(shape), generator=gen, device=self.device)
        with torch.no_grad(), no_tf32():
            return with_room(program, *args, torch.tensor(steps, dtype=torch.int32),
                             noise.to(self.device))

    def encode(self, tokens: np.ndarray, midi: np.ndarray, ph2word: np.ndarray,
               word_dur: np.ndarray, t_mel: int, **extra):
        """-> (encoder_out [1, bucket T_ph, H] on the device, ph_dur_pred
        [1, T_ph] numpy, bucket). ``encoder_out`` stays padded and on the
        device for the sampling views; ``bucket`` is the (t_ph, t_mel, files)
        they run in, chosen by ``tokens``' length and ``t_mel``."""
        t_ph = tokens.shape[1]
        bp, bm, files = bucket = self.pick_bucket(t_ph, t_mel)
        args = self._collect("linguistic", dict(tokens=tokens, midi=midi, ph2word=ph2word,
                                                word_dur=word_dur, **extra), bp, bm)
        with torch.no_grad(), no_tf32():
            enc, dur = with_room(self.programs[files["linguistic"]], *args)
        return enc, dur[:, :t_ph].cpu().numpy(), bucket

    def predict_pitch(self, encoder_out, ph_dur: np.ndarray, note_midi: np.ndarray,
                      note_dur: np.ndarray, pitch: np.ndarray, bucket, seed: int = 0,
                      steps: Optional[int] = None, noise: Optional[torch.Tensor] = None,
                      **extra) -> np.ndarray:
        """-> the absolute pitch [1, T_mel] (midi). ``ph_dur`` and ``note_dur``
        are integer frames; ``retake``, ``expr``, ``note_rest``, ``note_glide``
        and ``spk_embed`` are keyword arguments; ``noise`` [1, bucket T_mel,
        repeat_bins]."""
        bp, bm, files = bucket
        args = self._collect("pitch", dict(encoder_out=encoder_out, ph_dur=ph_dur,
                                           note_midi=note_midi, note_dur=note_dur,
                                           pitch=pitch, **extra), bp, bm)
        out = self._run("pitch", files, args, steps, seed, noise)
        return out[:, :pitch.shape[1]].cpu().numpy()

    def predict_variances(self, encoder_out, ph_dur: np.ndarray, pitch: np.ndarray, bucket,
                          seed: int = 0, steps: Optional[int] = None,
                          noise: Optional[torch.Tensor] = None, **extra) -> Dict[str, np.ndarray]:
        """-> {variance name: curve [1, T_mel]}. The input curves and a
        [1, T_mel, F] ``retake`` are keyword arguments; ``noise`` [1, bucket
        T_mel, total_repeat_bins]."""
        bp, bm, files = bucket
        args = self._collect("variance", dict(encoder_out=encoder_out, ph_dur=ph_dur,
                                              pitch=pitch, **extra), bp, bm)
        outs = self._run("variance", files, args, steps, seed, noise)
        return {v: o[:, :pitch.shape[1]].cpu().numpy()
                for v, o in zip(self.variance_names(), outs)}


class VocoderArtifactRuntime:
    """Serve an exported vocoder bundle: (mel, f0) -> waveform.

    A full-NSF program's draws (``noise_inputs`` of the manifest) come from a
    ``torch.Generator`` on the device seeded with ``seed``, in the
    generator's own order: the initial phases (uniform), the source noise and
    then the ``noise_sigma`` noise (standard normal).
    """

    def __init__(self, bundle_dir, device=None):
        self.dir = pathlib.Path(bundle_dir)
        self.device = resolve_device(device)
        with open(self.dir / "vocoder.yaml") as f:
            self.manifest = yaml.safe_load(f)
        _check_bundle(self.manifest, self.device)
        self.hop_size = int(self.manifest["hop_size"])
        self.buckets = sorted((int(k), v["model"]) for k, v in self.manifest["buckets"].items())
        self.programs = _Programs(self.dir)

    def _draws(self, program, seed: int) -> list:
        names = self.manifest.get("noise_inputs", [])
        if not names:
            return []
        # the shapes of the program's inputs after mel and f0
        shapes = [tuple(n.meta["val"].shape) for n in program.graph.nodes
                  if n.op == "placeholder"][-len(names):]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return [(torch.rand if name == "rand_ini" else torch.randn)(
            shape, generator=gen, device=self.device) for name, shape in zip(names, shapes)]

    def vocode(self, mel: np.ndarray, f0: np.ndarray, seed: int = 0) -> np.ndarray:
        """mel [1, T, M], f0 [1, T] -> waveform [1, T * hop_size] float32."""
        t_mel = mel.shape[1]
        for bm, filename in self.buckets:
            if t_mel <= bm:
                break
        else:
            raise ValueError(f"no exported vocoder bucket fits T={t_mel}; "
                             f"available: {[b for b, _ in self.buckets]}")
        program = self.programs[filename]
        dev = self.device
        with torch.no_grad(), no_tf32():
            wav = with_room(
                program, torch.from_numpy(_pad_axis1(np.asarray(mel, np.float32), bm)).to(dev),
                torch.from_numpy(_pad_axis1(np.asarray(f0, np.float32), bm,
                                            value=220.0)).to(dev),
                *self._draws(program, seed))
        return wav[:, : t_mel * self.hop_size].cpu().numpy()

"""Artifact runtimes: serve exported ``.pt2`` bundles without model code
(counterpart of diffsinger_tpu/deployment/runtime.py).

A runtime reads the manifest the exporter wrote (``dsconfig.yaml`` or
``vocoder.yaml``), picks the smallest bucket that fits the input, pads,
runs the loaded program (``torch.export.load(...).module()``) and trims the
output. The programs call the kernels' custom ops (``ds::``), which the
imports below register: on the card they launch K2 and K3. A runtime serves
only a bundle exported for its own device type: it does not move a program
between devices. Float32 programs run with TF32 off (``utils.no_tf32``), as
the eager float32 models do.
"""

from __future__ import annotations

import functools
import pathlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import yaml

# registers the ds:: custom ops that the programs call
from diffsinger_tpu_torch.ops import depthwise_conv, flash_attention, lynx_fused  # noqa: F401
from diffsinger_tpu_torch.utils import no_tf32, resolve_device


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


@functools.lru_cache(maxsize=None)
def _with_room():
    """``with_room(fn, *args)`` calls ``fn(*args)`` from a frame of about
    128 KiB.

    CPython keeps a thread's Python frames in chunks (16 KiB by default) and
    gives a chunk back as soon as the frame at its start returns, so a loop
    whose calls land across a chunk boundary takes and gives back a chunk on
    every call: up to 0.17 ms a call on an H100 machine's host, which made a
    loaded program's request 2-7x slower at the stack depths that put its op
    loop there (``tools/probe_pt2_host.py``). A frame this large starts a
    chunk of its own with about as much room after it, so no call of a
    request crosses a boundary, whatever the caller's depth."""
    names = " = ".join(f"_r{i}" for i in range(1 << 14))
    scope: dict = {}
    exec(compile(f"def with_room(fn, *args):\n    if False:\n        {names} = None\n"
                 "    return fn(*args)\n", "<with_room>", "exec"), scope)
    return scope["with_room"]


class _Programs:
    """Loaded programs of a bundle, by file name."""

    def __init__(self, bundle_dir: pathlib.Path):
        self.dir = bundle_dir
        self._loaded: Dict[str, torch.nn.Module] = {}

    def __getitem__(self, filename: str) -> torch.nn.Module:
        if filename not in self._loaded:
            self._loaded[filename] = torch.export.load(str(self.dir / filename)).module()
        return self._loaded[filename]


class AcousticArtifactRuntime:
    """Serve an exported acoustic bundle: (tokens, mel2ph, f0) -> mel.

    :param bundle_dir: the folder with ``dsconfig.yaml`` and the ``.pt2``
        programs of ``DiffSingerAcousticExporter``
    :param device: the device to run on: the card unless the caller names
        another; it must be the one the bundle was exported for
    """

    def __init__(self, bundle_dir, device=None):
        self.dir = pathlib.Path(bundle_dir)
        self.device = resolve_device(device)
        with open(self.dir / "dsconfig.yaml") as f:
            self.manifest = yaml.safe_load(f)
        _check_bundle(self.manifest, self.device)
        buckets = self.manifest.get("buckets") or {}
        if not buckets:
            raise ValueError("manifest has no bucket table")
        # [(t_txt, t_mel, files), ...] sorted by mel length, then text length
        self.buckets = sorted((tuple(int(d) for d in key.split("x")) + (files,)
                               for key, files in buckets.items()),
                              key=lambda b: (b[1], b[0]))
        self.programs = _Programs(self.dir)

    def pick_bucket(self, t_txt: int, t_mel: int) -> Tuple[int, int, dict]:
        for bt, bm, files in self.buckets:
            if t_txt <= bt and t_mel <= bm:
                return bt, bm, files
        raise ValueError(f"no exported bucket fits (t_txt={t_txt}, t_mel={t_mel}); "
                         f"available: {[(b[0], b[1]) for b in self.buckets]}")

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
            mel = _with_room()(program, on_device(tokens, bt, dtype=np.int32),
                               on_device(mel2ph, bm, dtype=np.int32),
                               on_device(f0, bm, value=220.0),
                               torch.tensor(depth, dtype=torch.float32),
                               torch.tensor(steps, dtype=torch.int32), noise.to(dev), *args)
        return mel[:, :t_mel].cpu().numpy()


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
            wav = _with_room()(
                program, torch.from_numpy(_pad_axis1(np.asarray(mel, np.float32), bm)).to(dev),
                torch.from_numpy(_pad_axis1(np.asarray(f0, np.float32), bm,
                                            value=220.0)).to(dev),
                *self._draws(program, seed))
        return wav[:, : t_mel * self.hop_size].cpu().numpy()

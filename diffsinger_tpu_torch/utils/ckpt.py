"""Checkpoints: discovery and loading for inference, saving and rotation
for training (counterpart of diffsinger_tpu/utils/ckpt.py).

The port's native format is the reference's: ``model_ckpt_steps_<N>.ckpt``
under the experiment folder, a ``torch.save``d dict with ``state_dict`` (keys
with or without Lightning's ``model.`` prefix) and ``category`` ('acoustic' or
'variance'); the trainer adds ``global_step``, ``epoch``, ``epoch_position`` (the epoch's
batches already trained on), and the optimizer and
scheduler states as Lightning stores them (``optimizer_states`` and
``lr_schedulers``, lists of one) and the optimizer's class name. The port's modules carry the reference's
parameter names, so the state dict loads strictly, without conversion.

The JAX trainer's ``model_ckpt_steps_<N>.dsckpt`` (``flax.serialization``'s
msgpack: numpy arrays as extension types) is read by a decoder of its own
here, through ``msgpack`` without flax, and its parameters are mapped to the port's names by
``utils/convert.py``; that needs the experiment's config. Its optax optimizer
state is not carried over. A folder holding ``.ckpt`` files is read for those;
one holding only ``.dsckpt`` files, for those.
"""

from __future__ import annotations

import pathlib
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

CKPT_PREFIX = "model_ckpt_steps_"
SUFFIXES = (".ckpt", ".dsckpt")

# legacy parameters the reference itself ignores at load
LEGACY_IGNORES = ("fs2.encoder.embed_tokens",)
# the reference's diffusion wrappers: their buffers (spec_min / spec_max, the
# DDPM schedule tables) sit directly under them, the backbone one level deeper;
# the port computes the buffers from the hparams
WRAPPERS = ("diffusion", "pitch_predictor", "variance_predictor")


def is_buffer_key(key: str) -> bool:
    """A buffer of a diffusion wrapper, e.g. ``diffusion.spec_min`` or
    ``pitch_predictor.alphas_cumprod`` (not ``diffusion.denoise_fn.*``)."""
    head, _, rest = key.partition(".")
    return head in WRAPPERS and bool(rest) and "." not in rest


def checkpoint_path(work_dir, steps: int) -> pathlib.Path:
    return pathlib.Path(work_dir) / f"{CKPT_PREFIX}{steps}.ckpt"


def list_checkpoints(work_dir, suffix: str = ".ckpt") -> List[Tuple[int, pathlib.Path]]:
    """All (steps, path) under work_dir with ``suffix``, sorted ascending by step."""
    work_dir = pathlib.Path(work_dir)
    if not work_dir.exists():
        return []
    pattern = re.compile(rf"{CKPT_PREFIX}(\d+){re.escape(suffix)}")
    found = []
    for p in work_dir.iterdir():
        m = pattern.fullmatch(p.name)
        if m:
            found.append((int(m.group(1)), p))
    return sorted(found)


def any_checkpoints(work_dir) -> List[Tuple[int, pathlib.Path]]:
    """The port's checkpoints of work_dir, else the JAX trainer's."""
    return list_checkpoints(work_dir) or list_checkpoints(work_dir, ".dsckpt")


def find_checkpoint(work_dir, ckpt_steps: Optional[int] = None) -> Tuple[int, pathlib.Path]:
    """The latest checkpoint, or the newest at or before ``ckpt_steps`` (the
    port's, else the JAX trainer's).

    Raises ``FileNotFoundError`` when the folder holds none that qualifies.
    """
    ckpts = any_checkpoints(work_dir)
    if not ckpts:
        raise FileNotFoundError(f"No checkpoints found in {work_dir}")
    if ckpt_steps is not None:
        ckpts = [(s, p) for s, p in ckpts if s <= ckpt_steps]
        if not ckpts:
            raise FileNotFoundError(
                f"No checkpoint at or before step {ckpt_steps} in {work_dir}")
    return ckpts[-1]


def strip_model_prefix(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop Lightning's ``model.`` prefix, the legacy keys and the buffers."""
    out = {}
    for k, v in state.items():
        k2 = k[len("model."):] if k.startswith("model.") else k
        if k2.startswith(LEGACY_IGNORES) or is_buffer_key(k2):
            continue
        out[k2] = v
    return out


def load_state_dict_for_inference(module: torch.nn.Module, work_dir, *, category: str,
                                  ckpt_steps: Optional[int] = None,
                                  hp: Optional[dict] = None) -> dict:
    """Find a checkpoint in ``work_dir`` and load it strictly into ``module``
    (``hp``, the experiment's config, maps a ``.dsckpt``'s parameters).

    Returns ``{"category", "global_step", "path"}``. Raises
    ``FileNotFoundError`` if there is no checkpoint, ``RuntimeError`` if the
    checkpoint's category is another one or its keys do not match the module.
    """
    step, path = find_checkpoint(work_dir, ckpt_steps)
    ckpt = load_checkpoint(path, category=category, hp=hp)
    module.load_state_dict(strip_model_prefix(ckpt.get("state_dict", ckpt)), strict=True)
    print(f"| load '{path}' (step {step})")
    return {"category": category, "global_step": step, "path": path}


def save_checkpoint(path, module: torch.nn.Module, *, category: str, global_step: int,
                    epoch: int = 0, epoch_position: int = 0, optimizer=None,
                    scheduler=None) -> None:
    """Write a training checkpoint in the reference layout; the file appears
    whole (written beside it, then renamed). ``epoch_position`` is the count
    of ``epoch``'s batches already trained on."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = {
        "state_dict": {"model." + k: v.detach().cpu() for k, v in module.state_dict().items()},
        "category": category,
        "global_step": int(global_step),
        "epoch": int(epoch),
        "epoch_position": int(epoch_position),
    }
    if optimizer is not None:
        blob["optimizer_states"] = [optimizer.state_dict()]
        blob["optimizer_cls"] = type(optimizer).__name__
    if scheduler is not None:
        blob["lr_schedulers"] = [scheduler.state_dict()]
    tmp = path.with_name(path.name + ".tmp")
    torch.save(blob, tmp)
    tmp.replace(path)


def keep_checkpoints(work_dir, *, num_ckpt_keep: int, permanent_ckpt_start: int = 0,
                     permanent_ckpt_interval: int = -1) -> List[pathlib.Path]:
    """Keep the newest ``num_ckpt_keep`` checkpoints and the permanent ones
    (a step at or after ``permanent_ckpt_start`` and a multiple of
    ``permanent_ckpt_interval``); delete the rest and return their paths."""
    ckpts = list_checkpoints(work_dir)
    deleted = []
    for steps, p in ckpts[:-num_ckpt_keep] if num_ckpt_keep > 0 else []:
        permanent = (permanent_ckpt_interval > 0 and steps >= permanent_ckpt_start
                     and steps % permanent_ckpt_interval == 0)
        if not permanent:
            p.unlink()
            deleted.append(p)
    return deleted


def load_checkpoint(path, *, category: Optional[str] = None, hp: Optional[dict] = None) -> dict:
    """A checkpoint's dict, its category checked against ``category``. A
    ``.dsckpt`` comes as the port's layout (``state_dict``, ``category``,
    ``global_step``, ``epoch``, no optimizer state); it needs ``hp``."""
    path = pathlib.Path(path)
    if path.suffix == ".dsckpt":
        blob = read_dsckpt(path, hp, category)
    else:
        blob = torch.load(path, map_location="cpu", weights_only=False)
    found = blob.get("category")
    if category is not None and found is not None and found != category:
        raise RuntimeError(
            f"Category mismatches: checkpoint is '{found}' but a "
            f"'{category}' checkpoint is required.")
    return blob


def read_dsckpt(path, hp: Optional[dict], category: Optional[str] = None) -> dict:
    """The JAX trainer's checkpoint in the port's layout, its parameters
    mapped through ``utils/convert.py`` (which needs the config ``hp``)."""
    from diffsinger_tpu_torch.utils import convert

    record = msgpack_restore(pathlib.Path(path).read_bytes())
    meta = record.get("meta", {})
    found = meta.get("category", category)
    if category is not None and found is not None and found != category:
        raise RuntimeError(
            f"Category mismatches: checkpoint is '{found}' but a "
            f"'{category}' checkpoint is required.")
    if hp is None:
        raise ValueError(f"{path} is the JAX trainer's checkpoint: mapping its parameters "
                         "needs the experiment's config")
    to_state_dict = {"acoustic": convert.acoustic_state_dict_from_flax,
                     "variance": convert.variance_state_dict_from_flax}.get(found)
    if to_state_dict is None:
        raise RuntimeError(f"{path}: unknown category {found!r}")
    return {"state_dict": to_state_dict(record["params"], hp), "category": found,
            "global_step": int(meta.get("global_step", 0)), "epoch": int(meta.get("epoch", 0))}


def msgpack_restore(data: bytes):
    """Decode ``flax.serialization.msgpack_serialize``'s bytes: msgpack whose
    numpy arrays are extension type 1 (a packed (shape, dtype name, bytes))
    and numpy scalars type 3. Flax cuts only arrays of over 1 GiB into
    chunks, which no DiffSinger parameter reaches: not read."""
    import msgpack

    return msgpack.unpackb(data, ext_hook=_ext, raw=False, strict_map_key=False)


def _ext(code: int, data: bytes):
    import msgpack

    if code not in (1, 3):
        raise ValueError(f"msgpack: unknown extension type {code}")
    shape, dtype, raw = msgpack.unpackb(data, raw=True)
    dtype = dtype.decode()
    if dtype == "bfloat16":  # the high half of a float32
        bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(raw, dtype=np.dtype(dtype))
    arr = arr.reshape(shape)
    return arr[()] if code == 3 else arr

"""pc-ddsp bundles -> the port's CombSub parameters (counterpart of
diffsinger_tpu/vocoders/ddsp_convert.py, the port's own copy).

The reference ships DDSP vocoders as TorchScript ``.jit`` bundles with a
``config.yaml`` beside them. The port runs them as its native
:class:`~diffsinger_tpu_torch.vocoders.ddsp_combsub.CombSub`, so that it
computes what the JAX package computes: the bundle's weights are read once
(``torch.jit.load`` on the host), their weight norm folded, their names
checked, and they load into the module. The JAX package's converted
``<bundle>.jit.dsckpt`` (flax names, msgpack) reads through
:func:`combsub_state_from_flax`.

The converter is strict: it maps pc-ddsp's parameter names and raises with
the bundle's inventory when one is missing, rather than guess.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

# Mel2Control's parameters by their pc-ddsp names (the LSTM's are the
# ``decoder.*`` of ``nn.LSTM(bidirectional=True)``)
_PLAIN = ("stack.0.weight", "stack.0.bias", "stack.1.weight", "stack.1.bias",
          "stack.3.weight", "stack.3.bias", "norm.weight", "norm.bias", "dense_out.bias")
_LSTM = tuple(f"decoder.{k}_l0{d}" for d in ("", "_reverse")
              for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))


def fold_weight_norm(state: Dict[str, np.ndarray], base: str) -> np.ndarray:
    """The plain weight of ``base`` (e.g. 'mel2ctrl.dense_out') under weight
    norm in either style (``weight_g`` / ``weight_v`` hooks or
    ``parametrizations.weight.original0/1``), or its weight as it is."""
    if f"{base}.weight_g" in state:
        g, v = state[f"{base}.weight_g"], state[f"{base}.weight_v"]
    elif f"{base}.parametrizations.weight.original0" in state:
        g = state[f"{base}.parametrizations.weight.original0"]
        v = state[f"{base}.parametrizations.weight.original1"]
    elif f"{base}.weight" in state:
        return state[f"{base}.weight"]
    else:
        raise KeyError(f"no weight(-norm) params found for '{base}'")
    norm = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1).reshape((-1,) + (1,) * (v.ndim - 1))
    return g * v / np.maximum(norm, 1e-12)


def torchscript_state(jit_path) -> Tuple[Dict[str, np.ndarray], dict]:
    """A TorchScript bundle's state dict as numpy and its ``config.yaml``."""
    import yaml

    jit_path = pathlib.Path(jit_path)
    model = torch.jit.load(str(jit_path), map_location="cpu").eval()
    state = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    config_path = jit_path.with_name("config.yaml")
    args = {}
    if config_path.exists():
        with open(config_path) as f:
            args = yaml.safe_load(f) or {}
    return state, args


def convert_combsub_state(state: Dict[str, np.ndarray]) -> Tuple[StateDict, dict]:
    """A pc-ddsp CombSub state dict -> (the port's CombSub state dict, dims
    {n_mels, n_out}). Raises KeyError with the inventory when a parameter is
    missing."""
    try:
        sd = {f"mel2ctrl.{k}": state[f"mel2ctrl.{k}"] for k in _PLAIN + _LSTM}
        sd["mel2ctrl.dense_out.weight"] = fold_weight_norm(state, "mel2ctrl.dense_out")
    except KeyError as e:
        inventory = "\n".join(f"  {k}: {tuple(v.shape)}" for k, v in state.items())
        raise KeyError(
            f"Unrecognized DDSP bundle layout (missing {e}). Expected the pc-ddsp CombSub "
            f"Mel2Control parameter names. Bundle inventory:\n{inventory}") from e
    dims = {"n_mels": int(sd["mel2ctrl.stack.0.weight"].shape[1]),
            "n_out": int(sd["mel2ctrl.dense_out.weight"].shape[0])}
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}, dims


def convert_torchscript_ddsp(jit_path) -> Tuple[StateDict, dict]:
    """``<bundle>.jit`` (+ config.yaml) -> (CombSub state dict, meta: the
    synthesis dims, as the JAX converter writes them)."""
    state, args = torchscript_state(jit_path)
    model_type = (args.get("model") or {}).get("type")
    if model_type not in (None, "CombSub", "CombSubFast"):
        raise NotImplementedError(
            f"DDSP bundle model type '{model_type}' is not supported; only the "
            f"CombSub family converts natively.")
    sd, dims = convert_combsub_state(state)
    data = args.get("data") or {}
    model_args = args.get("model") or {}
    n_mag_noise = int(model_args.get("n_mag_noise", 0) or 0)
    n_mag_harmonic = int(model_args.get("n_mag_harmonic", 0) or 0)
    if not n_mag_harmonic:
        # n_out = 2 n_mag_harmonic + n_mag_noise, and stock configs give both
        # filter banks the window's bin count
        win = int(data.get("win_length", 0) or 0)
        bins = win // 2 + 1 if win else dims["n_out"] // 3
        n_mag_harmonic = bins
        n_mag_noise = dims["n_out"] - 2 * bins
    meta = {"sampling_rate": int(data.get("sampling_rate", 44100)),
            "block_size": int(data.get("block_size", 512)),
            "win_length": int(data.get("win_length", 2048)),
            "n_mag_harmonic": n_mag_harmonic, "n_mag_noise": n_mag_noise,
            "n_mels": dims["n_mels"]}
    return sd, meta


def combsub_state_from_flax(params: dict) -> StateDict:
    """The JAX package's CombSub parameters (``blob['params']`` of its
    ``.dsckpt``) -> the port's state dict."""
    p = params["mel2ctrl"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    sd = {
        # flax Conv kernel [k, in, out] -> torch Conv1d [out, in, k]
        "mel2ctrl.stack.0.weight": t(np.transpose(p["stack_conv0"]["kernel"], (2, 1, 0))),
        "mel2ctrl.stack.0.bias": t(p["stack_conv0"]["bias"]),
        "mel2ctrl.stack.1.weight": t(p["stack_gn"]["scale"]),
        "mel2ctrl.stack.1.bias": t(p["stack_gn"]["bias"]),
        "mel2ctrl.stack.3.weight": t(np.transpose(p["stack_conv1"]["kernel"], (2, 1, 0))),
        "mel2ctrl.stack.3.bias": t(p["stack_conv1"]["bias"]),
        "mel2ctrl.norm.weight": t(p["norm"]["scale"]),
        "mel2ctrl.norm.bias": t(p["norm"]["bias"]),
        # flax Dense kernel [in, out] -> torch Linear [out, in]
        "mel2ctrl.dense_out.weight": t(np.transpose(p["dense_out"]["kernel"])),
        "mel2ctrl.dense_out.bias": t(p["dense_out"]["bias"]),
    }
    dec = p["decoder"]
    for d, side in (("", "fw"), ("_reverse", "bw")):
        for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
            name = {"w": "weight", "b": "bias"}[k[0]] + "_" + k[2:]
            sd[f"mel2ctrl.decoder.{name}_l0{d}"] = t(dec[f"{side}_{k}"])
    return sd

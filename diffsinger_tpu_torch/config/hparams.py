"""Cascading YAML configuration (counterpart of diffsinger_tpu/config/hparams.py).

Each YAML may declare ``base_config`` (a path or a list of paths); the bases
load depth-first and the child overrides them with a recursive dict-merge.
``hparams_str`` (``"k=v,k2=v2"``) applies typed overrides on top. With
``exp_name`` the saved ``<ckpt_root>/<exp_name>/config.yaml`` of an experiment
folder takes precedence over the chain (unless ``reset``), as in the JAX
package; a training run (``exp_name`` without ``infer``) writes that snapshot
when the folder has none, or anew with ``reset``.
"""

from __future__ import annotations

import os
from pathlib import Path

import yaml

# the repository root, where the shipped configs address their bases from
_REPO_ROOT = Path(__file__).resolve().parents[2]


def override_config(old_config: dict, new_config: dict) -> None:
    """Recursive dict-merge: nested dicts merge, everything else replaces."""
    for k, v in new_config.items():
        if isinstance(v, dict) and k in old_config and isinstance(old_config[k], dict):
            override_config(old_config[k], v)
        else:
            old_config[k] = v


def _load_chain(config_fn: str | Path, loaded: set) -> dict:
    config_fn = str(config_fn)
    with open(config_fn, encoding="utf-8") as f:
        cfg = yaml.safe_load(f) or {}
    loaded.add(config_fn)
    if "base_config" not in cfg:
        return cfg
    bases = cfg["base_config"]
    if not isinstance(bases, list):
        bases = [bases]
    merged: dict = {}
    here = os.path.dirname(os.path.abspath(config_fn))
    for base in bases:
        if base.startswith("."):
            base = os.path.normpath(os.path.join(here, base))
        elif not os.path.exists(base):
            # configs address their bases relative to the repository root;
            # also search beside the including file
            for root in (here, os.path.dirname(here), str(_REPO_ROOT)):
                candidate = os.path.join(root, base)
                if os.path.exists(candidate):
                    base = candidate
                    break
        if base not in loaded:
            override_config(merged, _load_chain(base, loaded))
    override_config(merged, cfg)
    return merged


def _apply_hparams_str(cfg: dict, hparams_str: str) -> None:
    for item in hparams_str.split(","):
        item = item.strip()
        if not item:
            continue
        k, v = item.split("=", 1)
        if k not in cfg or cfg[k] is None or isinstance(cfg[k], bool):
            cfg[k] = yaml.safe_load(v)
        elif v in ("True", "False"):
            cfg[k] = v == "True"
        else:
            cfg[k] = type(cfg[k])(v)


def load_config(config: str | Path = "", hparams_str: str = "", *, exp_name: str = "",
                infer: bool = False, reset: bool = False,
                ckpt_root: str | Path = "checkpoints", write_snapshot: bool = True) -> dict:
    """Resolve a config file and its ``base_config`` chain into one dict.

    With ``exp_name`` the experiment folder's ``config.yaml`` is read on top
    (unless ``reset``), a training run writes it (unless ``write_snapshot`` is
    false: the ranks of a run other than 0), and the result carries the
    bookkeeping keys ``work_dir``, ``exp_name`` and ``infer``.
    """
    if not (config or exp_name):
        raise ValueError("either config or exp_name must be given")
    cfg: dict = _load_chain(config, set()) if config else {}
    if exp_name:
        work_dir = os.path.join(str(ckpt_root), exp_name)
        snapshot = os.path.join(work_dir, "config.yaml")
        if os.path.exists(snapshot) and not reset:
            with open(snapshot, encoding="utf-8") as f:
                cfg.update(yaml.safe_load(f) or {})
        cfg["work_dir"] = work_dir
    if hparams_str:
        _apply_hparams_str(cfg, hparams_str)
    if exp_name and not infer and write_snapshot and (reset or not os.path.exists(snapshot)):
        os.makedirs(work_dir, exist_ok=True)
        with open(snapshot, "w", encoding="utf-8") as f:
            yaml.safe_dump(dict(cfg, base_config=[]), f, allow_unicode=True)
    if exp_name:
        cfg["infer"] = infer
        if not cfg.get("exp_name"):
            cfg["exp_name"] = exp_name
    return cfg

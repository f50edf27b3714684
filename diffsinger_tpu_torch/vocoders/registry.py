"""Vocoder registry (counterpart of diffsinger_tpu/vocoders/registry.py)."""

from __future__ import annotations

VOCODERS = {}


def register_vocoder(cls):
    VOCODERS[cls.__name__.lower()] = cls
    VOCODERS[cls.__name__] = cls
    return cls


def get_vocoder_cls(hparams: dict):
    # imported here so that registration happens on demand
    from diffsinger_tpu_torch.vocoders import ddsp, ddsp_native, nsf_hifigan  # noqa: F401

    return VOCODERS[hparams["vocoder"]]

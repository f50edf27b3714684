"""Vocoder registry (counterpart of diffsinger_tpu/vocoders/registry.py)."""

from __future__ import annotations

VOCODERS = {}

# vocoders of the JAX package that the port does not have yet
_NOT_PORTED = ("DDSP", "DDSPNative")


def register_vocoder(cls):
    VOCODERS[cls.__name__.lower()] = cls
    VOCODERS[cls.__name__] = cls
    return cls


def get_vocoder_cls(hparams: dict):
    # imported here so that registration happens on demand
    from diffsinger_tpu_torch.vocoders import nsf_hifigan  # noqa: F401

    name = hparams["vocoder"]
    if name not in VOCODERS and name.lower() in {n.lower() for n in _NOT_PORTED}:
        raise NotImplementedError(
            f"vocoder {name!r} is not ported yet; only NsfHifiGAN is available")
    return VOCODERS[name]

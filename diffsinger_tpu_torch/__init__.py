"""DiffSinger on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``diffsinger_tpu`` that mirrors its module tree and
names. Activations keep the JAX package's channel-last ``[B, T, C]`` layout at
every public function; module attributes follow the reference torch
``state_dict`` names, so weights move between the two packages through
``utils.convert`` and the JAX package's own converters.

Entry points (``models.toplevel.DiffSingerAcoustic`` and
``DiffSingerVariance``, ``vocoders.nsf_hifigan_model.Generator``, the runtimes
and servers of ``inference/`` and ``cli.infer``) run on the card unless the
caller passes ``device="cpu"``. The hand-written kernels live in ``ops/`` with their
CUDA sources in ``ops/csrc/``.
"""

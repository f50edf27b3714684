"""The encoders without RoPE (``use_rope: false``) against the JAX package's,
on the CPU in float32: the acoustic encoder, the variance encoder and the
melody encoder, with the relative-position scale (``rel_pos: true``), the
absolute sinusoidal table (``rel_pos: false``) and no position at all.

Seeded port weights reach the JAX modules through the JAX package's own
converters, which read the reference's ``nn.MultiheadAttention`` name
``in_proj_weight``; every row has padding, so the JAX attention's padded rows
(which see the valid keys) and K3's plain version's (which see the pad keys)
differ before the encoder zeroes them. Tolerance: max |diff| <= 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu_torch.models import commons
from tests.torch_parity import HP, MELS, VAR_HP, VOCAB, acoustic_inputs, jax_kwargs, port_kwargs

TOL = 1e-4
POSITIONS = {"rel_pos": dict(use_pos_embed=True, rel_pos=True),
             "table": dict(use_pos_embed=True, rel_pos=False),
             "none": dict(use_pos_embed=False, rel_pos=False)}
CASES = [(family, pos) for family in ("acoustic", "variance", "melody")
         for pos in ("rel_pos", "table")] + [("acoustic", "none")]


def seeded(port_module, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    state = {k: v + (0.3 if v.ndim == 1 else 0.02 + 0.5 * float(v.std()))
             * torch.randn(v.shape, generator=g) for k, v in port_module.state_dict().items()}
    port_module.load_state_dict(state)
    return state


def acoustic_case(hp):
    from diffsinger_tpu.models.toplevel import DiffSingerAcoustic as JaxAcoustic
    from diffsinger_tpu.utils.torch_model_convert import convert_acoustic
    from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic

    torch.manual_seed(0)
    port = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=MELS, device="cpu")
    params = convert_acoustic(seeded(port.module, 1), hp)
    inp = acoustic_inputs(seed=2)
    want = JaxAcoustic(hp, vocab_size=VOCAB, out_dims=MELS).module.apply(
        params, *(jnp.asarray(inp[k]) for k in ("tokens", "mel2ph", "f0")), method="encode",
        **jax_kwargs(inp))
    with torch.no_grad():
        got = port.module.encode(*(torch.from_numpy(inp[k]) for k in ("tokens", "mel2ph", "f0")),
                                 **port_kwargs(inp))
    return [got], [want], port


def variance_case(hp, melody: bool):
    from diffsinger_tpu.models.toplevel import DiffSingerVariance as JaxVariance
    from diffsinger_tpu.utils.torch_model_convert import convert_variance
    from diffsinger_tpu_torch.models.toplevel import DiffSingerVariance

    torch.manual_seed(0)
    port = DiffSingerVariance(hp, vocab_size=VOCAB, device="cpu")
    params = convert_variance(seeded(port.module, 1), hp)
    jmodule = JaxVariance(hp, vocab_size=VOCAB).module
    rng = np.random.default_rng(3)
    if melody:  # notes padded as the melody encoder's mask marks them: midi < 0
        note_midi = rng.uniform(55, 70, (2, 9)).astype(np.float32)
        note_midi[0, 7:] = -1.0
        note_midi[1, 4:] = -1.0
        args = (note_midi, rng.random((2, 9)) < 0.2, rng.integers(1, 9, (2, 9)).astype(np.int32))
        kw = dict(note_glide=rng.integers(0, 3, (2, 9)).astype(np.int32))
        want = [jmodule.apply(params, *map(jnp.asarray, args), method="melody_encode",
                              **{k: jnp.asarray(v) for k, v in kw.items()})]
        with torch.no_grad():
            got = [port.module.melody_encode(*map(torch.from_numpy, args),
                                             **{k: torch.from_numpy(v) for k, v in kw.items()})]
        return got, want, port
    tokens = rng.integers(1, VOCAB, (2, 12)).astype(np.int32)
    tokens[0, 10:] = 0
    tokens[1, 6:] = 0
    ph2word = np.cumsum(rng.random((2, 12)) < 0.5, axis=1).astype(np.int32) * (tokens > 0)
    ph2word = np.maximum(ph2word, (tokens > 0).astype(np.int32))
    args = (tokens, rng.integers(40, 80, (2, 12)).astype(np.int32), ph2word)
    ph_dur = (rng.integers(1, 6, (2, 12)) * (tokens > 0)).astype(np.int32)
    want = jmodule.apply(params, *map(jnp.asarray, args), ph_dur=jnp.asarray(ph_dur),
                         infer=True, method="encode")
    with torch.no_grad():
        got = port.module.encode(*map(torch.from_numpy, args), ph_dur=torch.from_numpy(ph_dur))
    return list(got), list(want), port


@pytest.mark.parametrize("family,pos", CASES)
def test_encoders_without_rope_match_jax(family, pos):
    if family == "acoustic":
        got, want, port = acoustic_case(dict(HP, use_rope=False, **POSITIONS[pos]))
        attn = port.module.fs2.encoder.layers[0].op.self_attn
    else:
        melody_args = dict(hidden_size=16, enc_layers=2, use_rope=False, **POSITIONS[pos])
        hp = dict(VAR_HP, use_rope=False, **POSITIONS[pos], use_melody_encoder=True,
                  use_glide_embed=True, melody_encoder_args=melody_args)
        got, want, port = variance_case(hp, melody=family == "melody")
        enc = port.module.melody_encoder if family == "melody" else port.module.fs2
        attn = enc.encoder.layers[0].op.self_attn
    assert isinstance(attn, commons.SelfAttentionAbs)
    assert "in_proj_weight" in dict(attn.named_parameters())
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - np.asarray(w)).max() <= TOL


def test_positional_table_is_the_jax_packages():
    from diffsinger_tpu.models import commons as jcommons

    np.testing.assert_array_equal(commons.sinusoidal_positional_table(64, 10),
                                  jcommons.sinusoidal_positional_table(64, 10))
    assert commons.MAX_POSITIONS == jcommons.FastSpeech2Encoder.max_positions

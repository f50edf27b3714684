"""Encoder-side modules of the PyTorch port against the JAX package, on the CPU
in float32 with shared weights: rotary and step embeddings, the frame
helpers, RoPE self-attention, the FastSpeech2 encoder, the acoustic encoder
and the ConvNeXt aux decoder. Tolerance 1e-5: both sides run float32 and
differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models import commons as jcommons
from diffsinger_tpu.models.aux_decoder import ConvNeXtDecoder as JaxConvNeXtDecoder
from diffsinger_tpu.utils import seq as jseq
from diffsinger_tpu_torch.models import commons
from diffsinger_tpu_torch.utils import seq
from tests.torch_parity import (
    HP, acoustic_inputs, acoustic_pair, assert_close, jax_kwargs, port_kwargs,
)


@pytest.fixture(scope="module")
def pair():
    return acoustic_pair(seed=1)


@pytest.fixture(scope="module")
def inputs():
    return acoustic_inputs(seed=2)


@pytest.mark.parametrize("shape", [(2, 2, 40, 16), (1, 3, 96, 32)])
def test_apply_rope(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    assert_close(commons.apply_rope(torch.from_numpy(x)), jcommons.apply_rope(jnp.asarray(x)))


def test_sinusoidal_pos_emb():
    """Steps up to 999 make float32 arguments near 1000 rad, where one ulp is
    6e-5 and the two libraries' exp and sin land up to 1.5e-5 apart (each is
    within 1.6e-5 of a float64 evaluation): tolerance 3e-5 here."""
    t = np.array([0.0, 400.0, 712.5, 999.0], np.float32)
    assert_close(commons.sinusoidal_pos_emb(torch.from_numpy(t), 32),
                 jcommons.sinusoidal_pos_emb(jnp.asarray(t), 32), atol=3e-5)


def test_gather_frames_and_mel2ph_to_dur(inputs):
    mel2ph = inputs["mel2ph"]
    feats = np.random.default_rng(1).standard_normal((2, 12, 8)).astype(np.float32)
    got = seq.gather_frames(torch.from_numpy(feats), torch.from_numpy(mel2ph))
    assert_close(got, jseq.gather_frames(jnp.asarray(feats), jnp.asarray(mel2ph)), atol=0, rtol=0)
    assert (got.numpy()[mel2ph == 0] == 0).all()  # padded frames take the zero row
    dur = seq.mel2ph_to_dur(torch.from_numpy(mel2ph), 12)
    np.testing.assert_array_equal(dur.numpy(), np.asarray(jseq.mel2ph_to_dur(jnp.asarray(mel2ph), 12)))


def test_self_attention_rope_matches_einsum_path_on_valid_rows(pair):
    """The port's K3 follows segment semantics on padded query rows, the JAX
    einsum path does not: compare valid rows."""
    _, params, port = pair
    p = params["params"]["fs2"]["encoder"]["layers_0"]["self_attn"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, HP["hidden_size"])).astype(np.float32)
    pad = np.zeros((2, 12), bool)
    pad[1, 8:] = True
    jattn = jcommons.SelfAttentionRoPE(HP["hidden_size"], HP["num_heads"], use_flash=False)
    want = np.asarray(jattn.apply({"params": p}, jnp.asarray(x), jnp.asarray(pad)))
    got = port.module.fs2.encoder.layers[0].op.self_attn(
        torch.from_numpy(x), torch.from_numpy(pad)).detach().numpy()
    np.testing.assert_allclose(got[~pad], want[~pad], atol=1e-5, rtol=1e-5)


def test_fastspeech2_encoder_with_padded_tokens(pair):
    _, params, port = pair
    rng = np.random.default_rng(4)
    h = HP["hidden_size"]
    embed = rng.standard_normal((2, 12, h)).astype(np.float32)
    extra = rng.standard_normal((2, 12, h)).astype(np.float32)
    pad = np.zeros((2, 12), bool)
    pad[0, 10:] = True
    pad[1, 7:] = True
    jenc = jcommons.FastSpeech2Encoder(hidden_size=h, num_layers=HP["enc_layers"],
                                       ffn_kernel_size=HP["enc_ffn_kernel_size"],
                                       num_heads=HP["num_heads"], use_rope=True)
    want = jenc.apply({"params": params["params"]["fs2"]["encoder"]},
                      jnp.asarray(embed), jnp.asarray(extra), jnp.asarray(pad))
    with torch.no_grad():
        got = port.module.fs2.encoder(torch.from_numpy(embed), torch.from_numpy(extra),
                                      torch.from_numpy(pad))
    assert_close(got, want)


def test_fastspeech2_acoustic_encode(pair, inputs):
    """Pad tokens and mel2ph == 0 frames, with the energy and key-shift embeds."""
    jmodel, params, port = pair
    want = jmodel.module.apply(
        params, jnp.asarray(inputs["tokens"]), jnp.asarray(inputs["mel2ph"]),
        jnp.asarray(inputs["f0"]), method="encode", **jax_kwargs(inputs))
    with torch.no_grad():
        got = port.module.encode(torch.from_numpy(inputs["tokens"]),
                                 torch.from_numpy(inputs["mel2ph"]),
                                 torch.from_numpy(inputs["f0"]), **port_kwargs(inputs))
    assert_close(got, want)


def test_fastspeech2_acoustic_every_optional_embed():
    """Language, speaker, all four variance, key-shift and speed embeds: the
    converter's names and the additions, against the JAX encoder."""
    hp = dict(HP, use_lang_id=True, num_lang=3, use_spk_id=True, num_spk=4,
              use_breathiness_embed=True, use_voicing_embed=True, use_tension_embed=True,
              use_speed_embed=True)
    jmodel, params, port = acoustic_pair(hp, seed=9)
    inp = acoustic_inputs(seed=10)
    rng = np.random.default_rng(11)
    langs = np.where(inp["tokens"] > 0, rng.integers(1, 4, inp["tokens"].shape), 0).astype(np.int32)
    spk = np.array([1, 3], np.int32)
    speed = rng.uniform(0.8, 1.2, inp["f0"].shape).astype(np.float32)
    curves = {v: rng.uniform(-40, -5, inp["f0"].shape).astype(np.float32)
              for v in ("energy", "breathiness", "voicing", "tension")}
    want = jmodel.module.apply(
        params, jnp.asarray(inp["tokens"]), jnp.asarray(inp["mel2ph"]), jnp.asarray(inp["f0"]),
        key_shift=jnp.asarray(inp["key_shift"]), speed=jnp.asarray(speed),
        spk_embed_id=jnp.asarray(spk), languages=jnp.asarray(langs),
        variances={k: jnp.asarray(v) for k, v in curves.items()}, method="encode")
    with torch.no_grad():
        got = port.module.encode(
            torch.from_numpy(inp["tokens"]), torch.from_numpy(inp["mel2ph"]),
            torch.from_numpy(inp["f0"]), key_shift=torch.from_numpy(inp["key_shift"]),
            speed=torch.from_numpy(speed), spk_embed_id=torch.from_numpy(spk),
            languages=torch.from_numpy(langs),
            variances={k: torch.from_numpy(v) for k, v in curves.items()})
    assert_close(got, want)


def test_convnext_decoder_and_aux_adaptor(pair):
    _, params, port = pair
    rng = np.random.default_rng(5)
    cond = rng.standard_normal((2, 40, HP["hidden_size"])).astype(np.float32)
    aux_args = HP["shallow_diffusion_args"]["aux_decoder_args"]
    jdec = JaxConvNeXtDecoder(in_dims=HP["hidden_size"], out_dims=16,
                              num_channels=aux_args["num_channels"],
                              num_layers=aux_args["num_layers"], kernel_size=7)
    want_dec = jdec.apply({"params": params["params"]["aux_decoder"]["decoder"]},
                          jnp.asarray(cond))
    with torch.no_grad():
        assert_close(port.module.aux_decoder.decoder(torch.from_numpy(cond)), want_dec)
        got = port.module.aux(torch.from_numpy(cond), infer=True)
    jmodel = pair[0]
    want = jmodel.module.apply(params, jnp.asarray(cond), infer=True, method="aux")
    assert_close(got, want)

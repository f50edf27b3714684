"""The PyTorch port's NSF-HiFiGAN generator against the JAX generator, on the CPU
in float32 with shared weights (biases randomised), and the vocoder weight round
trip through the JAX package's own converter.

mini-NSF: against the canonical layout (``fold_lanes=0``), tolerance 1e-5 for the
sine source and the wav. Full NSF: against the canonical and the lane-folded
(``fold_lanes=128``) layouts, with the JAX generator's draws from ``PRNGKey(0)``
(initial phases, source noise, ``noise_sigma`` noise) injected into the port,
max |diff| <= 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.utils.torch_convert import convert_nsf_hifigan
from diffsinger_tpu.vocoders import nsf_hifigan_model as jvoc
from diffsinger_tpu_torch.utils.convert import nsf_hifigan_state_dict_from_flax
from diffsinger_tpu_torch.vocoders import nsf_hifigan_model as voc
from tests.torch_parity import assert_close, jax_vocoder_noise, randomize, to_numpy

CFG = dict(num_mels=16, sampling_rate=44100, upsample_initial_channel=64, mini_nsf=True)
# ResBlock2 variant: two dilated convs per block
CFG2 = dict(CFG, resblock="2", resblock_dilation_sizes=((1, 3), (1, 3), (1, 3)))


def _pair(cfg, seed, ups_gain=1.0):
    jgen = jvoc.Generator(jvoc.NsfHifiGanConfig(**cfg), fold_lanes=0)
    # jitted: run op by op, the initialisation takes half a minute on the CPU
    params = randomize(jax.jit(jgen.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 16)),
                                          jnp.zeros((1, 4))), seed + 7)
    if ups_gain != 1.0:  # the transposed convs start at std 0.01, which all but mutes the mel
        params = jax.tree_util.tree_map_with_path(
            lambda path, leaf: leaf * ups_gain
            if path[-2].key.startswith("ups_") and path[-1].key == "kernel" else leaf, params)
    port = voc.Generator(voc.NsfHifiGanConfig(**cfg), device="cpu")
    port.load_state_dict(nsf_hifigan_state_dict_from_flax(to_numpy(params), port.config))
    return jgen, params, port


@pytest.fixture(scope="module")
def pair():
    return _pair(CFG, 0)


def _inputs(seed, b=2, t=12):
    rng = np.random.default_rng(seed)
    mel = rng.uniform(-10.0, -1.0, (b, t, 16)).astype(np.float32)
    f0 = rng.uniform(100.0, 600.0, (b, t)).astype(np.float32)
    f0[0, 3:5] = 0.0  # unvoiced frames
    return mel, f0


def test_fast_sine_gen():
    f0 = _inputs(1, t=40)[1]
    want = jvoc.fast_sine_gen(jnp.asarray(f0), 64, 44100 / 8)[:, :, 0]
    assert_close(voc.fast_sine_gen(torch.from_numpy(f0), 64, 44100 / 8), want)


def test_generator_matches_canonical_jax_generator(pair):
    jgen, params, port = pair
    mel, f0 = _inputs(2)
    want = jgen.apply(params, jnp.asarray(mel), jnp.asarray(f0))
    with torch.no_grad():
        got = port(torch.from_numpy(mel), torch.from_numpy(f0))
    assert got.shape == (2, 12 * 512)
    assert_close(got, want)


def test_generator_resblock2():
    jgen, params, port = _pair(CFG2, 1)
    mel, f0 = _inputs(3, t=8)
    want = jgen.apply(params, jnp.asarray(mel), jnp.asarray(f0))
    with torch.no_grad():
        assert_close(port(torch.from_numpy(mel), torch.from_numpy(f0)), want)


def test_vocoder_weight_round_trip(pair):
    """flax -> port state_dict -> the JAX package's torch converter -> flax."""
    _, params, port = pair
    back = convert_nsf_hifigan(port.state_dict(), port.config)
    want = to_numpy(params)
    flat_back = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(back)}
    flat_want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(want)}
    assert flat_back.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_back[k], v, err_msg=k)


def test_generator_refuses_the_full_nsf_source():
    """... when it would have to draw and was given neither a generator nor the noise."""
    port = voc.Generator(voc.NsfHifiGanConfig(**FULL), device="cpu")
    mel, f0 = (torch.from_numpy(a) for a in _inputs(4, b=1, t=4))
    with pytest.raises(ValueError, match="torch.Generator"):
        port(mel, f0)
    with pytest.raises(ValueError, match="torch.Generator"):
        port(mel, f0, noise=voc.VocoderNoise(rand_ini=torch.zeros(1, 1, 9)))
    sigma = voc.Generator(voc.NsfHifiGanConfig(**dict(CFG, noise_sigma=0.1)), device="cpu")
    with pytest.raises(ValueError, match="noise_sigma"):
        sigma(mel, f0)


# ------------------------------------------------------------------ full NSF
FULL = dict(CFG, mini_nsf=False)


def test_sine_source_full_matches_with_injected_draws():
    f0 = _inputs(5, t=24)[1]
    noise = jax_vocoder_noise(2, 24)
    want = jvoc.sine_source_full(jnp.asarray(f0), 512, 44100, 8, jax.random.PRNGKey(0))
    got = voc.sine_source_full(torch.from_numpy(f0), 512, 44100, 8, rand_ini=noise.rand_ini,
                               noise=noise.source)
    assert got.shape == (2, 24 * 512, 9)
    assert float(noise.rand_ini[0, 0, 0]) != 0.0  # the source zeroes the fundamental's phase itself
    assert_close(got, want, atol=1e-5)
    unvoiced = got[0, 3 * 512:5 * 512]  # noise only, a third of the sine amplitude
    assert_close(unvoiced, 0.1 / 3 * noise.source[0, 3 * 512:5 * 512], atol=1e-7)


@pytest.fixture(scope="module")
def full_pair():
    return _pair(FULL, 2, ups_gain=20.0)


@pytest.mark.parametrize("fold_lanes", [0, 128])
@pytest.mark.parametrize("noise_sigma", [0.0, 0.3])
def test_full_nsf_generator_matches_jax_generator(full_pair, fold_lanes, noise_sigma):
    _, params, port = full_pair
    if noise_sigma:
        port = voc.Generator(voc.NsfHifiGanConfig(**dict(FULL, noise_sigma=noise_sigma)),
                             device="cpu")
        port.load_state_dict(full_pair[2].state_dict())
    jgen = jvoc.Generator(jvoc.NsfHifiGanConfig(**dict(FULL, noise_sigma=noise_sigma)),
                          fold_lanes=fold_lanes)
    mel, f0 = _inputs(6, t=10)
    want = jgen.apply(params, jnp.asarray(mel), jnp.asarray(f0), rng=jax.random.PRNGKey(0))
    noise = jax_vocoder_noise(2, 10, channels=64, sigma=bool(noise_sigma))
    with torch.no_grad():
        got = port(torch.from_numpy(mel), torch.from_numpy(f0), noise=noise)
        plain = full_pair[2](torch.from_numpy(mel), torch.from_numpy(f0), noise=noise)
    assert got.shape == (2, 10 * 512)
    assert_close(got, want, atol=1e-4)
    if noise_sigma:
        assert (got - plain).abs().max() > 1e-3  # the sigma noise reached the output


def test_full_nsf_weight_round_trip(full_pair):
    _, params, port = full_pair
    assert {"m_source.l_linear.weight", "noise_convs.0.weight", "noise_convs.4.bias"} <= set(
        port.state_dict())
    assert port.noise_convs[0].weight.shape == (32, 1, 128)  # kernel 2 * 64, stride 64
    assert port.noise_convs[4].weight.shape == (2, 1, 1)
    back = convert_nsf_hifigan(port.state_dict(), port.config)
    want = to_numpy(params)
    flat_back = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(back)}
    flat_want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(want)}
    assert flat_back.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_back[k], v, err_msg=k)


def test_full_nsf_generator_draws_from_its_generator(full_pair):
    port = full_pair[2]
    mel, f0 = (torch.from_numpy(a) for a in _inputs(7, b=1, t=6))
    with torch.no_grad():
        a = port(mel, f0, generator=torch.Generator().manual_seed(1))
        b = port(mel, f0, generator=torch.Generator().manual_seed(1))
        c = port(mel, f0, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


def test_config_from_json_matches():
    d = dict(num_mels=80, sampling_rate=32000, upsample_rates=[4, 4, 2], noise_sigma=0.2,
             upsample_kernel_sizes=[8, 8, 4], resblock_dilation_sizes=[[1, 2], [3, 4]],
             mini_nsf=True, discriminator_periods=[3, 5], unknown="x")
    got, want = voc.NsfHifiGanConfig.from_json(d), jvoc.NsfHifiGanConfig.from_json(d)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hop_size == want.hop_size == 32 and got.noise_sigma == 0.2
    assert got.resblock_dilation_sizes == ((1, 2), (3, 4))


def test_fuse_weight_norm_matches():
    from diffsinger_tpu.utils.torch_convert import fuse_weight_norm as jax_fuse
    from diffsinger_tpu_torch.vocoders.nsf_hifigan import fuse_weight_norm

    g = torch.Generator().manual_seed(0)
    state = {"ups.0.weight_v": torch.randn(6, 3, 4, generator=g),
             "ups.0.weight_g": torch.rand(6, 1, 1, generator=g) + 0.5,
             "ups.0.bias": torch.randn(3, generator=g),
             "m_source.l_linear.weight": torch.randn(1, 9, generator=g)}
    got, want = fuse_weight_norm(state), jax_fuse(state)
    assert set(got) == set(want) == {"ups.0.weight", "ups.0.bias", "m_source.l_linear.weight"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)

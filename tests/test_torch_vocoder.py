"""The PyTorch port's mini-NSF HiFiGAN generator against the JAX generator in its
canonical layout (``fold_lanes=0``), on the CPU in float32 with shared weights
(biases randomised), and the vocoder weight round trip through the JAX
package's own converter. Tolerance 1e-5 for the sine source and the wav.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.utils.torch_convert import convert_nsf_hifigan
from diffsinger_tpu.vocoders import nsf_hifigan_model as jvoc
from diffsinger_tpu_torch.utils.convert import nsf_hifigan_state_dict_from_flax
from diffsinger_tpu_torch.vocoders import nsf_hifigan_model as voc
from tests.torch_parity import assert_close, randomize, to_numpy

CFG = dict(num_mels=16, sampling_rate=44100, upsample_initial_channel=64, mini_nsf=True)
# ResBlock2 variant: two dilated convs per block
CFG2 = dict(CFG, resblock="2", resblock_dilation_sizes=((1, 3), (1, 3), (1, 3)))


def _pair(cfg, seed):
    jgen = jvoc.Generator(jvoc.NsfHifiGanConfig(**cfg), fold_lanes=0)
    params = randomize(jgen.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 16)),
                                 jnp.zeros((1, 4))), seed + 7)
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
    with pytest.raises(NotImplementedError):
        voc.Generator(voc.NsfHifiGanConfig(num_mels=16, mini_nsf=False), device="cpu")

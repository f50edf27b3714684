"""The PyTorch port's slice end to end against the JAX package, on the CPU in
float32: acoustic ``forward_infer`` (encoder -> aux draft -> shallow reflow
over LYNXNet, with injected noise) followed by the mini-NSF vocoder, held to
max |mel diff| and max |wav diff| <= 1e-4 (module-level 1e-5, accumulated over
the sampler's steps). Also: the acoustic weight round trip through the JAX
package's converter, the config loader, and the entry points' device default.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.utils.torch_model_convert import convert_acoustic
from diffsinger_tpu.vocoders import nsf_hifigan_model as jvoc
from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
from diffsinger_tpu_torch.utils.convert import nsf_hifigan_state_dict_from_flax
from diffsinger_tpu_torch.vocoders import nsf_hifigan_model as voc
from tests.torch_parity import (
    HP, MELS, acoustic_inputs, acoustic_pair, jax_kwargs, port_kwargs, randomize, to_numpy,
)

VOC_CFG = dict(num_mels=MELS, sampling_rate=44100, upsample_initial_channel=64, mini_nsf=True)


@pytest.fixture(scope="module")
def pair():
    return acoustic_pair(seed=5)


@pytest.fixture(scope="module")
def vocoders():
    jgen = jvoc.Generator(jvoc.NsfHifiGanConfig(**VOC_CFG), fold_lanes=0)
    vparams = randomize(jgen.init(jax.random.PRNGKey(1), jnp.zeros((1, 4, MELS)), jnp.zeros((1, 4))), 9)
    port = voc.Generator(voc.NsfHifiGanConfig(**VOC_CFG), device="cpu")
    port.load_state_dict(nsf_hifigan_state_dict_from_flax(to_numpy(vparams), port.config))
    return jgen, vparams, port


@pytest.mark.parametrize("algorithm,steps", [("euler", 4), ("rk4", 2)])
def test_slice_forward_infer_then_vocoder(pair, vocoders, algorithm, steps):
    jmodel, params, port = pair
    jgen, vparams, pgen = vocoders
    inp = acoustic_inputs(seed=6, t_mel=40)
    noise = np.random.default_rng(7).standard_normal((2, 40, MELS)).astype(np.float32)
    jmodel.hp["sampling_algorithm"] = port.hp["sampling_algorithm"] = algorithm

    jout = jmodel.forward_infer(
        params, jax.random.PRNGKey(0), jnp.asarray(inp["tokens"]), jnp.asarray(inp["mel2ph"]),
        jnp.asarray(inp["f0"]), steps=steps, noise=jnp.asarray(noise), **jax_kwargs(inp))
    jwav = np.asarray(jgen.apply(vparams, jout.diff_out, jnp.asarray(inp["f0"])))

    pout = port.forward_infer(
        torch.from_numpy(inp["tokens"]), torch.from_numpy(inp["mel2ph"]),
        torch.from_numpy(inp["f0"]), steps=steps, noise=torch.from_numpy(noise),
        **port_kwargs(inp))
    with torch.no_grad():
        pwav = pgen(pout.diff_out, torch.from_numpy(inp["f0"])).numpy()

    jmel = np.asarray(jout.diff_out)
    assert np.abs(jmel - np.asarray(jout.aux_out)).mean() > 1e-2  # the sampler moved the draft
    assert np.abs(pout.aux_out.numpy() - np.asarray(jout.aux_out)).max() <= 1e-4
    assert np.abs(pout.diff_out.numpy() - jmel).max() <= 1e-4
    assert (pout.diff_out.numpy()[inp["mel2ph"] == 0] == 0).all()
    assert pwav.shape == (2, 40 * 512) and np.isfinite(pwav).all()
    assert np.abs(pwav - jwav).max() <= 1e-4


def test_forward_infer_draws_noise_from_the_generator(pair):
    _, _, port = pair
    inp = acoustic_inputs(seed=8, t_mel=24)
    args = [torch.from_numpy(inp[k]) for k in ("tokens", "mel2ph", "f0")]
    outs = [port.forward_infer(*args, steps=2, generator=torch.Generator().manual_seed(s),
                               **port_kwargs(inp)).diff_out for s in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


def test_acoustic_weight_round_trip(pair):
    """flax -> port state_dict (loaded strictly) -> the JAX package's
    convert_acoustic -> the same flax tree, leaf for leaf."""
    _, params, port = pair
    back = convert_acoustic(port.module.state_dict(), HP)
    flat = lambda tree: {jax.tree_util.keystr(k): v
                         for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = flat(to_numpy(params)), flat(back)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_load_config_resolves_the_shipped_chain():
    from diffsinger_tpu.config import load_config as jax_load_config
    from diffsinger_tpu_torch.config import load_config

    config = Path(__file__).resolve().parents[1] / "configs" / "acoustic.yaml"
    hp = load_config(config, "sampling_steps=50")
    want = jax_load_config(config, hparams_str="sampling_steps=50", save_snapshot=False)
    assert hp["sampling_steps"] == 50 and hp["backbone_args"]["num_channels"] == 1024
    # the JAX loader adds its experiment bookkeeping keys
    assert hp == {k: v for k, v in want.items() if k not in ("work_dir", "exp_name", "infer")}


def test_entry_points_default_to_cuda():
    """Without device=, an entry point runs on the card, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        DiffSingerAcoustic(HP, vocab_size=30, out_dims=MELS)
    with pytest.raises(RuntimeError, match="CUDA"):
        voc.Generator(voc.NsfHifiGanConfig(**VOC_CFG))

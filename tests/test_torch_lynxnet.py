"""The LYNXNet denoiser and the rectified-flow samplers of the PyTorch port
against the JAX package, on the CPU in float32 with shared weights (the
output projection, biases and PReLU slopes randomised so the velocity is not
zero). Module tolerance 1e-5; the samplers integrate several steps and are
held to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.core import reflow as jreflow
from diffsinger_tpu.models.backbones import precompute_cond_projections as jax_precompute
from diffsinger_tpu.models.backbones.lynxnet import LYNXConvModule as JaxConvModule
from diffsinger_tpu_torch.core import reflow
from diffsinger_tpu_torch.models.backbones import precompute_cond_projections
from tests.torch_parity import HP, MELS, acoustic_pair, assert_close


@pytest.fixture(scope="module")
def pair():
    return acoustic_pair(seed=3)


def _denoiser_inputs(seed, b=2, t=40):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, MELS)).astype(np.float32)
    cond = rng.standard_normal((b, t, HP["hidden_size"])).astype(np.float32)
    steps = np.array([400.0, 871.25], np.float32)[:b]
    return x, steps, cond


def test_lynx_conv_module(pair):
    _, params, port = pair
    p = params["params"]["denoiser"]["residual_layers_1"]["convmodule"]
    c = HP["backbone_args"]["num_channels"]
    x = np.random.default_rng(0).standard_normal((2, 37, c)).astype(np.float32)
    want = JaxConvModule(dim=c, expansion_factor=2, kernel_size=31).apply(
        {"params": p}, jnp.asarray(x))
    with torch.no_grad():
        got = port.module.denoiser.residual_layers[1].convmodule(torch.from_numpy(x))
    assert_close(got, want)


@pytest.mark.parametrize("hoisted", [False, True])
def test_lynxnet_with_and_without_cond_proj(pair, hoisted):
    jmodel, params, port = pair
    x, steps, cond = _denoiser_inputs(seed=1)
    jproj = jax_precompute(params["params"]["denoiser"], jnp.asarray(cond)) if hoisted else None
    want = jmodel.module.apply(params, jnp.asarray(x), jnp.asarray(steps), jnp.asarray(cond),
                               cond_proj=jproj, method="denoise")
    assert np.abs(np.asarray(want)).mean() > 1e-2  # the velocity is not trivially zero
    with torch.no_grad():
        cond_t = torch.from_numpy(cond)
        proj = precompute_cond_projections(port.module.denoiser, cond_t) if hoisted else None
        if hoisted:
            assert_close(proj, jproj)
        got = port.module.denoise(torch.from_numpy(x), torch.from_numpy(steps), cond_t,
                                  cond_proj=proj)
    assert_close(got, want)


def test_lynxnet_without_strong_cond():
    """strong_cond=False: GELU after the input projection, and the condition
    injected after the residual branch is taken."""
    hp = dict(HP, backbone_args=dict(HP["backbone_args"], strong_cond=False, kernel_size=7))
    jmodel, params, port = acoustic_pair(hp, seed=4)
    x, steps, cond = _denoiser_inputs(seed=5)
    want = jmodel.module.apply(params, jnp.asarray(x), jnp.asarray(steps), jnp.asarray(cond),
                               method="denoise")
    with torch.no_grad():
        got = port.module.denoise(torch.from_numpy(x), torch.from_numpy(steps),
                                  torch.from_numpy(cond))
    assert_close(got, want)


@pytest.mark.parametrize("algorithm,steps", [("euler", 3), ("rk2", 2), ("rk4", 2), ("rk5", 1)])
def test_sample_ode(pair, algorithm, steps):
    jmodel, params, port = pair
    x, _, cond = _denoiser_inputs(seed=2)

    def jvel(xx, t):
        return jmodel.module.apply(params, xx, t, jnp.asarray(cond), method="denoise")

    want = jreflow.sample_ode(jvel, jnp.asarray(x), t_start=0.4, steps=steps,
                              algorithm=algorithm, time_scale_factor=1000)
    cond_t = torch.from_numpy(cond)
    with torch.no_grad():
        got = reflow.sample_ode(lambda xx, t: port.module.denoise(xx, t, cond_t),
                                torch.from_numpy(x), t_start=0.4, steps=steps,
                                algorithm=algorithm, time_scale_factor=1000)
    assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_sample_ode_step_times_match_the_scan():
    """The denoiser sees the float32 times of the JAX scan's arithmetic:
    1000 * (t_start + i * dt), each operation rounded to float32."""
    seen = []
    reflow.sample_ode(lambda x, t: (seen.append(t.numpy()), x * 0)[1],
                      torch.zeros(1, 2, 2), t_start=0.4, steps=50, algorithm="euler",
                      time_scale_factor=1000)
    i = np.arange(50, dtype=np.float32)
    want = (np.float32(0.4) + i * np.float32((1.0 - 0.4) / 50)) * np.float32(1000)
    np.testing.assert_array_equal(np.concatenate(seen), want)


def test_inference_shallow_start_uses_injected_noise():
    x_end = torch.full((1, 4, 2), 2.0)
    noise = torch.full((1, 4, 2), -1.0)
    out = reflow.inference(lambda x, t: torch.zeros_like(x), (1, 4, 2), t_start=0.4, steps=3,
                           algorithm="euler", time_scale_factor=1000, device="cpu",
                           x_end=x_end, use_shallow_diffusion=True, noise=noise)
    assert_close(out, np.full((1, 4, 2), 0.4 * 2.0 - 0.6, np.float32))

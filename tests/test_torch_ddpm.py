"""The port's DDPM family against the JAX package's, on the CPU in float32:
the schedule tables, the samplers (ancestral with the JAX draws injected
step by step, DDIM, PLMS, DPM-Solver++ 2M, UniPC bh2) over a WaveNet
denoiser, WaveNet itself with and without the hoisted condition projections,
and the acoustic model's ``forward_infer`` with ``diffusion_type: ddpm`` under
every accelerator. The JAX package's own solver tests compare with a reference
checkout; these compare with the JAX functions.

Tolerances: tables equal to the last bit; a WaveNet call 1e-5; samplers and
the acoustic slice max |diff| <= 1e-4 (float32, sums in another order,
accumulated over the steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.core import ddpm as jddpm
from diffsinger_tpu.core import fast_solvers as jfast
from diffsinger_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from diffsinger_tpu.models.backbones import precompute_cond_projections as jax_cond_projs
from diffsinger_tpu.models.backbones.wavenet import WaveNet as JaxWaveNet
from diffsinger_tpu_torch.core import ddpm, fast_solvers
from diffsinger_tpu_torch.core.schedule import DiffusionSchedule
from diffsinger_tpu_torch.models.backbones import WaveNet, precompute_cond_projections
from diffsinger_tpu_torch.utils.convert import _wavenet
from tests.torch_parity import (HP, acoustic_inputs, acoustic_pair, assert_close,
                                jax_ddpm_step_noises, jax_kwargs, port_kwargs, randomize,
                                to_numpy)

TOL = 1e-4
B, T, D, H = 2, 24, 8, 12
WN = dict(num_layers=4, num_channels=16, dilation_cycle_length=3)


@pytest.mark.parametrize("schedule_type,timesteps", [
    ("linear", 1000), ("linear", 100), ("cosine", 1000), ("cosine", 50),
])
def test_schedule_tables_equal(schedule_type, timesteps):
    want = JaxSchedule.create(schedule_type, timesteps)
    got = DiffusionSchedule.create(schedule_type, timesteps)
    assert got.timesteps == want.timesteps == timesteps
    for field in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                  "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                  "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                  "posterior_log_variance_clipped", "posterior_mean_coef1",
                  "posterior_mean_coef2"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == np.float32 and np.array_equal(a, b), field


def test_q_sample_and_predict_start_from_noise():
    sched = DiffusionSchedule.create("linear", 100)
    jsched = JaxSchedule.create("linear", 100)
    rng = np.random.default_rng(0)
    x, noise = (rng.standard_normal((3, T, D)).astype(np.float32) for _ in range(2))
    t = np.array([0, 57, 99], np.int32)
    assert_close(ddpm.q_sample(sched, torch.from_numpy(x), torch.from_numpy(t),
                               torch.from_numpy(noise)),
                 jddpm.q_sample(jsched, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise)),
                 atol=1e-6)
    assert_close(ddpm.predict_start_from_noise(sched, torch.from_numpy(x), torch.from_numpy(t),
                                               torch.from_numpy(noise)),
                 jddpm.predict_start_from_noise(jsched, jnp.asarray(x), jnp.asarray(t),
                                                jnp.asarray(noise)), atol=1e-5)


@pytest.fixture(scope="module")
def wavenet():
    """A JAX WaveNet with randomised parameters, the port's with the same
    weights, and a condition."""
    jnet = JaxWaveNet(in_dims=D, n_feats=1, cond_dims=H, **WN)
    rng = np.random.default_rng(3)
    cond = rng.standard_normal((B, T, H)).astype(np.float32)
    params = randomize(jnet.init(jax.random.PRNGKey(2), jnp.zeros((B, T, D)),
                                 jnp.zeros((B,)), jnp.asarray(cond)), 4)
    net = WaveNet(in_dims=D, n_feats=1, cond_dims=H, **WN)
    sd = {}
    _wavenet(sd, "net", to_numpy(params)["params"], WN["num_layers"])
    net.load_state_dict({k[len("net."):]: v for k, v in sd.items()})
    return jnet, params, net.eval(), cond


@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("t_kind", ["int", "float"])
def test_wavenet_matches(wavenet, hoisted, t_kind):
    jnet, params, net, cond = wavenet
    x = np.random.default_rng(5).standard_normal((B, T, D)).astype(np.float32)
    t = np.array([7, 913], np.int32) if t_kind == "int" else np.array([3.5, 871.25], np.float32)
    jproj = jax_cond_projs(params["params"], jnp.asarray(cond)) if hoisted else None
    want = jnet.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), cond_proj=jproj)
    with torch.no_grad():
        proj = precompute_cond_projections(net, torch.from_numpy(cond)) if hoisted else None
        if hoisted:
            assert proj.shape == (WN["num_layers"], B, T, 2 * WN["num_channels"])
            assert_close(proj, jproj, atol=1e-5)
        got = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond), cond_proj=proj)
    assert_close(got, want, atol=1e-5)


SAMPLERS = [
    # (name, timesteps, t_max, interval or steps)
    ("ddpm", 12, 12, None),
    ("ddim", 100, 100, 10),
    ("ddim", 1000, 400, 10),
    ("plms", 100, 100, 10),
    ("plms", 1000, 400, 25),
    ("dpmpp_2m", 1000, 1000, 12),
    ("dpmpp_2m", 1000, 400, 6),
    ("dpmpp_2m", 100, 100, 1),
    ("unipc_2", 1000, 1000, 12),
    ("unipc_2", 1000, 400, 5),
    ("unipc_2", 100, 100, 1),
]


@pytest.mark.parametrize("name,timesteps,t_max,arg", SAMPLERS)
def test_sampler_matches_jax(wavenet, name, timesteps, t_max, arg):
    jnet, params, net, cond = wavenet
    sched = DiffusionSchedule.create("linear", timesteps)
    jsched = JaxSchedule.create("linear", timesteps)
    x0 = np.random.default_rng(6).standard_normal((B, T, D)).astype(np.float32)
    jcond, tcond = jnp.asarray(cond), torch.from_numpy(cond)
    calls = []

    def jfn(x, t):
        return jnet.apply(params, x, t, jcond)

    def pfn(x, t):
        calls.append(t.dtype)
        return net(x, t, tcond)

    key = jax.random.PRNGKey(9)
    x_j = jnp.asarray(x0)
    x_p = torch.from_numpy(x0)
    with torch.no_grad():
        if name == "ddpm":
            want = jddpm.sample_ddpm(jfn, jsched, x_j, t_max, key)
            draws = jax_ddpm_step_noises(key, t_max, x0.shape)
            got = ddpm.sample_ddpm(pfn, sched, x_p, t_max, noise_fn=lambda i: draws[i])
            n_calls, t_dtype = t_max, torch.int32
        elif name == "ddim":
            want = jddpm.sample_ddim(jfn, jsched, x_j, t_max, arg)
            got = ddpm.sample_ddim(pfn, sched, x_p, t_max, arg)
            n_calls, t_dtype = (t_max - 1) // arg + 1, torch.int32
        elif name == "plms":
            want = jddpm.sample_plms(jfn, jsched, x_j, t_max, arg)
            got = ddpm.sample_plms(pfn, sched, x_p, t_max, arg)
            n_calls, t_dtype = (t_max + arg - 1) // arg + 1, torch.int32
        else:
            jf = getattr(jfast, f"sample_{name}")
            want = jf(jfn, jsched, x_j, t_max, arg)
            got = getattr(fast_solvers, f"sample_{name}")(pfn, sched, x_p, t_max, arg)
            n_calls, t_dtype = arg, torch.float32
    assert len(calls) == n_calls and set(calls) == {t_dtype}
    assert_close(got, want, atol=TOL, rtol=0)


def test_discrete_grid_matches_jax():
    sched = JaxSchedule.create("linear", 1000)
    for t_max, steps in ((1000, 20), (400, 40), (50, 3)):
        want = jfast._discrete_grid(sched, t_max, steps)
        got = fast_solvers._discrete_grid(DiffusionSchedule.create("linear", 1000), t_max, steps)
        for field in ("t_input", "lam", "alpha", "sigma"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


# ---------------------------------------------------------------- acoustic, ddpm

DDPM_HP = dict(HP, diffusion_type="ddpm", timesteps=100, K_step=40, K_step_infer=40,
               diff_speedup=10, schedule_type="linear")


@pytest.fixture(scope="module")
def ddpm_pair():
    """The tiny acoustic model under DDPM, with the aux decoder's and the
    denoiser's last layers scaled down so that the draft and the noise
    prediction stay near the unit range a trained model gives (the seeded
    weights otherwise put mel values near 200, where float32's rounding alone
    is 1e-5)."""
    from diffsinger_tpu_torch.utils.convert import acoustic_state_dict_from_flax

    jmodel, params, port = acoustic_pair(DDPM_HP, seed=8)
    p = params["params"]
    for node in (p["aux_decoder"]["decoder"]["outconv"], p["denoiser"]["output_projection"]):
        node["kernel"] = node["kernel"] * 0.1
    port.module.load_state_dict(acoustic_state_dict_from_flax(to_numpy(params), DDPM_HP))
    return jmodel, params, port


@pytest.mark.parametrize("accelerator,depth,speedup", [
    ("ddim", None, 10), ("pndm", None, 10), ("dpm-solver", None, 10), ("unipc", None, 10),
    ("ddim", 20, 5), ("ddpm", 6, 1),
])
def test_acoustic_forward_infer_ddpm(ddpm_pair, accelerator, depth, speedup):
    jmodel, params, port = ddpm_pair
    assert "diffusion.denoise_fn.input_projection.weight" in port.module.state_dict()
    for m in (jmodel, port):
        m.hp["diff_accelerator"] = accelerator
        m.hp["diff_speedup"] = speedup
    inp = acoustic_inputs(seed=10, t_mel=40)
    noise = np.random.default_rng(11).standard_normal((2, 40, 16)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    jout = jmodel.forward_infer(
        params, key, jnp.asarray(inp["tokens"]), jnp.asarray(inp["mel2ph"]),
        jnp.asarray(inp["f0"]), depth=depth, noise=jnp.asarray(noise), **jax_kwargs(inp))
    draws = jax_ddpm_step_noises(key, 40, noise.shape)
    pout = port.forward_infer(
        torch.from_numpy(inp["tokens"]), torch.from_numpy(inp["mel2ph"]),
        torch.from_numpy(inp["f0"]), depth=depth, noise=torch.from_numpy(noise),
        noise_fn=lambda i: draws[i], **port_kwargs(inp))
    assert 1.0 < np.abs(np.asarray(jout.diff_out)).max() < 40.0
    assert_close(pout.aux_out, jout.aux_out, atol=TOL, rtol=0)
    assert_close(pout.diff_out, jout.diff_out, atol=TOL, rtol=0)


def test_acoustic_ddpm_depth_zero_returns_the_draft(ddpm_pair):
    """Depth 0 returns the aux draft itself; without a draft the shallow
    start is refused."""
    jmodel, params, port = ddpm_pair
    port.hp["diff_accelerator"] = "ddim"
    inp = acoustic_inputs(seed=13, t_mel=32)
    out = port.forward_infer(torch.from_numpy(inp["tokens"]), torch.from_numpy(inp["mel2ph"]),
                             torch.from_numpy(inp["f0"]), depth=0, **port_kwargs(inp))
    assert_close(out.diff_out, out.aux_out, atol=1e-6)
    with pytest.raises(ValueError, match="Missing shallow diffusion source"):
        ddpm.inference(lambda x, t: x, DiffusionSchedule.create("linear", 100), (1, 4, 2),
                       k_step=40, depth=None, speedup=10, algorithm="ddim", device="cpu")


def test_max_beta_is_not_forwarded(monkeypatch):
    """The reference never reads max_beta: the linear schedule ends at 0.01,
    with a warning once per process."""
    from diffsinger_tpu_torch.models import toplevel

    monkeypatch.setattr(toplevel, "_warned_max_beta", False)
    with pytest.warns(UserWarning, match="UNREAD"):
        sched = toplevel._schedule(dict(max_beta=0.02), "ddpm", 1000)
    assert sched.betas[-1] == np.float32(0.01)

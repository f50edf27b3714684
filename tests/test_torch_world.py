"""WORLD, D4C, Harvest and the signal bank in the port against the JAX package,
on the CPU.

Tolerances, each against the largest entry of the JAX output:

- the numpy copies (D4C, Harvest, WORLD's float64 synthesis and pulse
  extraction): 1e-12;
- CheapTrick and the twin's per-pulse responses (fed the JAX draws): 1e-4;
- the twin's D4C: 1e-4 on a breathy voice; on tones with the split's 1e-5
  dither, max |diff| 1e-2 and mean 1e-3 with the same voicing (both float32
  twins round the group delay of a clean harmonic spectrum differently; each
  stays within the JAX package's own bound to the float64 golden);
- the twin's whole split, fed the JAX draws: 5e-4 of each part's peak (the
  D4C rounding above, plus the JAX twin's int16 transport of its outputs,
  half a step of 1/32000 of the peak; the port carries float32, and the
  test gives both twins the samples that the JAX transport makes);
- the host split (float64 goldens, float32 CheapTrick): 1e-4;
- the spectral-floor aperiodicity and the overlap-add synthesis: as their
  tests state (float32 sums of ill-conditioned terms).
"""

import json
import multiprocessing
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.dsp import d4c as jd4c
from diffsinger_tpu.dsp import golden_signals as jgs
from diffsinger_tpu.dsp import harvest as jharvest
from diffsinger_tpu.dsp import world as jworld
from diffsinger_tpu.dsp import world_device as jwd
from diffsinger_tpu_torch.dsp import d4c, golden_signals, harvest, world, world_device

FS, HOP, FFT = 44100, 512, 2048
GOLDENS = pathlib.Path(__file__).parent / "goldens" / "bank_hashes.json"


def bank(name, seconds=0.5):
    wave, f0 = golden_signals.signal_bank()[name]
    return wave[: int(FS * seconds)], f0


def frame_f0(wave, f0_value, unvoiced_head=3):
    n = int(np.ceil((len(wave) + 1) / HOP))
    f0 = np.full(n, f0_value, np.float32)
    f0[:unvoiced_head] = 0.0
    return f0


def near(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err
    return err


def test_signal_bank_matches_the_committed_hashes():
    committed = json.loads(GOLDENS.read_text())
    assert committed["bank_version"] == golden_signals.BANK_VERSION
    assert golden_signals.bank_hashes() == committed["signals"] == jgs.bank_hashes()


@pytest.mark.parametrize("name", ["vowel_pulse", "breathy"])
def test_numpy_copies_equal_the_jax_packages(name):
    wave, f0_true = bank(name)
    f0 = frame_f0(wave, f0_true).astype(np.float64)
    pos = np.arange(len(f0)) * HOP / FS
    np.testing.assert_allclose(d4c.d4c(wave, f0, pos, FS, FFT), jd4c.d4c(wave, f0, pos, FS, FFT),
                               rtol=0, atol=1e-12)
    kw = dict(f0_floor=65.0, f0_ceil=1100.0, frame_period=1000 * HOP / FS)
    for got, want in zip(harvest.harvest(wave, FS, **kw), jharvest.harvest(wave, FS, **kw)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    env = np.tile(np.geomspace(1e-2, 1e-6, FFT // 2 + 1), (len(f0), 1))
    ap = np.tile(np.linspace(0.1, 0.9, FFT // 2 + 1), (len(f0), 1))
    np.testing.assert_allclose(world.synthesize_world(f0, env, ap, FS, HOP, seed=3),
                               jworld.synthesize_world(f0, env, ap, FS, HOP, seed=3),
                               rtol=0, atol=1e-12)
    for got, want in zip(world_device.extract_pulses(f0, FS, HOP), jwd.extract_pulses(f0, FS, HOP)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("start,width,pad_mode", [(-1024, 2048, "constant"), (-700, 1401, "edge"),
                                                  (-900, 1890, "edge")])
def test_frames_by_blocks_equals_the_jax_framing(start, width, pad_mode):
    x = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
    got = world.frames_by_blocks(torch.from_numpy(x), 9, 384, start, width, pad_mode)
    want = jworld.frames_by_blocks(jnp.asarray(x), 9, 384, start, width, pad_mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["vowel_pulse", "breathy", "noise"])
def test_cheaptrick(name):
    wave, f0_true = bank(name)
    x = wave.astype(np.float32)
    f0 = frame_f0(wave, f0_true if name != "noise" else 0.0)
    kw = dict(fs=FS, fft_size=FFT, hop=HOP)
    near(world.cheaptrick(torch.from_numpy(x), torch.from_numpy(f0), **kw),
         jworld.cheaptrick(jnp.asarray(x), jnp.asarray(f0), **kw))


@pytest.mark.parametrize("name", ["vowel_pulse", "breathy", "noise"])
def test_estimate_aperiodicity(name):
    """The spectral-floor aperiodicity; unvoiced frames are 1 on both sides.
    Its band means are differences of float32 cumulative sums: on a breathy
    voice both packages stay within 3.4e-4 of the float64 value (held to 1e-3
    of each other). On a clean pulse train the inter-harmonic floor drowns
    in the sums' rounding and both stray from float64 by 0.33 on average;
    there the port's error against float64 is held to 1.1x the JAX
    package's, and the two agree within 1e-3 on 90 % of the entries or more
    (measured 93.7 %)."""
    wave, f0_true = bank(name)
    x = wave.astype(np.float32)
    f0 = frame_f0(wave, f0_true if name != "noise" else 0.0)
    kw = dict(fs=FS, fft_size=FFT, hop=HOP)
    got = world.estimate_aperiodicity(torch.from_numpy(x), torch.from_numpy(f0), **kw).numpy()
    want = np.asarray(jworld.estimate_aperiodicity(jnp.asarray(x), jnp.asarray(f0), **kw))
    assert (got[f0 == 0] == 1).all() and (want[f0 == 0] == 1).all()
    if name != "vowel_pulse":
        near(got, want, tol=1e-3)
        return
    truth = world.estimate_aperiodicity(torch.from_numpy(wave).double(),
                                        torch.from_numpy(f0).double(), **kw).numpy()
    assert np.abs(got - truth).mean() <= 1.1 * np.abs(want - truth).mean()
    assert (np.abs(got - want) <= 1e-3).mean() >= 0.9


@pytest.mark.parametrize("name", ["vowel_pulse", "breathy"])
def test_overlap_add_synthesis_with_the_jax_noise(name):
    """``synthesize`` from the JAX package's own CheapTrick and aperiodicity
    of a phrase, with the JAX draw of its noise injected: within 1e-4 of the
    JAX waveform's peak. The port sums the pulse train's phase in float64, so
    its pulses fall on the samples of the exact phase, as the jitted JAX
    function's do on these phrases (a float32 sum in the port's order put 48
    of the breathy phrase's 95 pulses one sample off). A drawn noise is the
    same at every call."""
    wave, f0_true = bank(name)
    f0 = frame_f0(wave, f0_true)
    kw = dict(fs=FS, fft_size=FFT, hop=HOP)
    env = jworld.cheaptrick(jnp.asarray(wave, jnp.float32), jnp.asarray(f0), **kw)
    ap = jworld.estimate_aperiodicity(jnp.asarray(wave, jnp.float32), jnp.asarray(f0), **kw)
    rng = jax.random.PRNGKey(7)
    want = jworld.synthesize(jnp.asarray(f0), env, ap, rng=rng, **kw)
    noise = np.asarray(jax.random.normal(rng, (len(f0) * HOP,), jnp.float32))

    pulses = world.pulse_excitation(torch.from_numpy(f0), fs=FS, hop=HOP).numpy()
    f0_up = np.repeat(np.where(f0 > 0, f0, world.DEFAULT_F0).astype(np.float32), HOP)
    phase64 = np.cumsum(f0_up.astype(np.float64) / FS)
    exact = np.diff(np.floor(np.concatenate([[0.0], phase64]))) > 0
    np.testing.assert_array_equal(np.flatnonzero(pulses), np.flatnonzero(exact & np.repeat(f0 > 0, HOP)))
    args = [torch.from_numpy(a) for a in (f0, np.asarray(env), np.asarray(ap))]
    got = world.synthesize(*args, noise=torch.from_numpy(noise), **kw)
    assert got.shape == (len(f0) * HOP,)
    near(got, want)
    drawn = [world.synthesize(*args, generator=torch.Generator().manual_seed(1), **kw)
             for _ in range(2)]
    assert torch.equal(*drawn)


@pytest.mark.parametrize("name", ["breathy", "vowel_pulse", "steady_mid"])
def test_d4c_twin(name):
    wave, f0_true = bank(name)
    if name != "breathy":  # the split's dither
        wave = wave + 1e-5 * np.random.default_rng(0).standard_normal(len(wave))
    x = wave.astype(np.float32)
    f0 = frame_f0(wave, f0_true)
    kw = dict(fs=FS, fft_size=FFT, hop=HOP)
    got = world_device.d4c_device(torch.from_numpy(x), torch.from_numpy(f0), **kw).numpy()
    want = np.asarray(jwd.d4c_device(jnp.asarray(x), jnp.asarray(f0), **kw))
    assert (got[:, 0] > 0.99).sum() >= 3  # the unvoiced head
    np.testing.assert_array_equal(got[:, 0] > 0.99, want[:, 0] > 0.99)
    if name == "breathy":
        near(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-2 and np.abs(got - want).mean() <= 1e-3
        golden = d4c.d4c(x.astype(np.float64), f0.astype(np.float64),
                         np.arange(len(f0)) * HOP / FS, FS, FFT)
        assert np.abs(got - golden)[3:].mean() <= 0.05  # test_world_device.py's bound


def test_synthesis_responses_twin_with_the_jax_noise():
    n_frames, fft = 24, FFT
    rng = np.random.default_rng(4)
    f0 = np.where(np.arange(n_frames) < 4, 0.0, 180.0 + 40 * np.sin(np.arange(n_frames) / 3))
    env = (np.geomspace(1e-1, 1e-6, fft // 2 + 1)[None] * rng.uniform(0.5, 2, (n_frames, 1))).astype(np.float32)
    ap = rng.uniform(0.01, 0.9, (n_frames, fft // 2 + 1)).astype(np.float32)
    pulses = world_device.extract_pulses(np.where(f0 < FS / fft + 1, 0.0, f0), FS, HOP)
    pb = world_device._bucket(pulses[0].size, 512)
    tensors = world_device._pulse_tensors(pulses, pb, "cpu")
    key = jax.random.PRNGKey(9)
    y_pad = n_frames * HOP + 2 * fft
    want = jwd.synthesis_responses_device(
        jnp.asarray(env), jnp.asarray(ap),
        *(jnp.asarray(t.numpy().astype(np.int32) if t.dtype == torch.int64 else t.numpy())
          for t in tensors), key, fft_size=fft, fs=FS, y_pad_length=y_pad)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (pb, fft), jnp.float32)))
    got = world_device.synthesis_responses_device(torch.from_numpy(env), torch.from_numpy(ap),
                                                  *tensors, noise, fft_size=fft, fs=FS,
                                                  y_pad_length=y_pad)
    near(got, want)


def jax_split_noise(x_len: int, pb: int, fft: int):
    """The draws of the JAX twin's ``_decompose_program`` at PRNGKey(0)."""
    key, kn = jax.random.split(jax.random.PRNGKey(0))
    k1, k2 = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.normal(kn, (x_len,), jnp.float32), jax.random.normal(k1, (pb, fft), jnp.float32),
        jax.random.normal(k2, (pb, fft), jnp.float32)))


@pytest.mark.parametrize("name,f0_scale", [("vowel_pulse", 1.0), ("breathy", 1.0), ("noise", 0.0)])
def test_split_twin_with_the_jax_noise(name, f0_scale):
    wave, f0_true = bank(name)
    # the samples the JAX twin analyzes: its int16 transport (peak / 32000)
    # applied beforehand, so that both twins see the same input (on a clean
    # tone a step of the input moves D4C's group delay by up to 1e-2)
    scale = np.abs(wave).max() / 32000.0 + 1e-30
    wave = np.clip(np.round(wave / scale), -32767, 32767).astype(np.float32) * np.float32(scale)
    f0 = frame_f0(wave, f0_true * f0_scale)
    kw = dict(fs=FS, fft_size=FFT, hop=HOP)
    want = jwd.world_harmonic_aperiodic_device(wave, f0, **kw)
    n_frames = len(f0)
    fb = world_device._bucket(n_frames, 64)
    pulses = world_device.extract_pulses(
        np.where(f0 < FS / FFT + 1, 0.0, f0.astype(np.float64)), FS, HOP)
    pb = world_device._bucket(pulses[0].size, 512)
    got = world_device.world_harmonic_aperiodic_device(
        wave, f0, device="cpu", noise=jax_split_noise(fb * HOP + FFT, pb, FFT), **kw)
    for g, w in zip(got, want):
        near(g, w, 5e-4)


def test_host_split_equals_the_jax_host_split():
    wave, f0_true = bank("vowel_pulse", 0.3)
    f0 = frame_f0(wave, f0_true)
    kw = dict(fs=FS, fft_size=FFT, hop=HOP)
    want = jworld.world_harmonic_aperiodic(wave, f0, backend="host", **kw)
    got = world.world_harmonic_aperiodic(wave, f0, backend="host", device="cpu", **kw)
    for g, w in zip(got, want):
        near(g, w)


def test_the_twin_draws_the_same_noise_on_every_device_and_call():
    wave, f0_true = bank("breathy", 0.3)
    f0 = frame_f0(wave, f0_true)
    kw = dict(fs=FS, fft_size=FFT, hop=HOP, device="cpu")
    a = world_device.world_harmonic_aperiodic_device(wave, f0, **kw)
    b = world_device.world_harmonic_aperiodic_device(torch.from_numpy(wave.astype(np.float32)),
                                                     f0, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_backend_resolution(monkeypatch):
    monkeypatch.delenv("DS_WORLD_BACKEND", raising=False)
    assert world.resolve_world_backend("cpu") == "host"
    assert world.resolve_world_backend(torch.device("cuda")) == "device"
    # a spawned binarizer worker resolves from its device too
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        assert pool.starmap(world.resolve_world_backend, [("cuda",), ("cpu",)]) == ["device", "host"]
    assert world.resolve_world_backend("cpu", "device") == "device"
    monkeypatch.setenv("DS_WORLD_BACKEND", "device")
    assert world.resolve_world_backend("cpu") == "device"
    with pytest.raises(ValueError, match="WORLD backend"):
        world.resolve_world_backend("cpu", "gpu")


def test_segment_sum_is_bincount_and_the_same_on_every_run():
    rng = np.random.default_rng(3)
    index = rng.integers(0, 5000, 400_000)
    values = rng.standard_normal(400_000).astype(np.float32)
    runs = [world_device.segment_sum(torch.from_numpy(index), torch.from_numpy(values), 5003)
            for _ in range(3)]
    want = np.bincount(index, weights=values.astype(np.float64), minlength=5003)
    assert runs[0].shape == (5003,) and runs[0].dtype == torch.float32
    np.testing.assert_allclose(runs[0].numpy(), want, rtol=0, atol=1e-3)
    assert all(torch.equal(r, runs[0]) for r in runs)

"""The DDSP vocoders of the PyTorch port against the JAX package's, on the CPU
in float32.

* ``DDSP`` (pc-ddsp CombSub): a bundle traced with ``torch.jit.trace`` as
  ``tests/test_ddsp_convert.py`` builds one, with ``n_mag_* == bins`` and with
  fewer bands (``_to_bins`` resamples). The port converts the ``.jit`` bundle
  itself, then reads the ``.dsckpt`` that the JAX converter writes; both
  against the JAX ``DDSP`` on the same mel and on the JAX draw of its noise.
* ``DDSPNative``: a JAX trainer's ``.dsckpt`` read by both packages, the JAX
  draws injected; ``multi_resolution_stft_loss`` and its gradient.

Tolerances. The control networks and the noise branch 1e-5. The sources'
phases: the port sums them in float64 (as the reference's pc-ddsp does) and
rounds the wrapped phase to float32; the JAX package sums in float32, and
that sum's drift grows with the length. So the waveforms are held to a
share of their peak chosen from the measured difference: CombSub 1.3e-3 of
the peak at 24 frames (2.6e-3 at 40, 1.9e-2 at 200), held to 5e-3; the
sine bank's 64 harmonics multiply the drift, 3.3e-3 at 24 frames (6.4e-3 at
40), held to 1e-2. The loss 1e-5 relative; its gradient, ill-conditioned in
float32, within 1e-2 of the largest entry of the JAX one (4e-5 to 6.5e-3
measured over six seeds) and as close to the float64 gradient as the JAX
package's, within 3x.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffsinger_tpu.vocoders import ddsp_combsub as jcombsub
from diffsinger_tpu.vocoders import ddsp_native as jnative
from diffsinger_tpu.vocoders.ddsp import DDSP as JaxDDSP
from diffsinger_tpu_torch.vocoders import ddsp_combsub, ddsp_convert, ddsp_native
from diffsinger_tpu_torch.vocoders.ddsp import DDSP
from tests.test_ddsp_convert import BINS, BLOCK, MELS, SR, WIN, TorchCombSub, TorchMel2Control

T = 24
COMBSUB_TOL = 5e-3
NATIVE_TOL = 1e-2


class TorchControlOnly(torch.nn.Module):
    """A bundle with fewer control bands than bins: only its Mel2Control's
    parameters and its config matter to a converter."""

    def __init__(self, n_out):
        super().__init__()
        self.mel2ctrl = TorchMel2Control(MELS, n_out)

    def forward(self, mel):
        return self.mel2ctrl(mel)


CASES = {"bins": (BINS, BINS), "fewer": (96, 40)}


@pytest.fixture(scope="module", params=list(CASES))
def bundle(request, tmp_path_factory):
    n_harm, n_noise = CASES[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    torch.manual_seed(0)
    mel_t = torch.rand(1, 12, MELS) * 4 - 6
    if n_harm == BINS:
        model = TorchCombSub().eval()
        args = (mel_t, torch.full((1, 12, 1), 220.0), torch.rand(1, 12 * BLOCK) * 2 - 1)
    else:
        model = TorchControlOnly(2 * n_harm + n_noise).eval()
        args = (mel_t,)
    jit_path = tmp / "combsub.jit"
    torch.jit.trace(model, args).save(str(jit_path))
    (tmp / "config.yaml").write_text(yaml.safe_dump({
        "model": {"type": "CombSub", "n_mag_harmonic": n_harm, "n_mag_noise": n_noise},
        "data": {"sampling_rate": SR, "block_size": BLOCK, "win_length": WIN, "n_mels": MELS}}))
    hp = {"vocoder_ckpt": str(jit_path), "mel_base": "e", "audio_sample_rate": SR,
          "audio_num_mel_bins": MELS, "hop_size": BLOCK, "win_size": WIN}
    return hp, (n_harm, n_noise)


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    mel = rng.uniform(-12, -1, (b, T, MELS)).astype(np.float32)
    f0 = rng.uniform(100, 600, (b, T)).astype(np.float32)
    noise = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (b, T * BLOCK),
                                          minval=-1.0, maxval=1.0))
    return mel, f0, noise


def test_ddsp_from_the_bundle_and_from_the_jax_dsckpt_matches_jax(bundle, monkeypatch):
    hp, (n_harm, n_noise) = bundle
    dsckpt = pathlib.Path(hp["vocoder_ckpt"] + ".dsckpt")
    assert not dsckpt.exists()
    converted = DDSP(hp, device="cpu")  # converts the .jit bundle
    assert converted.meta == {"sampling_rate": SR, "block_size": BLOCK, "win_length": WIN,
                              "n_mag_harmonic": n_harm, "n_mag_noise": n_noise, "n_mels": MELS}
    jv = JaxDDSP(hp)  # converts and writes <bundle>.dsckpt
    assert dsckpt.exists()
    monkeypatch.setattr(ddsp_convert, "convert_torchscript_ddsp", None)  # must not be needed
    native = DDSP(hp, device="cpu")
    for k, v in converted.model.state_dict().items():
        assert torch.allclose(native.model.state_dict()[k], v, atol=1e-7, rtol=0), k

    mel, f0, noise = _inputs(seed=1)
    want = np.asarray(jv.spec2wav_jax(jnp.asarray(mel), jnp.asarray(f0)))  # PRNGKey(0)'s noise
    # the control frames before any phase: mel base e -> log10 on both sides
    ctrl = converted.model.mel2ctrl(torch.from_numpy(0.434294 * mel))
    jctrl = jcombsub.Mel2Control(n_harm, n_noise).apply(
        {"params": jv.params["params"]["mel2ctrl"]}, jnp.asarray(0.434294 * mel))
    for k in jctrl:
        np.testing.assert_allclose(ctrl[k].detach().numpy(), np.asarray(jctrl[k]), atol=1e-5)
    for vocoder in (converted, native):
        got = vocoder.spec2wav_torch(torch.from_numpy(mel), torch.from_numpy(f0),
                                     noise=torch.from_numpy(noise)).numpy()
        assert got.shape == want.shape == (2, T * BLOCK)
        assert np.abs(got - want).max() <= COMBSUB_TOL * np.abs(want).max()
    # the host API draws from a generator seeded 0: the same at every call
    one = native.spec2wav(mel[0], f0=f0[0])
    assert one.shape == (T * BLOCK,) and np.array_equal(one, native.spec2wav(mel[0], f0=f0[0]))


def test_ddsp_reports_mismatched_parameters_and_refuses_unknown_bundles(bundle, capsys, tmp_path):
    hp, _ = bundle
    DDSP(dict(hp, audio_sample_rate=22050), device="cpu")
    assert "Mismatch parameters: hparams['audio_sample_rate']= 22050 != 44100" in capsys.readouterr().out
    state = {"mel2ctrl.stack.0.weight": np.zeros((64, MELS, 3), np.float32)}
    with pytest.raises(KeyError, match="Bundle inventory"):
        ddsp_convert.convert_combsub_state(state)
    with pytest.raises(FileNotFoundError):
        DDSP(dict(hp, vocoder_ckpt=str(tmp_path / "missing.jit")), device="cpu")


@pytest.mark.parametrize("n", [BINS, 96, 40])
def test_to_bins_is_the_jax_resize(n):
    mags = np.random.default_rng(n).standard_normal((2, 5, n)).astype(np.float32)
    want = (mags if n == BINS else
            jax.image.resize(jnp.asarray(mags), (2, 5, BINS), method="linear"))
    got = ddsp_combsub.to_bins(torch.from_numpy(mags), BINS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_upsample_and_combtooth_match_jax():
    f0 = np.random.default_rng(2).uniform(100, 800, (2, 8)).astype(np.float32)
    up = ddsp_combsub.upsample_align_corners(torch.from_numpy(f0), BLOCK)
    jup = jcombsub.upsample_align_corners(jnp.asarray(f0), BLOCK)
    np.testing.assert_allclose(up.numpy(), np.asarray(jup), atol=1e-4, rtol=1e-6)
    src = ddsp_combsub.combtooth(up, SR).numpy()
    np.testing.assert_allclose(src, np.asarray(jcombsub.combtooth(jup, SR)), atol=1e-3)


# ------------------------------------------------------------------ DDSPNative

@pytest.fixture(scope="module")
def native_pair(tmp_path_factory):
    from diffsinger_tpu.utils.ckpt import save_checkpoint

    tmp = tmp_path_factory.mktemp("native")
    hp = {"audio_sample_rate": SR, "audio_num_mel_bins": 32, "hop_size": BLOCK, "mel_base": 10,
          "vocoder_ckpt": str(tmp / "ddsp_native.dsckpt")}
    jm = jnative.DDSPGenerator(hop_size=BLOCK, sampling_rate=SR)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 32)), jnp.zeros((1, 8)))
    rng = np.random.default_rng(0)  # every parameter off its init
    params = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
                          params)
    save_checkpoint(hp["vocoder_ckpt"], params, category="vocoder", global_step=0)
    return hp, jnative.DDSPNative(hp), ddsp_native.DDSPNative(hp, device="cpu")


def test_ddsp_native_matches_jax_with_its_draws(native_pair, tmp_path):
    hp, jv, pv = native_pair
    rng = np.random.default_rng(3)
    mel = rng.uniform(-5, 0, (2, T, 32)).astype(np.float32)  # log10, as mel_base 10 says
    f0 = rng.uniform(100, 600, (2, T)).astype(np.float32)
    want = np.asarray(jv.spec2wav_jax(jnp.asarray(mel), jnp.asarray(f0)))
    noise = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (2, T * BLOCK),
                                          minval=-1.0, maxval=1.0))
    got = pv.spec2wav_torch(torch.from_numpy(mel), torch.from_numpy(f0),
                            noise=torch.from_numpy(noise)).numpy()
    assert got.shape == want.shape == (2, T * BLOCK)
    assert np.abs(got - want).max() <= NATIVE_TOL * np.abs(want).max()

    # the parts: the control net and the noise branch at 1e-5
    ln_mel = 2.30259 * mel
    amps, mags = pv.model.control(torch.from_numpy(ln_mel))
    jamps, jmags = jnative.ControlNet().apply({"params": jv.params["params"]["control"]},
                                             jnp.asarray(ln_mel))
    np.testing.assert_allclose(amps.detach().numpy(), np.asarray(jamps), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mags.detach().numpy(), np.asarray(jmags), atol=1e-5, rtol=1e-5)
    got_noise = ddsp_native.filtered_noise(mags, BLOCK, torch.from_numpy(noise))
    want_noise = jnative.filtered_noise(jmags, BLOCK, jax.random.PRNGKey(0))
    np.testing.assert_allclose(got_noise.detach().numpy(), np.asarray(want_noise), atol=1e-5)

    # a torch file of the generator's state dict loads the same weights
    torch.save(pv.model.state_dict(), tmp_path / "gen.ckpt")
    again = ddsp_native.DDSPNative(dict(hp, vocoder_ckpt=str(tmp_path / "gen.ckpt")), device="cpu")
    assert np.array_equal(again.spec2wav(mel[0], f0=f0[0]), pv.spec2wav(mel[0], f0=f0[0]))


def test_ddsp_native_without_a_checkpoint_warns():
    hp = {"audio_sample_rate": SR, "audio_num_mel_bins": 32, "hop_size": BLOCK}
    with pytest.warns(UserWarning, match="RANDOM"):
        ddsp_native.DDSPNative(hp, device="cpu")


def test_multi_resolution_stft_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(4)
    pred = rng.standard_normal((2, 4096)).astype(np.float32)
    target = rng.standard_normal((2, 4096)).astype(np.float32)
    jloss, jgrad = jax.value_and_grad(jnative.multi_resolution_stft_loss)(
        jnp.asarray(pred), jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_()
    loss = ddsp_native.multi_resolution_stft_loss(p, torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    scale = np.abs(jgrad).max()
    assert np.abs(p.grad.numpy() - jgrad).max() <= 1e-2 * scale
    # the gradient is ill-conditioned in float32 (both packages' gradients
    # stray from the float64 one by 4e-5 to 8e-3 of the largest entry over
    # seeds): the port's error against float64 within 3x the JAX package's
    p64 = torch.from_numpy(pred).double().requires_grad_()
    ddsp_native.multi_resolution_stft_loss(p64, torch.from_numpy(target).double()).backward()
    truth = p64.grad.numpy()
    jax_err = max(np.abs(jgrad - truth).max(), 1e-4 * scale)
    assert np.abs(p.grad.numpy() - truth).max() <= 3 * jax_err

"""RMVPE in the port against the JAX package, on the CPU in float32.

A narrow ``E2E0`` (seeded, BatchNorm statistics moved off their defaults)
goes through the JAX package's ``convert_rmvpe``: activations within 1e-4.
The frontend (resampling to 16 kHz, HTK log-mel) within 1e-4 of the JAX
one's largest entry; the cents decoders, numpy copies, to 1e-12. Then one
saved checkpoint of the full-width extractor (``{"model": state dict}``)
read by both packages' ``RMVPE``: the same voiced frames, f0 within 1e-4
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models import rmvpe as jrmvpe
from diffsinger_tpu_torch.models import rmvpe

SR = 44100


def seeded(model, seed):
    torch.manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
            torch.nn.init.normal_(m.weight, 0, 0.2)
            if m.bias is not None:
                torch.nn.init.normal_(m.bias, 0, 0.1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
                m.running_mean.normal_(0, 0.3)
                m.running_var.uniform_(0.5, 2.0)
    return model.eval()


def sung(seconds=1.2, seed=0):
    t = np.arange(int(seconds * SR)) / SR
    f0 = 220 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    y = sum(0.3 / h * np.sin(h * phase) for h in range(1, 6)) * (t > 0.2)
    return (y + 0.01 * np.random.default_rng(seed).standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("rmvpe") / "rmvpe.pt"
    torch.save({"model": seeded(rmvpe.E2E0(4, 1, (2, 2)), 3).state_dict()}, path)
    return path


def test_narrow_e2e0_matches_the_jax_model_through_its_converter():
    model = seeded(rmvpe.E2E0(2, 1, (2, 2), en_de_layers=3, inter_layers=2), 0)
    mel = np.random.default_rng(0).standard_normal((2, 64, 128)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(mel).transpose(1, 2)).numpy()
    params = jax.tree.map(jnp.asarray, jrmvpe.convert_rmvpe(
        model.state_dict(), n_blocks=2, en_de_layers=3, inter_layers=2))
    jmodel = jrmvpe.E2E0(2, 1, (2, 2), en_de_layers=3, inter_layers=2)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(mel)))
    assert got.shape == want.shape == (2, 64, 360)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_state_dict_names_are_the_references():
    keys = set(rmvpe.E2E0(4, 1, (2, 2)).state_dict())
    for name in ("unet.encoder.bn.running_var", "unet.encoder.layers.0.conv.0.conv.0.weight",
                 "unet.encoder.layers.4.conv.3.conv.4.running_mean",
                 "unet.intermediate.layers.3.conv.3.conv.3.weight",
                 "unet.intermediate.layers.0.conv.0.shortcut.bias",
                 "unet.decoder.layers.0.conv1.0.weight", "unet.decoder.layers.4.conv1.1.weight",
                 "unet.decoder.layers.2.conv2.0.shortcut.weight", "unet.tf.layers.4.conv.0.weight",
                 "cnn.weight", "fc.0.gru.weight_ih_l0", "fc.0.gru.bias_hh_l0_reverse",
                 "fc.1.weight", "fc.1.bias"):
        assert name in keys, name


def test_decoders_equal_the_jax_packages():
    rng = np.random.default_rng(1)
    hidden = rng.uniform(0, 0.2, (50, 360)).astype(np.float32)
    hidden[np.arange(50), 100 + np.arange(50)] = rng.uniform(0, 1, 50)
    for fn in ("to_local_average_f0", "to_viterbi_f0"):
        np.testing.assert_allclose(getattr(rmvpe, fn)(hidden), getattr(jrmvpe, fn)(hidden),
                                   rtol=0, atol=1e-12)


def test_frontend_matches_the_jax_frontend(checkpoint):
    from diffsinger_tpu.dsp.resample import resample_jax
    from diffsinger_tpu_torch.dsp.resample import resample

    y = sung(0.5)[None]
    port = rmvpe.RMVPE(checkpoint, device="cpu")
    got = port.mel(resample(torch.from_numpy(y), SR, 16000)).numpy()
    jax_pe = jrmvpe.RMVPE(checkpoint)
    want = np.asarray(jax_pe._frontend(resample_jax(jnp.asarray(y), SR, 16000)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_get_pitch_reads_one_checkpoint_in_both_packages(checkpoint):
    y = sung()
    length = len(y) // 512 + 1
    port = rmvpe.RMVPE(checkpoint, device="cpu")
    jax_pe = jrmvpe.RMVPE(checkpoint)
    assert port.provenance() == jax_pe.provenance() == "rmvpe(rmvpe.pt)"
    for interp_uv in (False, True):
        f0, uv = port.get_pitch(y, SR, length, hop_size=512, interp_uv=interp_uv)
        f0_j, uv_j = jax_pe.get_pitch(y, SR, length, hop_size=512, interp_uv=interp_uv)
        assert f0.shape == (length,) and f0.dtype == f0_j.dtype
        np.testing.assert_array_equal(uv, uv_j)
        np.testing.assert_allclose(f0, f0_j, rtol=1e-4, atol=0)
    assert port.seconds["network"] > 0 and port.seconds["decode"] > 0


def test_a_checkpoint_that_does_not_load_raises(checkpoint, tmp_path):
    state = torch.load(checkpoint)["model"]
    state.pop("fc.1.bias")
    torch.save({"model": state}, tmp_path / "broken.pt")
    with pytest.raises(RuntimeError, match="fc.1.bias"):
        rmvpe.RMVPE(tmp_path / "broken.pt", device="cpu")
    with pytest.raises(FileNotFoundError):
        rmvpe.RMVPE(tmp_path / "missing.pt", device="cpu")

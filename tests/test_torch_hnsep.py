"""The vocal-remover CascadedNet in the port against the JAX package, on the
CPU in float32.

A narrow net (n_fft 256, nout 8, nout_lstm 16; seeded, BatchNorm statistics
moved off their defaults), stereo and mono, goes through the JAX package's
``convert_cascaded_net``: the complex mask within 1e-4. Then one saved
checkpoint and its ``config.yaml`` read by both packages'
``predict_harmonic``: the harmonic part within 1e-4 of its peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffsinger_tpu.models import hnsep as jhnsep
from diffsinger_tpu_torch.models import hnsep

N_FFT, HOP = 256, 64


def seeded(model, seed):
    torch.manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm1d)):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
                m.running_mean.normal_(0, 0.3)
                m.running_var.uniform_(0.5, 2.0)
    return model.eval()


def net(is_mono, seed=0):
    return seeded(hnsep.CascadedNet(N_FFT, HOP, nout=8, nout_lstm=16, is_complex=True,
                                    is_mono=is_mono), seed)


@pytest.mark.parametrize("is_mono", [False, True])
def test_narrow_net_matches_the_jax_model_through_its_converter(is_mono):
    model = net(is_mono)
    rng = np.random.default_rng(1)
    shape = (1, 1 if is_mono else 2, N_FFT // 2 + 1, 32)
    spec = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    with torch.no_grad():
        got = model(torch.from_numpy(spec)).numpy()
    params = jax.tree.map(jnp.asarray, jhnsep.convert_cascaded_net(model.state_dict()))
    jnet = jhnsep.CascadedNet(N_FFT, HOP, nout=8, nout_lstm=16, is_complex=True, is_mono=is_mono)
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(spec)))
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got.real, want.real, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.imag, want.imag, rtol=0, atol=1e-4)


def test_state_dict_names_are_the_references():
    keys = set(hnsep.CascadedNet(2048, 512).state_dict())
    for name in ("stg1_low_band_net.0.enc1.conv.0.weight", "stg1_low_band_net.1.conv.1.running_var",
                 "stg1_high_band_net.aspp.conv1.1.conv.0.weight",
                 "stg2_low_band_net.0.enc5.conv2.conv.1.bias",
                 "stg2_high_band_net.dec1.conv1.conv.0.weight",
                 "stg3_full_band_net.lstm_dec2.lstm.weight_hh_l0_reverse",
                 "stg3_full_band_net.lstm_dec2.dense.0.weight",
                 "stg3_full_band_net.lstm_dec2.dense.1.running_mean",
                 "out.weight", "aux_out.weight"):
        assert name in keys, name


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    folder = tmp_path_factory.mktemp("hnsep")
    torch.save(net(False, seed=3).state_dict(), folder / "model.pt")
    (folder / "config.yaml").write_text(yaml.safe_dump(
        {"n_fft": N_FFT, "hop_length": HOP, "n_out": 8, "n_out_lstm": 16, "is_mono": False}))
    return folder / "model.pt"


def test_predict_harmonic_reads_one_checkpoint_in_both_packages(checkpoint):
    sr = 8000
    t = np.arange(int(0.6 * sr)) / sr
    wav = (0.4 * np.sin(2 * np.pi * 220 * t)
           + 0.05 * np.random.default_rng(7).standard_normal(len(t))).astype(np.float32)
    got = hnsep.predict_harmonic(checkpoint, wav, device="cpu")
    want = jhnsep.predict_harmonic(checkpoint, wav)
    assert got.shape == want.shape == wav.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    # a tensor's device decides where it runs; the model is cached by path and device
    again = hnsep.predict_harmonic(checkpoint, torch.from_numpy(wav))
    assert torch.equal(again, got)
    assert sum(str(checkpoint.resolve()) == k[0] for k in hnsep._SEP_CACHE) == 1


def test_a_checkpoint_that_does_not_load_raises(checkpoint, tmp_path):
    state = torch.load(checkpoint)
    state.pop("out.weight")
    torch.save(state, tmp_path / "model.pt")
    (tmp_path / "config.yaml").write_text(checkpoint.with_name("config.yaml").read_text())
    with pytest.raises(RuntimeError, match="out.weight"):
        hnsep.predict_harmonic(tmp_path / "model.pt", np.zeros(1000, np.float32), device="cpu")

"""The port's servers over several devices (``devices=[...]``) against the
one-device server and the JAX package's ``mesh=`` server, on the CPU.

Both servers load one experiment folder (``tests/torch_parity.py::make_exp``).
The chunks run in turn on replicas on two or three CPU devices, each whole
and with the generator the one-device server gives it, so every output
equals the one-device server's exactly. The JAX ``mesh=`` server instead
shards a chunk's rows, padded to a multiple of its devices; its real rows
keep their one-device draws. Against it the port takes the JAX draws through
its noise hooks; tolerances as in ``test_torch_serving.py``.
"""

import jax
import numpy as np
import pytest
import torch

from diffsinger_tpu.config import load_config as jax_load_config
from diffsinger_tpu.inference.serving import AcousticServer as JaxServer
from diffsinger_tpu.inference.serving import VarianceServer as JaxVarianceServer
from diffsinger_tpu.parallel.mesh import create_mesh
from diffsinger_tpu_torch.config import load_config
from diffsinger_tpu_torch.inference.serving import AcousticServer, VarianceServer
from tests.test_torch_serving import OVERRIDES, SERVED_TOL, _score
from tests.test_torch_variance_infer import SCORE_ONLY, VARS, jax_variance_noise
from tests.torch_parity import jax_sampler_noise, jax_vocoder_noise, load_ds, make_exp, \
    make_variance_exp

CPU = torch.device("cpu")
SEGMENTS = dict(indices=(1, 3, 6, 0))  # static mixes: one chunk of 3 rows, then 1 row


@pytest.fixture(scope="module")
def acoustic(tmp_path_factory):
    ckpt_root = make_exp(tmp_path_factory.mktemp("exp"), "tiny_dist_serving", OVERRIDES)
    php = load_config(exp_name="tiny_dist_serving", infer=True, ckpt_root=ckpt_root)
    jhp = jax_load_config(exp_name="tiny_dist_serving", infer=True, ckpt_root=ckpt_root)
    return jhp, {n: AcousticServer(php, max_batch_size=3, devices=[CPU] * n) for n in (1, 2, 3)}


def test_acoustic_server_over_devices_gives_the_one_device_wavs(acoustic):
    """Chunks of 3 and 1 rows, in turn on 1, 2 and 3 devices, with the
    server's own draws (seeded generators) and with injected ones."""
    _, servers = acoustic
    segments = _score(**SEGMENTS)
    one = servers[1]
    assert len(one.replicas) == 1 and len(servers[3].replicas) == 3
    for hooks in ({}, dict(noise_fn=lambda n, shape: jax_sampler_noise(n, shape),
                           vocoder_noise_fn=lambda n, b, t_mel: jax_vocoder_noise(b, t_mel))):
        want = one.synthesize_batch([dict(s) for s in segments], seed=3, steps=2, **hooks)
        assert [s["batch"] for s in one.last_stats] == [3, 1]
        assert one.last_chunk_devices == [0, 0]
        for n in (2, 3):
            got = servers[n].synthesize_batch([dict(s) for s in segments], seed=3, steps=2,
                                              **hooks)
            assert [s["batch"] for s in servers[n].last_stats] == [3, 1]
            assert servers[n].last_chunk_devices == [0, 1]
            for g, w in zip(got, want):
                assert g.shape == w.shape and np.abs(w).max() > 0.05
                np.testing.assert_array_equal(g, w)


def test_acoustic_replica_wav_before_the_int16_step(acoustic):
    """One chunk's float32 waveform on the second replica equals the
    one-device waveform."""
    _, servers = acoustic
    one, two = servers[1], servers[2]
    batches = [one.preprocess_input(s, i) for i, s in enumerate(_score(**SEGMENTS))]
    keys = [one._group_key(b) for b in batches]
    chunk = one._chunks(keys)[0]
    stacked = one._stack(batches, chunk, max(keys[i][0] for i in chunk),
                         max(keys[i][1] for i in chunk))
    want = one._run_wav(stacked, one._generator(5), 2, None, None)
    replica = two.replicas[1]
    assert replica is not two and replica.model is not two.model
    got = replica._run_wav(stacked, replica._generator(5), 2, None, None)
    assert torch.equal(got, want)


def _same_parameters(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    return pa.keys() == pb.keys() and all(
        pa[k].dtype == pb[k].dtype and torch.equal(pa[k], pb[k]) for k in pa)


@pytest.mark.parametrize("precision", ["float32", "bf16"])
def test_replicas_hold_the_runtimes_weights_in_their_dtypes(acoustic, precision):
    """Under bf16 some parameters stay float32 (the vocoder's first one
    among them): a replica keeps every parameter's dtype and value, and a
    chunk on it gives the one-device wav."""
    _, servers = acoustic
    hp = dict(servers[1].hparams, infer_precision=precision)
    two = AcousticServer(hp, max_batch_size=3, devices=[CPU, CPU])
    replica = two.replicas[1]
    assert _same_parameters(replica.model.module, two.model.module)
    assert _same_parameters(replica.vocoder.model, two.vocoder.model)
    batches = [two.preprocess_input(s, i) for i, s in enumerate(_score(indices=(1,)))]
    t_txt, t_mel, _ = two._group_key(batches[0])
    stacked = two._stack(batches, [0], t_txt, t_mel)
    want = two._run_wav(stacked, two._generator(2), 2, None, None)
    got = replica._run_wav(stacked, replica._generator(2), 2, None, None)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_jax_mesh_padding_keeps_the_draws_and_the_port_matches_it(acoustic):
    """The JAX server pads a chunk of 3 rows to 4 for a mesh of 2; its real
    rows keep their draws (equal to its one-device output within 1e-5), and
    the port over two devices, fed the JAX draws, matches it within the
    served tolerance."""
    jhp, servers = acoustic
    segments = _score(indices=(1, 3, 6))
    plain = JaxServer(jhp, max_batch_size=3)
    meshed = JaxServer(jhp, max_batch_size=3, mesh=create_mesh(jax.devices()[:2]))
    want = meshed.synthesize_batch([dict(s) for s in segments], seed=9, steps=2)
    alone = plain.synthesize_batch([dict(s) for s in segments], seed=9, steps=2)
    got = servers[2].synthesize_batch(
        [dict(s) for s in segments], seed=9, steps=2,
        noise_fn=lambda n, shape: jax_sampler_noise(9, shape),
        vocoder_noise_fn=lambda n, b, t_mel: jax_vocoder_noise(b, t_mel))
    for g, w, a in zip(got, want, alone):
        assert np.abs(w - a).max() <= 1e-5
        assert g.shape == w.shape and np.abs(g - w).max() <= SERVED_TOL


@pytest.fixture(scope="module")
def variance(tmp_path_factory):
    ckpt_root = make_variance_exp(tmp_path_factory.mktemp("vexp"), "tiny_dist_variance")
    php = load_config(exp_name="tiny_dist_variance", infer=True, ckpt_root=ckpt_root)
    jhp = jax_load_config(exp_name="tiny_dist_variance", infer=True, ckpt_root=ckpt_root)
    return jhp, {n: VarianceServer(php, max_batch_size=5, devices=[CPU] * n) for n in (1, 2, 3)}


def test_variance_server_over_devices_gives_the_one_device_curves(variance):
    """The 16 segments of the score-only samples in chunks of 5 and fewer
    rows, more chunks than devices, in turn on 1, 2 and 3 devices: durations,
    pitch and every curve are the one-device ones; with the JAX draws
    injected, the two-device server matches the JAX ``mesh=`` server (whose
    chunks do not all divide by its 2 devices) within 1e-4."""
    jhp, servers = variance
    segments = [seg for name in SCORE_ONLY for seg in load_ds(name)]
    flags_list, batches = servers[1]._preprocess_all(segments)
    sizes = [len(c[1]) for c in servers[1].chunks(batches, flags_list)]
    assert len(sizes) > 3 and any(s % 2 for s in sizes), sizes
    want = servers[1].predict_batch(segments, seed=4)
    for n in (2, 3):
        got = servers[n].predict_batch(segments, seed=4)
        for (dur, pitch, var), (wdur, wpitch, wvar) in zip(got, want):
            np.testing.assert_array_equal(dur, wdur)
            np.testing.assert_array_equal(pitch, wpitch)
            for v in VARS:
                np.testing.assert_array_equal(var[v], wvar[v])
    meshed = JaxVarianceServer(jhp, max_batch_size=5, mesh=create_mesh(jax.devices()[:2]))
    jwant = meshed.predict_batch(segments, seed=7)
    got = servers[2].predict_batch(segments, seed=7, noise_fn=jax_variance_noise(7))
    for (dur, pitch, var), (jdur, jpitch, jvar) in zip(got, jwant):
        assert np.array_equal(dur, np.asarray(jdur))
        assert np.abs(pitch - np.asarray(jpitch)).max() <= 1e-4
        for v in VARS:
            assert np.abs(var[v] - np.asarray(jvar[v])).max() <= 1e-4, v

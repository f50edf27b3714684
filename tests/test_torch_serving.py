"""The port's batched ``AcousticServer`` against the JAX package's, on the CPU in float32.

Both servers load one experiment folder (``tests/torch_parity.py::make_exp``) of a
multi-speaker model with a key-shift embedding, so that the speaker-mix embedding
and the partition of chunks by speaker-mix form are on the path. Noise is injected
into the port from the keys the JAX server uses: ``PRNGKey(seed)`` for every chunk's
sampler noise, ``PRNGKey(0)`` inside the vocoder.

Tolerances: grouping, chunks and stacked arrays are equal; a chunk's wav before the
16-bit step max |diff| <= 1e-4; a served segment, which went through
clip -> int16 -> float32, <= 1/32767 + 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.config import load_config as jax_load_config
from diffsinger_tpu.inference.serving import AcousticServer as JaxServer
from diffsinger_tpu_torch.config import load_config
from diffsinger_tpu_torch.inference.serving import AcousticServer
from tests.torch_parity import MELS, jax_sampler_noise, jax_vocoder_noise, load_ds, make_exp

WAV_TOL = 1e-4
SERVED_TOL = 1 / 32767 + 1e-4
OVERRIDES = dict(use_spk_id=True, num_spk=3, use_key_shift_embed=True)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    ckpt_root = make_exp(tmp_path_factory.mktemp("exp"), "tiny_serving", OVERRIDES)
    js = JaxServer(jax_load_config(exp_name="tiny_serving", infer=True, ckpt_root=ckpt_root),
                   max_batch_size=2)
    ps = AcousticServer(load_config(exp_name="tiny_serving", infer=True, ckpt_root=ckpt_root),
                        max_batch_size=2, device="cpu")
    return js, ps


def _score(indices=None, mixes=None):
    """Segments of samples/08 with a speaker mix each (static unless given)."""
    ds = load_ds("08_qiu_yu.ds")
    indices = range(len(ds)) if indices is None else indices
    out = []
    for n, i in enumerate(indices):
        seg = dict(ds[i], spk_mix={"spk0": 0.25, "spk2": 0.75}, gender=0.2 * n - 0.3)
        if mixes and mixes[n]:
            seg.update(mixes[n])
        out.append(seg)
    return out


DYNAMIC = {"spk_mix": {"spk0": "0.2 0.8 0.5", "spk1": 0.5}, "spk_mix_timestep": "2.0"}


def _jax_chunks(js, keys):
    """The chunks of the JAX server's sort-and-pack loop, spelled out."""
    groups = {}
    for i, (_t_txt, _t_mel, spk) in enumerate(keys):
        groups.setdefault(spk, []).append(i)
    chunks = []
    for idxs in groups.values():
        idxs = sorted(idxs, key=lambda i: (keys[i][1], keys[i][0]))
        chunks += [idxs[s: s + js.max_batch_size] for s in range(0, len(idxs), js.max_batch_size)]
    return chunks


# ------------------------------------------------------------------ grouping and stacking
def test_group_keys_and_chunks_match_for_a_whole_score(servers):
    js, ps = servers
    segments = _score(mixes=[None, DYNAMIC, None, None, DYNAMIC, None, None])
    batches = [ps.preprocess_input(s, i) for i, s in enumerate(segments)]
    keys = [ps._group_key(b) for b in batches]
    assert keys == [js._group_key(b) for b in batches]
    assert [k[:2] for k in keys] == [(32, 640), (32, 512), (32, 640), (32, 512), (32, 640),
                                     (32, 640), (32, 512)]
    assert {k[2] for k in keys} == {(2, False), (2, True)}
    chunks = ps._chunks(keys)
    assert chunks == _jax_chunks(js, keys)
    # static mixes: sorted by frame bucket, cut in twos; then the dynamic ones
    assert chunks == [[3, 6], [0, 2], [5], [1, 4]]


@pytest.mark.parametrize("max_batch_size,want", [
    (1, [[1], [3], [6], [0], [2], [4], [5]]),
    (4, [[1, 3, 6, 0], [2, 4, 5]]),
    (16, [[1, 3, 6, 0, 2, 4, 5]]),
])
def test_chunks_at_other_batch_sizes(servers, monkeypatch, max_batch_size, want):
    js, ps = servers
    monkeypatch.setattr(ps, "max_batch_size", max_batch_size)
    monkeypatch.setattr(js, "max_batch_size", max_batch_size)
    keys = [ps._group_key(ps.preprocess_input(s, i)) for i, s in enumerate(_score())]
    assert ps._chunks(keys) == _jax_chunks(js, keys) == want


def test_chunks_sort_by_frame_bucket_before_token_bucket(servers):
    js, ps = servers
    keys = [(32, 640, None), (16, 768, None), (48, 512, None), (16, 512, None), (16, 640, (2, True))]
    assert ps._chunks(keys) == _jax_chunks(js, keys) == [[3, 2], [0, 1], [4]]


def test_stack_gives_equal_arrays(servers):
    js, ps = servers
    segments = _score(mixes=[None, DYNAMIC, None, None, DYNAMIC, None, None])
    batches = [ps.preprocess_input(s, i) for i, s in enumerate(segments)]
    keys = [ps._group_key(b) for b in batches]
    for chunk in ps._chunks(keys):
        t_txt, t_mel = max(keys[i][0] for i in chunk), max(keys[i][1] for i in chunk)
        got = ps._stack(batches, chunk, t_txt, t_mel)
        want = js._stack(batches, chunk, t_txt, t_mel)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["spk_mix_value"].shape[1] == (t_mel if keys[chunk[0]][2][1] else 1)


# ------------------------------------------------------------------ served audio
SERVED = dict(indices=(1, 3, 6), mixes=[None, None, DYNAMIC])


def test_a_chunk_matches_before_the_int16_step(servers):
    js, ps = servers
    batches = [ps.preprocess_input(s, i) for i, s in enumerate(_score(**SERVED))]
    stacked = ps._stack(batches, [1, 0], 32, 512)
    mel, f0 = js._run_group(stacked, jax.random.PRNGKey(4), 2)
    want = np.asarray(js.vocoder.spec2wav_jax(mel, jnp.asarray(f0)))
    got = ps._run_wav(stacked, None, 2, jax_sampler_noise(4, (2, 512, MELS)),
                      jax_vocoder_noise(2, 512)).numpy()
    assert got.shape == want.shape == (2, 512 * 512)
    assert np.abs(want).max() > 0.05
    assert np.abs(got - want).max() <= WAV_TOL


def test_synthesize_batch_matches_segment_by_segment(servers):
    js, ps = servers
    segments = _score(**SERVED)
    want = js.synthesize_batch([dict(s) for s in segments], seed=9, steps=2)
    shapes = []
    got = ps.synthesize_batch(
        [dict(s) for s in segments], seed=9, steps=2,
        noise_fn=lambda n, shape: (shapes.append((n, shape)), jax_sampler_noise(9, shape))[1],
        vocoder_noise_fn=lambda n, b, t_mel: jax_vocoder_noise(b, t_mel))
    # two static mixes in one chunk, the dynamic one in a chunk of its own
    assert shapes == [(0, (2, 512, MELS)), (1, (1, 512, MELS))]
    assert len(got) == len(want) == 3
    for g, w, frames in zip(got, want, (503, 466, 423)):
        assert g.dtype == np.float32 and g.shape == w.shape == (frames * 512,)
        assert np.abs(w).max() > 0.05
        assert np.abs(g - w).max() <= SERVED_TOL
    for g, w in zip(ps.last_stats, js.last_stats):
        assert g.keys() == w.keys() - {"compute_s"}
        for k in ("batch", "t_txt", "t_mel", "wire_mb"):
            assert g[k] == w[k], k
        assert g["dispatch_s"] > 0 and g["fetch_s"] >= 0
    assert [s["batch"] for s in ps.last_stats] == [2, 1]


def test_served_wavs_are_what_int16_holds(servers):
    _, ps = servers
    wavs = ps.synthesize_batch(_score(indices=(6,)), seed=1, steps=2)
    steps16 = wavs[0] * 32767.0
    np.testing.assert_allclose(steps16, np.round(steps16), atol=2e-3)
    assert np.abs(wavs[0]).max() <= 1.0


def test_same_seed_same_wavs_and_the_seed_matters(servers):
    _, ps = servers
    segments = _score(indices=(3, 6))
    a = ps.synthesize_batch(segments, seed=5, steps=2)
    b = ps.synthesize_batch(segments, seed=5, steps=2)
    c = ps.synthesize_batch(segments, seed=6, steps=2)
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        assert (x != z).any()


# ------------------------------------------------------------------ the batched run_inference
def test_run_inference_warns_about_segment_seeds_and_writes_the_score(servers, tmp_path):
    import wave

    js, ps = servers
    ds = load_ds("08_qiu_yu.ds")
    segments = _score(indices=(3, 6))
    segments[1]["offset"] = ds[3]["offset"] + 4.0  # overlaps the first: cross-fade
    segments[0]["seed"] = 123
    with pytest.warns(UserWarning, match="ignores per-segment 'seed'"):
        js.run_inference([dict(s) for s in segments], out_dir=tmp_path / "jax", title="t",
                         seed=8, steps=2)
    with pytest.warns(UserWarning, match="ignores per-segment 'seed'"):
        ps.run_inference([dict(s) for s in segments], out_dir=tmp_path / "port", title="t",
                         seed=8, steps=2,
                         noise_fn=lambda n, shape: jax_sampler_noise(8, shape),
                         vocoder_noise_fn=lambda n, b, t_mel: jax_vocoder_noise(b, t_mel))
    pcm = []
    for side in ("jax", "port"):
        with wave.open(str(tmp_path / side / "t.wav")) as f:
            assert f.getframerate() == 44100
            pcm.append(np.frombuffer(f.readframes(f.getnframes()), np.int16).astype(np.int32))
    assert pcm[0].shape == pcm[1].shape and np.abs(pcm[0]).max() > 1000
    assert np.abs(pcm[0] - pcm[1]).max() <= 1 + round(SERVED_TOL * 32767)


def test_the_constructor_takes_no_mesh(servers):
    with pytest.raises(TypeError):
        AcousticServer(servers[1].hparams, max_batch_size=2, mesh=object(), device="cpu")


def test_spk_mix_embed_matches(servers):
    js, ps = servers
    rng = np.random.default_rng(0)
    ids = np.array([[[0, 2]], [[1, 2]]], np.int32)
    values = rng.uniform(0, 1, (2, 5, 2)).astype(np.float32)
    want = js._spk_mix_embed(js.params, jnp.asarray(ids), jnp.asarray(values))
    got = ps._spk_mix_embed(torch.from_numpy(ids), torch.from_numpy(values))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)

"""The plain reference against the port's CPU path, at narrow widths on the
same seeded weights and noise: the networks one by one, the host side, and
whole runs through the servers' timed path."""

import numpy as np
import pytest
import torch

from benchmark import generator, weights
from benchmark.reference import preprocess as pp
from benchmark.reference.acoustic import AcousticReference
from benchmark.reference.variance import VarianceReference
from benchmark.reference.vocoder import VocoderReference
from benchmark.run import execute
from benchmark.tests import tiny

TS = 512 / 44100
VOCAB = 50


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def same_weights(program_module, reference_module, seed):
    assert sorted(weights.shapes_of(program_module)) == sorted(weights.shapes_of(reference_module))
    values = weights.make(weights.shapes_of(reference_module), seed, "cpu", torch.bfloat16)
    weights.fill(program_module, values)
    weights.fill(reference_module, values)


def test_acoustic_model_and_vocoder():
    from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
    from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import (Generator, NsfHifiGanConfig,
                                                                 VocoderNoise)

    cfg = tiny.config("acoustic")
    hp = cfg["hparams"]
    prog = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=128, device="cpu")
    ref = AcousticReference(hp, VOCAB)
    same_weights(prog.module, ref, 3)
    g = torch.Generator().manual_seed(0)
    b, t = 2, 256
    tokens = torch.randint(1, VOCAB, (b, 16), generator=g)
    tokens[1, 12:] = 0
    mel2ph = torch.sort(torch.randint(1, 13, (b, t), generator=g), dim=1).values
    mel2ph[1, 200:] = 0
    f0 = 200 + 50 * torch.rand(b, t, generator=g)
    noise = torch.randn(b, t, 128, generator=g)
    want = ref(tokens, mel2ph, f0, noise)
    got = prog.forward_infer(tokens, mel2ph, f0, noise=noise).diff_out
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()

    gen = Generator(NsfHifiGanConfig.from_json(cfg["vocoder"]), device="cpu")
    voc = VocoderReference(cfg["vocoder"])
    same_weights(gen, voc, 4)
    rand_ini, source = torch.rand(1, 1, 9, generator=g), torch.randn(b, t * 512, 9, generator=g)
    with torch.no_grad():
        got = gen(want, f0, noise=VocoderNoise(rand_ini=rand_ini, source=source))
    assert (got - voc(want, f0, rand_ini, source)).abs().max() <= 1e-5


@pytest.mark.parametrize("curves_on", [False, True], ids=["published", "curves"])
def test_variance_model(curves_on):
    from diffsinger_tpu_torch.models.toplevel import DiffSingerVariance
    from diffsinger_tpu_torch.utils.seq import rhythm_regulator

    hp = tiny.config("variance", curves=curves_on)["hparams"]
    prog = DiffSingerVariance(hp, vocab_size=VOCAB, device="cpu")
    ref = VarianceReference(hp, VOCAB)
    same_weights(prog.module, ref, 5)
    g = torch.Generator().manual_seed(1)
    b, t_ph, t = 2, 16, 256
    tokens = torch.randint(1, VOCAB, (b, t_ph), generator=g)
    ph2word = torch.cumsum(torch.randint(0, 2, (b, t_ph), generator=g), dim=1) + 1
    tokens[1, 12:] = 0
    ph2word[1, 12:] = 0
    words = int(ph2word.max())
    word_dur = torch.full((b, words), 200 // words)
    midi = torch.randint(40, 80, (b, t_ph), generator=g)
    base = 60 + torch.randn(b, t, generator=g)
    expr = torch.ones(b, t)
    z_p, z_v = torch.randn(b, t, 64, generator=g), torch.randn(b, t, 48, generator=g)
    dur, pitch, curves = ref(tokens, midi, ph2word, word_dur, base, expr, z_p, z_v)
    d, p, v = prog.forward_infer(tokens, midi, ph2word, base, word_dur=word_dur, pitch_expr=expr,
                                 noise_pitch=z_p, noise_variances=z_v)
    assert torch.equal(rhythm_regulator(d, ph2word, word_dur).long(), dur)
    assert (base + p - pitch).abs().max() <= 1e-4
    assert sorted(v) == sorted(curves) and len(curves) == 4 * curves_on
    for name, curve in curves.items():
        assert (v[name] - curve).abs().max() <= 1e-4


@pytest.mark.parametrize("kind", ["render_songs", "score_songs"])
def test_host_side(kind, tmp_path):
    """The reference's arrays and chunks are the servers' own."""
    from diffsinger_tpu_torch.inference.serving import AcousticServer, VarianceServer

    mix = generator.load_mix(kind)
    song = generator.songs(mix, 99, TS)[0]
    ids = pp.phoneme_ids(generator.DICTIONARY)
    name = "acoustic" if kind == "render_songs" else "variance"
    hp = dict(tiny.config(name)["hparams"], work_dir=str(tmp_path),
              dictionary=str(generator.DICTIONARY))
    if name == "acoustic":
        server = AcousticServer(hp, max_batch_size=16, device="cpu", load_vocoder=False)
        batches = [server.preprocess_input(seg) for seg in song]
        arrays = [pp.acoustic_arrays(seg, ids, TS) for seg in song]
        for a, bt in zip(arrays, batches):
            for key in ("tokens", "mel2ph", "f0"):
                np.testing.assert_array_equal(a[key], bt[key][0])
        keys = [server._group_key(bt) for bt in batches]
        assert [c for c, _, _ in pp.acoustic_chunks(arrays, 16)] == server._chunks(keys)
    else:
        server = VarianceServer(hp, max_batch_size=16, device="cpu")
        flags, batches = server._preprocess_all(song)
        smooth = max(1, round(hp["midi_smooth_width"] / TS))
        arrays = [pp.variance_arrays(seg, ids, TS, smooth) for seg in song]
        for a, bt in zip(arrays, batches):
            for key in ("tokens", "midi", "ph2word", "word_dur", "base_pitch", "expr"):
                np.testing.assert_array_equal(a[key], bt[key][0])
        want = [(c, shapes) for c, shapes in pp.variance_chunks(arrays, 16)]
        assert want == [(c, shapes) for _, c, shapes in server.chunks(batches, flags)]


TINY_MIX = {"phrases_per_song": [3, 4], "phrase_seconds": [2.0, 4.0], "songs_in_plan": 3,
            "reference_phrases": 3}


@pytest.mark.parametrize("cell,config", [("acoustic.render", "acoustic"),
                                         ("variance.predict", "variance")])
def test_a_run_through_the_timed_path(cell, config):
    """A whole run on the CPU in float32: the program's answers equal the
    reference's to float32 rounding."""
    mix = dict(generator.load_mix("render_songs" if config == "acoustic" else "score_songs"),
               **TINY_MIX)
    run = execute(cell, 2**31 + 7, 0.1, False, torch.device("cpu"), config=tiny.config(config),
                  mix=mix)
    assert run.attempted >= 1 and run.e2e["song_s_per_s"] > 0
    assert run.checks and all(c.ok for c in run.checks)
    for c in run.checks:
        assert c.value <= 1e-4, c

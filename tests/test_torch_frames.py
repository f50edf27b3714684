"""The entry points run their request loops from the roomy frame of
``utils/frames.py`` (CPython's frame stack, ``tools/probe_pt2_host.py``).

No CPU timing can see a loop that lands on a chunk boundary of the frame
stack, so these tests hold the wiring: every denoiser call of the acoustic
model's ``forward_infer`` and ``forward_infer_dynamic``, the variance model's
``forward_infer`` and deployed views, and the vocoder's generator call, find
the ``with_room`` frame on their stack; and the outputs are bit for bit those
of a direct call.
"""

import sys

import numpy as np
import pytest
import torch

from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic, DiffSingerVariance
from diffsinger_tpu_torch.utils import frames
from tests.torch_parity import HP, MELS, VAR_HP, VOCAB, acoustic_inputs, port_kwargs


def in_room() -> bool:
    f = sys._getframe()
    while f is not None:
        if f.f_code.co_name == "with_room" and f.f_code.co_filename == "<with_room>":
            return True
        f = f.f_back
    return False


def spy(module) -> list:
    seen = []
    module.register_forward_pre_hook(lambda *_: seen.append(in_room()))
    return seen


@pytest.fixture
def direct(monkeypatch):
    """Run the entry points without the roomy frame."""
    def run(fn):
        with monkeypatch.context() as m:
            m.setattr(frames, "_roomy", lambda: (lambda f, *a, **k: f(*a, **k)))
            return fn()
    return run


def test_with_room_passes_arguments_and_results():
    assert frames.with_room(lambda a, b=0: (a, b, in_room()), 1, b=2) == (1, 2, True)
    assert not in_room()


def test_acoustic_entry_points_run_in_the_roomy_frame(direct):
    torch.manual_seed(0)
    model = DiffSingerAcoustic(HP, vocab_size=VOCAB, out_dims=MELS, device="cpu")
    seen = spy(model.module.denoiser)
    inp = acoustic_inputs(seed=1, t_mel=32)
    args = [torch.from_numpy(inp[k]) for k in ("tokens", "mel2ph", "f0")]
    noise = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 32, MELS))
                             .astype(np.float32))

    def infer():
        return model.forward_infer(*args, noise=noise, **port_kwargs(inp)).diff_out

    def dynamic():
        return model.forward_infer_dynamic(*args, depth=torch.tensor(0.6), steps=torch.tensor(3),
                                           noise=noise, **port_kwargs(inp)).diff_out

    for fn in (infer, dynamic):
        out = fn()
        assert seen and all(seen)
        seen.clear()
        assert torch.equal(out, direct(fn))
        assert seen and not any(seen)
        seen.clear()


def test_variance_entry_points_run_in_the_roomy_frame(direct):
    torch.manual_seed(0)
    hp = dict(VAR_HP, hop_size=512, audio_sample_rate=44100, midi_smooth_width=0.06)
    model = DiffSingerVariance(hp, vocab_size=VOCAB, device="cpu")
    seen = spy(model.module.pitch_denoiser)
    seen_var = spy(model.module.variance_denoiser)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(1, VOCAB, (1, 6)).astype(np.int32))
    ph2word = torch.tensor([[1, 1, 2, 3, 3, 4]], dtype=torch.int32)
    ph_dur = torch.tensor([[4, 5, 6, 3, 5, 7]], dtype=torch.int32)
    pitch = torch.full((1, 30), 62.0)
    enc = torch.from_numpy(rng.standard_normal((1, 6, hp["hidden_size"])).astype(np.float32))
    variances = {v: torch.full((1, 30), -40.0) for v in model.var_list}
    retake = torch.ones((1, 30, len(model.var_list)), dtype=torch.bool)

    calls = {
        "forward_infer": lambda: model.forward_infer(
            tokens, torch.full((1, 6), 60, dtype=torch.int32), ph2word, pitch,
            word_dur=torch.tensor([[9, 6, 8, 7, 0, 0]]), generator=torch.Generator().manual_seed(1)
        )[2]["energy"],
        "forward_pitch_deployed": lambda: model.forward_pitch_deployed(
            enc, ph_dur, torch.full((1, 6), 61.0), ph_dur, pitch, retake[:, :, 0],
            steps=torch.tensor(2), generator=torch.Generator().manual_seed(1)),
        "forward_variance_deployed": lambda: model.forward_variance_deployed(
            enc, ph_dur, pitch, variances, retake, steps=torch.tensor(2),
            generator=torch.Generator().manual_seed(1))[0],
    }
    for name, fn in calls.items():
        out = fn()
        hits = seen + seen_var
        assert hits and all(hits), name
        seen.clear(), seen_var.clear()
        assert torch.equal(out, direct(fn)), name
        assert not any(seen + seen_var), name
        seen.clear(), seen_var.clear()


def test_the_vocoder_runs_in_the_roomy_frame(tmp_path, direct):
    from diffsinger_tpu_torch.vocoders.nsf_hifigan import NsfHifiGAN
    from tests.torch_parity import TINY_VOCODER, make_exp

    make_exp(tmp_path, "voc", acoustic_steps=None)
    vocoder = NsfHifiGAN(dict(vocoder_ckpt=str(tmp_path / "vocoder" / "model.ckpt")),
                         device="cpu")
    seen = spy(vocoder.model)
    mel = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 8, TINY_VOCODER["num_mels"])).astype(np.float32))
    f0 = torch.full((1, 8), 220.0)
    out = vocoder.spec2wav_torch(mel, f0)
    assert seen == [True]
    assert torch.equal(out, direct(lambda: vocoder.spec2wav_torch(mel, f0)))

"""The work counts against PyTorch's FLOP counter run over the reference at
small sizes, and the LYNXNet conv module against a count by hand."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import weights, work
from benchmark.reference.acoustic import AcousticReference, ConvModule
from benchmark.reference.common import Ops
from benchmark.reference.train import TrainReference
from benchmark.reference.variance import VarianceReference
from benchmark.reference.vocoder import VocoderReference
from benchmark.tests import tiny

VOCAB = 40


def counted(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def seeded(module):
    weights.fill(module, weights.make(weights.shapes_of(module), 0, "cpu"))
    return module


def test_convmodule_by_hand():
    b, t, c, inner, k = 2, 10, 32, 64, 31
    w = work.lynx_convmodule(b, t, c, inner, k, elem_bytes=2)
    assert w["tc_flops"] == 2 * b * t * c * 2 * inner + 2 * b * t * inner * c
    assert w["cuda_flops"] == 2 * b * t * inner * k + b * t * (8 * c + 8 * inner)
    params = 2 * inner * c + 2 * inner + inner * k + inner + inner + inner * c + c + 2 * c
    assert w["bytes"] == 2 * (2 * b * t * c + params)
    mod = seeded(ConvModule(c, inner, k))
    x = torch.randn(b, t, c)
    # the counter sees the products: the two 1x1 convolutions and the depthwise one
    assert counted(lambda: mod(Ops(), x)) == w["tc_flops"] + 2 * b * t * inner * k


@pytest.mark.parametrize("b,t_txt,t", [(1, 16, 128), (2, 32, 256)])
def test_acoustic_model(b, t_txt, t):
    cfg = tiny.config("acoustic")
    hp = cfg["hparams"]
    ref = seeded(AcousticReference(hp, VOCAB))
    tokens = torch.randint(1, VOCAB, (b, t_txt))
    mel2ph = torch.sort(torch.randint(1, t_txt + 1, (b, t)), dim=1).values
    f0 = 200 + 100 * torch.rand(b, t)
    noise = torch.randn(b, t, hp["audio_num_mel_bins"])
    assert counted(lambda: ref(tokens, mel2ph, f0, noise)) == pytest.approx(
        work.acoustic(b, t_txt, t, hp), rel=1e-9)


@pytest.mark.parametrize("b,t_txt,t", [(1, 16, 128), (2, 32, 256)])
def test_acoustic_training_forward(b, t_txt, t):
    """A training step's forward: the encoder, the aux decoder and one denoiser call."""
    hp = tiny.config("acoustic")["hparams"]
    ref = seeded(TrainReference(hp, VOCAB))
    tokens = torch.randint(1, VOCAB, (b, t_txt))
    mel2ph = torch.sort(torch.randint(1, t_txt + 1, (b, t)), dim=1).values
    f0 = 200 + 100 * torch.rand(b, t)
    mel = torch.randn(b, t, hp["audio_num_mel_bins"]) - 6
    noise = torch.randn(b, t, hp["audio_num_mel_bins"])
    t_draw = 0.4 + 0.6 * torch.rand(b)
    assert counted(lambda: ref.losses(tokens, mel2ph, f0, mel, t_draw, noise, 1.0)) == \
        pytest.approx(work.acoustic_train(b, t_txt, t, hp), rel=1e-9)


@pytest.mark.parametrize("frames", [4, 9])
def test_vocoder(frames):
    cfg = tiny.config("acoustic")["vocoder"]
    voc = seeded(VocoderReference(cfg))
    mel = torch.randn(2, frames, cfg["num_mels"])
    f0 = 200 + 100 * torch.rand(2, frames)
    noise = torch.randn(2, frames * 512, 9)
    assert counted(lambda: voc(mel, f0, torch.rand(1, 1, 9), noise)) == pytest.approx(
        work.vocoder(2, frames, cfg), rel=1e-9)


@pytest.mark.parametrize("curves", [False, True], ids=["published", "curves"])
@pytest.mark.parametrize("b,t_ph,t", [(1, 16, 128), (2, 32, 256)])
def test_variance_model(b, t_ph, t, curves):
    hp = tiny.config("variance", curves=curves)["hparams"]
    ref = seeded(VarianceReference(hp, VOCAB))
    tokens = torch.randint(1, VOCAB, (b, t_ph))
    ph2word = torch.cumsum(torch.randint(0, 2, (b, t_ph)), dim=1) + 1
    words = int(ph2word.max())
    word_dur = torch.full((b, words), t // words)
    midi = torch.randint(40, 80, (b, t_ph))
    base = 60 + torch.randn(b, t)
    width_p = hp["pitch_prediction_args"]["repeat_bins"]
    width_v = hp["variances_prediction_args"]["total_repeat_bins"]
    assert counted(lambda: ref(tokens, midi, ph2word, word_dur, base, torch.ones(b, t),
                               torch.randn(b, t, width_p), torch.randn(b, t, width_v))) == \
        pytest.approx(work.variance(b, t_ph, t, hp), rel=1e-9)

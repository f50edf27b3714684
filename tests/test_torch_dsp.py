"""The port's binarization DSP against the JAX package's, on the CPU in float32,
on seeded numpy signals: sung tones with a glide and vibrato, unvoiced gaps
and noise.

Tolerances: log-mel mean |diff| <= 2e-4 and max <= 5e-3 with equal frame
counts; the STFT round trip max |diff| <= 1e-5; energy and smoothed curves
<= 1e-4 dB; the ACF extractor's uv equal at every frame, its path the same on
>= 99.5 % of frames and f0 within 1e-3 relative where it is; the harmonic
split within 1e-4 of the signal's peak; the resampler within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.dsp import common as jcommon
from diffsinger_tpu.dsp import decomposed_waveform as jdw
from diffsinger_tpu.dsp import mel as jmel
from diffsinger_tpu.dsp import pe as jpe
from diffsinger_tpu.dsp import resample as jres
from diffsinger_tpu.dsp import stft as jstft
from diffsinger_tpu_torch.dsp import common, decomposed_waveform, mel, pe, resample, stft

SR = 44100
HOP, WIN = 512, 2048


def sung(seed: int, seconds: float) -> np.ndarray:
    """A sung phrase: harmonics of an f0 that glides between two notes with
    vibrato, a silent gap and a breath of noise in the middle, a noise floor."""
    rng = np.random.default_rng(seed)
    n = int(SR * seconds)
    t = np.arange(n) / SR
    f_a, f_b = rng.uniform(150, 400, 2)
    f0 = f_a + (f_b - f_a) / (1 + np.exp(-(t - seconds / 2) * 8))
    f0 *= 2 ** (0.3 / 12 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    y = sum(0.3 / k * np.sin(k * phase) for k in range(1, 8))
    y *= np.clip(np.minimum(t, seconds - t) * 10, 0, 1)
    gap = slice(int(0.40 * n), int(0.48 * n))
    y[gap] = 0.0
    y[int(0.48 * n):int(0.52 * n)] = 0.05 * rng.standard_normal(int(0.52 * n) - int(0.48 * n))
    y += 0.003 * rng.standard_normal(n)
    return y.astype(np.float32)


@pytest.fixture(scope="module")
def wav():
    return sung(0, 2.2)


def cpu(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("keyshift,speed", [(0, 1), (5, 1), (-5, 1), (0, 0.5), (0, 2),
                                            (2.37, 1.21)])
def test_mel(wav, keyshift, speed):
    jm, tm = jmel.MelSpectrogram(), mel.MelSpectrogram()
    want = jm.bucketed(wav, keyshift=keyshift, speed=speed)
    got = tm(cpu(wav)[None], keyshift=keyshift, speed=speed)[0].numpy()
    assert got.shape == want.shape == (128, tm.num_frames(len(wav), keyshift=keyshift, speed=speed))
    diff = np.abs(got - want)
    assert diff.mean() <= 2e-4 and diff.max() <= 5e-3, (diff.mean(), diff.max())
    # bucketed is the plain call, and get_mel its transpose
    np.testing.assert_array_equal(tm.bucketed(wav, keyshift=keyshift, speed=speed, device="cpu"), got)
    np.testing.assert_array_equal(
        mel.get_mel(wav, SR, keyshift=keyshift, speed=speed, device="cpu"), got.T)


def test_stft_istft_round_trip(wav):
    window = stft.nuttall_window(WIN)
    kw = dict(n_fft=WIN, hop=HOP, win_size=WIN)
    want = np.asarray(jstft.stft_complex(jnp.asarray(wav)[None], window=jnp.asarray(window), **kw))
    spec = stft.stft_complex(cpu(wav)[None], window=cpu(window), **kw)
    assert spec.shape == want.shape
    assert np.abs(spec.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    back = stft.istft(spec, window=cpu(window), length=len(wav), **kw)[0].numpy()
    jback = np.asarray(jstft.istft(jnp.asarray(want), window=jnp.asarray(window),
                                   length=len(wav), **kw))[0]
    assert np.abs(back - wav).max() <= 1e-5
    assert np.abs(back - jback).max() <= 1e-5
    # without center or length: the JAX package's whole output, zeros past the
    # frames (the first and last hop, where the window's sum is near 0, amplify
    # rounding and are left out)
    full = stft.istft(spec, window=cpu(window), center=False, **kw)[0].numpy()
    jfull = np.asarray(jstft.istft(jnp.asarray(want), window=jnp.asarray(window),
                                   center=False, **kw))[0]
    span = (spec.shape[1] - 1) * HOP + WIN
    assert full.shape == jfull.shape and not full[span:].any() and not jfull[span:].any()
    assert np.abs(full[HOP:span - HOP] - jfull[HOP:span - HOP]).max() <= 1e-5


@pytest.mark.parametrize("domain", ["db", "amplitude"])
def test_get_energy_and_smoothing(wav, domain):
    length = 1 + len(wav) // HOP + 3  # padded past the frames
    want = jcommon.get_energy(wav, length, hop_size=HOP, win_size=WIN, domain=domain)
    got = common.get_energy(wav, length, hop_size=HOP, win_size=WIN, domain=domain, device="cpu")
    assert got.shape == want.shape == (length,)
    assert np.abs(got - want).max() <= 1e-4
    k = round(0.12 / (HOP / SR))
    smooth_want = np.asarray(jcommon.sinusoidal_smooth(jnp.asarray(want)[None], k))[0]
    smooth_got = common.sinusoidal_smooth(cpu(got.astype(np.float32))[None], k)[0].numpy()
    assert np.abs(smooth_got - smooth_want).max() <= 1e-4


@pytest.mark.parametrize("very_accurate", [False, True])
@pytest.mark.parametrize("speed", [1, 1.21])
def test_acf_pe(very_accurate, speed):
    y = np.concatenate([sung(1, 1.6), sung(2, 1.3)])
    length = int(len(y) / round(HOP * speed)) + 1
    kw = dict(hop_size=HOP, f0_min=65, f0_max=1100, speed=speed)
    jf0, juv = jpe.AcfPE(very_accurate=very_accurate).get_pitch(y, SR, length, **kw)
    extractor = pe.AcfPE(very_accurate=very_accurate)
    f0, uv = extractor.get_pitch(y, SR, length, device="cpu", **kw)
    assert f0.shape == jf0.shape == (length,) and f0.dtype == np.float32
    np.testing.assert_array_equal(uv, juv)
    same = np.isclose(f0, jf0, rtol=1e-3, atol=0)
    assert same.mean() >= 0.995, same.mean()
    assert 0.5 < (~uv).mean() < 0.98  # the test signal has voiced and unvoiced frames
    assert extractor.seconds["candidates"] > 0 and extractor.seconds["path"] > 0
    # interp_uv fills the unvoiced frames as the JAX package does
    jfi, _ = jpe.AcfPE(very_accurate=very_accurate).get_pitch(y, SR, length, interp_uv=True, **kw)
    fi, uvi = extractor.get_pitch(y, SR, length, interp_uv=True, device="cpu", **kw)
    np.testing.assert_array_equal(uvi, uv)
    assert np.isclose(fi, jfi, rtol=1e-3, atol=0).mean() >= 0.995


def test_viterbi_path_matches_a_plain_search():
    """The path finder against an exhaustive search of a small trellis."""
    import itertools

    rng = np.random.default_rng(3)
    strength = rng.normal(size=(5, 3)).astype(np.float32)
    cost = rng.uniform(0, 1, (4, 3, 3)).astype(np.float32)

    def score(p):
        return sum(strength[t, s] for t, s in enumerate(p)) - sum(
            cost[t, p[t], p[t + 1]] for t in range(4))

    best = max(itertools.product(range(3), repeat=5), key=score)
    assert tuple(pe.viterbi_path(strength, cost)) == best
    assert tuple(pe.viterbi_path(strength[:1], cost[:0])) == (int(strength[0].argmax()),)


def test_decomposed_waveform_comb(wav):
    length = 1 + len(wav) // HOP
    f0, uv = jpe.AcfPE().get_pitch(wav, SR, length, hop_size=HOP, interp_uv=True)
    f0 = f0 * ~uv
    kw = dict(hop_size=HOP, fft_size=WIN, win_size=WIN, algorithm="comb")
    jd = jdw.DecomposedWaveform(wav, SR, f0, **kw)
    td = decomposed_waveform.DecomposedWaveform(wav, SR, f0, device="cpu", **kw)
    peak = np.abs(wav).max()
    for name, got, want in [("harmonic", td.harmonic(), jd.harmonic()),
                            ("harmonic(0)", td.harmonic(0), jd.harmonic(0)),
                            ("aperiodic", td.aperiodic(), jd.aperiodic())]:
        got = got.numpy()
        assert got.shape == want.shape == wav.shape, name
        assert np.abs(got - want).max() <= 1e-4 * peak, name
    assert np.abs(td.harmonic().numpy()).max() > 0.1 * peak  # the comb kept the voice


def test_decomposed_waveform_vr_fallback_world_and_unknown(wav, tmp_path):
    """``vr`` without a checkpoint falls back to ``comb`` with the JAX
    package's warning; ``world`` splits (tests/test_torch_world.py holds it
    to the JAX package); a ``vr`` checkpoint that does not load raises at the
    split (tests/test_torch_hnsep.py holds one that loads); an unknown
    algorithm raises."""
    f0 = np.full(1 + len(wav) // HOP, 220.0, np.float32)
    with pytest.warns(UserWarning, match="falling back to 'comb'"):
        d = decomposed_waveform.DecomposedWaveform(wav, SR, f0, hop_size=HOP, win_size=WIN,
                                                   algorithm="vr", device="cpu")
    assert d.algorithm == "comb"
    d = decomposed_waveform.DecomposedWaveform(wav, SR, f0, hop_size=HOP, win_size=WIN,
                                               algorithm="world", device="cpu")
    assert d.harmonic().shape == d.aperiodic().shape == (len(wav),)
    ckpt = tmp_path / "model.ckpt"
    ckpt.write_bytes(b"")
    (tmp_path / "config.yaml").write_text("{n_fft: 256, hop_length: 64, n_out: 8, n_out_lstm: 16, "
                                          "is_mono: true}\n")
    d = decomposed_waveform.DecomposedWaveform(wav, SR, f0, hop_size=HOP, win_size=WIN,
                                               algorithm="vr", hnsep_ckpt=str(ckpt), device="cpu")
    with pytest.raises(EOFError):
        d.harmonic()
    with pytest.raises(ValueError, match="unknown hnsep"):
        decomposed_waveform.DecomposedWaveform(wav, SR, f0, hop_size=HOP, win_size=WIN,
                                               algorithm="crepe", device="cpu")


@pytest.mark.parametrize("orig,target", [(48000, 44100), (22050, 44100), (44100, 16000)])
def test_resample(orig, target):
    y = sung(4, 0.25)[: orig // 4]
    want = np.asarray(jres.resample_jax(jnp.asarray(y)[None], orig_sr=orig, target_sr=target))
    got = resample.resample(cpu(y)[None], orig, target).numpy()
    assert got.shape == want.shape == (1, -(-len(y) * target // orig))
    assert np.abs(got - want).max() <= 1e-5
    np.testing.assert_array_equal(resample.resample_poly_np(y, orig, target),
                                  jres.resample_poly_np(y, orig, target))


def test_initialize_pe(tmp_path):
    assert isinstance(pe.initialize_pe({"pe": "parselmouth"}), pe.AcfPE)
    assert pe.initialize_pe({"pe": "parselmouth", "pe_very_accurate": True}).very_accurate
    assert isinstance(pe.initialize_pe({"pe": "harvest"}), pe.HarvestPE)
    with pytest.raises(FileNotFoundError):  # rmvpe: the checkpoint must load
        pe.initialize_pe({"pe": "rmvpe", "pe_ckpt": str(tmp_path / "missing.pt")}, device="cpu")
    with pytest.raises(ValueError):
        pe.initialize_pe({"pe": "crepe"})


def test_entry_points_want_the_card_by_default(wav):
    """An array with no device named goes to the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mel.MelSpectrogram().bucketed(wav)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pe.AcfPE().get_pitch(wav, SR, 10, hop_size=HOP)

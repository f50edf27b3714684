"""The port's ``cli.vocode``, ``cli.val_nsf_hifigan`` and ``cli.drop_spk``
against the JAX package's scripts, on the CPU.

One experiment folder (``tests/torch_parity.py::make_exp``: config and a
full-NSF vocoder with seeded weights) serves both packages. The JAX vocoder
draws its noise from ``PRNGKey(0)`` at every call; the port's draws are
replaced by the same numbers (``jax_vocoder_noise``).

Tolerances: the wavs as ``tests/test_torch_infer.py`` holds them (16-bit
samples within one step plus 1e-4 of full scale); the copy-synthesis wav the
same, its mel and f0 coming from each package's own front end; the edited
speaker rows bit for bit.
"""

import importlib.util
import sys
import wave

import numpy as np
import pytest
import torch

from diffsinger_tpu_torch.cli import drop_spk, val_nsf_hifigan, vocode
from diffsinger_tpu_torch.utils.ckpt import msgpack_restore
from diffsinger_tpu_torch.vocoders.nsf_hifigan import NsfHifiGAN
from tests.torch_parity import MELS, REPO, jax_vocoder_noise, make_exp

WAV_STEPS = 1 + round(1e-4 * 32767)


def _read_wav(path):
    with wave.open(str(path), "rb") as f:
        return f.getframerate(), np.frombuffer(f.readframes(f.getnframes()), np.int16)


def _jax_script(name, monkeypatch, tmp_path):
    monkeypatch.setenv("DS_JAX_CACHE_DIR", str(tmp_path / "jax_cache"))
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    return make_exp(root, "voc", acoustic_steps=None)


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's NSF vocoder fed the JAX draws at every call."""
    real = NsfHifiGAN.spec2wav_torch

    def with_jax_noise(self, mel, f0, *, noise=None):
        return real(self, mel, f0, noise=jax_vocoder_noise(mel.shape[0], mel.shape[1]))

    monkeypatch.setattr(NsfHifiGAN, "spec2wav_torch", with_jax_noise)


def _segments(seed):
    """Two segments, the second starting 20 frames before the first ends."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (frames, offset) in enumerate(((60, 0.25), (50, 0.25 + 40 * 512 / 44100))):
        mel = rng.uniform(-9, -2, (frames, MELS)).astype(np.float32)
        f0 = rng.uniform(180, 320, frames).astype(np.float32)
        out.append((mel, f0, offset))
    return out


@pytest.mark.parametrize("kind", ["npz", "pt"])
def test_vocode_matches_the_jax_script(exp, jax_noise, monkeypatch, tmp_path, kind):
    segs = _segments(seed=3)
    mel_file = tmp_path / f"song.mel.{kind}"
    if kind == "npz":
        arrays = {"num_segments": len(segs)}
        for i, (m, f0, off) in enumerate(segs):
            arrays.update({f"mel_{i}": m, f"f0_{i}": f0, f"offset_{i}": off})
        np.savez(mel_file, **arrays)
    else:  # the reference's sequence: [1, T, M] mels, [1, T] f0
        torch.save([{"mel": torch.from_numpy(m)[None], "f0": torch.from_numpy(f0)[None],
                     "offset": off} for m, f0, off in segs], mel_file)
    monkeypatch.setenv("DS_CKPT_ROOT", str(exp))
    vocode.main([str(mel_file), "--exp", "voc", "--out", str(tmp_path / "port"), "--device", "cpu"])
    jax_vocode = _jax_script("vocode", monkeypatch, tmp_path)
    jax_vocode.main.main([str(mel_file), "--exp", "voc", "--out", str(tmp_path / "jax")],
                         standalone_mode=False)
    sr, want = _read_wav(tmp_path / "jax" / "song.wav")
    sr2, got = _read_wav(tmp_path / "port" / "song.wav")
    assert sr == sr2 == 44100 and got.shape == want.shape
    assert want.size == round(segs[1][2] * sr) + 50 * 512  # silence, then a cross-fade
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= WAV_STEPS
    assert np.abs(want).max() > 1000


def test_vocode_reads_a_config_and_titles_the_file(exp, tmp_path):
    segs = _segments(seed=4)[:1]
    mel_file = tmp_path / "one.mel.npz"
    np.savez(mel_file, num_segments=1, mel_0=segs[0][0], f0_0=segs[0][1], offset_0=0.0)
    path = vocode.main([str(mel_file), "--config", str(exp / "voc" / "config.yaml"),
                        "--title", "titled", "--device", "cpu"])
    assert path == tmp_path / "titled.wav"
    sr, wav = _read_wav(path)
    assert wav.shape == (60 * 512,)
    with pytest.raises(SystemExit):
        vocode.main([str(mel_file), "--device", "cpu"])  # neither --exp nor --config


def test_val_nsf_hifigan_matches_the_jax_script(exp, jax_noise, monkeypatch, tmp_path):
    from diffsinger_tpu_torch.utils.infer_utils import save_wav

    n = np.arange(int(0.8 * 44100))
    f0 = 220 * 2 ** (0.5 * np.sin(2 * np.pi * 3 * n / 44100) / 12)
    sig = 0.5 * np.sin(2 * np.pi * np.cumsum(f0) / 44100)
    sig = sig + 0.01 * np.random.default_rng(5).standard_normal(n.size)
    save_wav(sig, tmp_path / "take.wav", 44100)
    cfg = exp / "voc" / "config.yaml"
    val_nsf_hifigan.main([str(tmp_path / "take.wav"), "--config", str(cfg),
                          "--out", str(tmp_path / "port"), "--device", "cpu"])
    jax_val = _jax_script("val_nsf_hifigan", monkeypatch, tmp_path)
    jax_val.main.main([str(tmp_path / "take.wav"), "--config", str(cfg),
                       "--out", str(tmp_path / "jax")], standalone_mode=False)
    sr, want = _read_wav(tmp_path / "jax" / "take_copysynth.wav")
    sr2, got = _read_wav(tmp_path / "port" / "take_copysynth.wav")
    assert sr == sr2 == 44100 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= WAV_STEPS
    assert np.abs(want).max() > 1000


# ------------------------------------------------------------------ drop_spk

@pytest.mark.parametrize("mode", ["zeros", "random", "mean", "cyclic"])
def test_drop_spk_rows_equal_the_jax_scripts(mode, monkeypatch, tmp_path):
    """The same table in a port checkpoint and in a JAX one: every row equal
    after both tools; the port keeps the rest of its checkpoint."""
    from flax import serialization

    table = np.random.default_rng(6).standard_normal((5, 8)).astype(np.float32)
    other = torch.randn(3, 8)
    torch.save({"state_dict": {"model.fs2.spk_embed.weight": torch.from_numpy(table),
                               "model.fs2.other.weight": other},
                "category": "acoustic", "global_step": 7}, tmp_path / "in.ckpt")
    (tmp_path / "in.dsckpt").write_bytes(serialization.msgpack_serialize(
        {"meta": {"category": "acoustic"}, "params": {"fs2": {"spk_embed": {"embedding": table}}}}))
    spk = ["1", "3"]
    drop_spk.main([str(tmp_path / "in.ckpt"), str(tmp_path / "out" / "port.ckpt"),
                   "--spk", *spk, "--mode", mode, "--seed", "9"])
    jax_drop = _jax_script("drop_spk", monkeypatch, tmp_path)
    monkeypatch.setattr(sys, "argv", ["drop_spk.py", str(tmp_path / "in.dsckpt"),
                                      str(tmp_path / "jax.dsckpt"), "--spk", *spk,
                                      "--mode", mode, "--seed", "9"])
    jax_drop.main()
    want = msgpack_restore((tmp_path / "jax.dsckpt").read_bytes())["params"]
    want = np.asarray(want["fs2"]["spk_embed"]["embedding"])
    blob = torch.load(tmp_path / "out" / "port.ckpt", weights_only=False)
    got = blob["state_dict"]["model.fs2.spk_embed.weight"].numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(got[[1, 3]], table[[1, 3]])
    assert np.array_equal(got[[0, 2, 4]], table[[0, 2, 4]])
    assert torch.equal(blob["state_dict"]["model.fs2.other.weight"], other)
    assert blob["category"] == "acoustic" and blob["global_step"] == 7

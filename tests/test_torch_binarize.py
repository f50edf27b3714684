"""The port's binarizers against the JAX package's, on the CPU in float32: both
run on one synthetic corpus (sung phrases with glides, vibrato, gaps and
noise) with the same seed, augmentation on (random pitch shifting and time
stretching; fixed pitch shifting in a second run) and all four curves.

Every item of ``train`` and ``valid`` is compared by
``chip_smoke.binarized_item_errors``, which the card's check uses too:
tokens, ``mel2ph``, lengths, speaker ids, key shift and speed exactly; the
mel within mean |diff| <= 2e-4 and max <= 5e-3; uv exactly and f0 within
1e-3 relative on >= 99.5 % of frames; the curves (dB, semitones, tension's
logit) within 1e-4. Then the maps and ``.meta``, each package's store read by the other's
reader, two workers against none, the whole pipeline
(``cli.binarize`` then ``cli.train``) in a process that imports nothing of
the JAX package, and the other extractors (harvest, rmvpe, world) building.
"""

import json
import pickle
import random
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from chip_smoke import binarized_item_errors
from tests.test_torch_dsp import SR, sung

REPO = Path(__file__).resolve().parents[1]
SEED = 1234
AUGMENTATION = {
    "random": {
        "random_pitch_shifting": {"enabled": True, "range": [-5.0, 5.0], "scale": 0.5},
        "fixed_pitch_shifting": {"enabled": False, "targets": [-5.0, 5.0], "scale": 0.5},
        "random_time_stretching": {"enabled": True, "range": [0.8, 1.25], "scale": 0.75},
    },
    "fixed": {
        "random_pitch_shifting": {"enabled": False, "range": [-5.0, 5.0], "scale": 0.5},
        "fixed_pitch_shifting": {"enabled": True, "targets": [-3.0, 4.0], "scale": 0.4},
        "random_time_stretching": {"enabled": True, "range": [0.8, 1.25], "scale": 0.5},
    },
}


def write_wav(y: np.ndarray, path: Path) -> None:
    import wave

    data = np.clip(y * 32767, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SR)
        f.writeframes(data.tobytes())


def make_corpus(root: Path, n_items: int = 6) -> Path:
    """wavs/, transcriptions.csv (both families' columns) and a dictionary
    of two syllables: items of 1.0-1.8 s, each AP k a SP with one note."""
    raw = root / "raw"
    (raw / "wavs").mkdir(parents=True)
    (root / "dict.txt").write_text("a\ta\nka\tk a\n")
    rows = ["name,ph_seq,ph_dur,ph_num,note_seq,note_dur,note_glide"]
    for i in range(n_items):
        y = sung(10 + i, 1.0 + 0.15 * i)
        write_wav(y, raw / "wavs" / f"item{i}.wav")
        d = len(y) / SR / 4
        rows.append(f"item{i},AP k a SP,{d:.4f} {d:.4f} {d:.4f} {d:.4f},1 2 1,"
                    f"rest {['A3', 'C4', 'E4'][i % 3]} rest,{d:.4f} {2 * d:.4f} {d:.4f},"
                    f"none {['up', 'down'][i % 2]} none")
    (raw / "transcriptions.csv").write_text("\n".join(rows) + "\n")
    return raw


def hparams(family: str, root: Path, out: str, aug: str = "random", **over) -> dict:
    from diffsinger_tpu_torch.config import load_config

    hp = load_config(REPO / "configs" / f"{family}.yaml")
    hp.update(binary_data_dir=str(root / out), dictionary=str(root / "dict.txt"),
              datasets=[{"raw_data_dir": str(root / "raw"), "speaker": "synth",
                         "language": "zh", "test_prefixes": ["item0"]}],
              hnsep="vr", work_dir="")
    if family == "acoustic":
        hp.update({f"use_{v}_embed": True for v in
                   ("energy", "breathiness", "voicing", "tension", "key_shift", "speed")})
        hp.update(use_spk_id=True, num_spk=4, augmentation_args=AUGMENTATION[aug])
    else:
        hp.update({f"predict_{v}": True for v in ("energy", "breathiness", "voicing", "tension")})
        hp.update(use_glide_embed=True)
    hp["binarization_args"] = dict(hp["binarization_args"], **over)
    return hp


def run_jax(family, hp):
    if family == "acoustic":
        from diffsinger_tpu.data.acoustic_binarizer import AcousticBinarizer as cls
    else:
        from diffsinger_tpu.data.variance_binarizer import VarianceBinarizer as cls
    random.seed(SEED)
    with pytest.warns(UserWarning, match="falling back to 'comb'"):
        cls(hp).process()


def run_port(family, hp, **kw):
    from diffsinger_tpu_torch.cli.binarize import binarize

    random.seed(SEED)
    with pytest.warns(UserWarning, match="falling back to 'comb'"):
        return binarize(hp, device="cpu", **kw)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{(family, augmentation): (JAX store dir, port store dir)}."""
    root = tmp_path_factory.mktemp("binarize")
    make_corpus(root)
    out = {}
    for family, aug in (("acoustic", "random"), ("acoustic", "fixed"), ("variance", "random")):
        dirs = []
        for pkg, run in (("jax", run_jax), ("port", run_port)):
            hp = hparams(family, root, f"{family}_{aug}_{pkg}", aug)
            run(family, hp)
            dirs.append(Path(hp["binary_data_dir"]))
        out[family, aug] = tuple(dirs)
    out["root"] = root
    return out


def read_store(path: Path, prefix: str) -> list:
    with h5py.File(path / f"{prefix}.data", "r") as f:
        return [{k: v[()] for k, v in f[str(i)].items()} for i in range(len(f))]


@pytest.mark.parametrize("case", [("acoustic", "random"), ("acoustic", "fixed"),
                                  ("variance", "random")])
@pytest.mark.parametrize("prefix", ["train", "valid"])
def test_every_item_matches_the_jax_binarizer(stores, case, prefix):
    jax_dir, port_dir = stores[case]
    want, got = read_store(jax_dir, prefix), read_store(port_dir, prefix)
    assert len(got) == len(want) > 0
    if case[0] == "acoustic" and prefix == "train":
        assert len(got) > 5  # five items and their augmented copies
        shifted = [it for it in got if it["key_shift"] != 0 or it["speed"] != 1 or it["spk_id"] != 0]
        assert shifted
    for i, (g, w) in enumerate(zip(got, want)):
        _, failures = binarized_item_errors(g, w)
        assert not failures, (case, prefix, i, failures)


@pytest.mark.parametrize("family", ["acoustic", "variance"])
def test_meta_and_maps_equal(stores, family):
    jax_dir, port_dir = stores[family, "random"]
    for prefix in ("train", "valid"):
        metas = []
        for d in (jax_dir, port_dir):
            with open(d / f"{prefix}.meta", "rb") as f:
                metas.append(pickle.load(f))
        prov = metas[1].pop("provenance")
        metas[0].pop("provenance")
        assert metas[1] == metas[0]
        assert prov["framework"].startswith("diffsinger_tpu_torch ")
        assert prov["pe"] == "native-acf-viterbi(very_accurate=False)" and prov["hnsep"] == "vr"
    for name in ("spk_map.json", "lang_map.json"):
        assert json.loads((port_dir / name).read_text()) == json.loads((jax_dir / name).read_text())
    assert (port_dir / "dictionary.txt").read_text() == (jax_dir / "dictionary.txt").read_text()
    assert (port_dir / "phoneme_distribution.jpg").exists()


@pytest.mark.parametrize("family", ["acoustic", "variance"])
def test_each_package_reads_the_others_store(stores, family):
    from diffsinger_tpu.data.indexed_datasets import IndexedDataset as JaxReader
    from diffsinger_tpu_torch.data.dataset import AcousticDataset, VarianceDataset
    from diffsinger_tpu_torch.data.indexed_datasets import IndexedDataset as PortReader

    jax_dir, port_dir = stores[family, "random"]
    for reader, store in ((JaxReader, port_dir), (PortReader, jax_dir)):
        ds = reader(store, "train")
        items = read_store(store, "train")
        assert len(ds) == len(items)
        for k, v in items[-1].items():
            np.testing.assert_array_equal(ds[len(ds) - 1][k], v)
    hp = hparams(family, stores["root"], "unused")
    cls = AcousticDataset if family == "acoustic" else VarianceDataset
    ds = cls(port_dir, hp, "train")
    batch = ds.collater([ds[i] for i in range(3)])
    assert batch["size"] == 3 and batch["tokens"].shape[0] == 3


def test_two_workers_write_the_same_store(stores):
    jax_dir, port_dir = stores["acoustic", "random"]
    hp = hparams("acoustic", stores["root"], "acoustic_workers", num_workers=2)
    run_port("acoustic", hp)
    for prefix in ("train", "valid"):
        got, want = read_store(Path(hp["binary_data_dir"]), prefix), read_store(port_dir, prefix)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_stage_timer_splits_the_work(stores):
    jax_dir, port_dir = stores["variance", "random"]
    hp = hparams("variance", stores["root"], "variance_timed")
    binarizer = run_port("variance", hp)
    assert set(binarizer.timer.seconds) == {"wav", "pitch", "harmonic split", "curves", "write"}
    assert all(s > 0 for s in binarizer.timer.seconds.values())
    assert binarizer.totals["train"]["items"] == 5 and binarizer.totals["valid"]["items"] == 1
    assert binarizer.pe.seconds["path"] > 0


PIPELINE = """
import sys
from diffsinger_tpu_torch.cli import binarize, train
binarize.main(["--config", sys.argv[1], "--device", "cpu"])
train.main(["--config", sys.argv[1], "--exp_name", "exp", "--ckpt_root", sys.argv[2],
            "--max_steps", "2", "--device", "cpu"])
jax_modules = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "diffsinger_tpu"))
print("JAX-PACKAGE-MODULES", jax_modules)
"""


def test_binarize_then_train_without_the_jax_package(stores, tmp_path):
    """cli.binarize then cli.train on the port's own store, in a process that
    never imports jax or diffsinger_tpu (the import system refuses both)."""
    import yaml

    hp = hparams("acoustic", stores["root"], "pipeline")
    tiny = dict(hidden_size=32, enc_layers=2, sampling_steps=2,
                backbone_args=dict(num_channels=32, num_layers=2, kernel_size=31,
                                   dropout_rate=0.0, strong_cond=True),
                shallow_diffusion_args=dict(
                    train_aux_decoder=True, train_diffusion=True, val_gt_start=False,
                    aux_decoder_arch="convnext", aux_decoder_grad=0.1,
                    aux_decoder_args=dict(num_channels=16, num_layers=1, kernel_size=7,
                                          dropout_rate=0.1)),
                max_batch_frames=800, val_check_interval=100, num_valid_plots=0,
                val_with_vocoder=False)
    cfg = dict(tiny, base_config=[str(REPO / "configs" / "acoustic.yaml")],
               **{k: hp[k] for k in ("binary_data_dir", "dictionary", "datasets", "hnsep",
                                      "use_spk_id", "num_spk", "augmentation_args",
                                      "binarization_args")},
               **{k: True for k in hp if k.startswith("use_") and k.endswith("_embed")})
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    blocker = ("import sys\nclass _Block:\n    def find_spec(self, name, path=None, target=None):\n"
               "        if name.split('.')[0] in ('jax', 'diffsinger_tpu'):\n"
               "            raise ImportError(f'{name} is not to be imported')\n"
               "sys.meta_path.insert(0, _Block())\n"
               "[sys.modules.pop(m) for m in list(sys.modules) if m.split('.')[0] in ('jax', 'jaxlib', 'diffsinger_tpu')]\n")
    proc = subprocess.run([sys.executable, "-c", blocker + PIPELINE, str(tmp_path / "cfg.yaml"),
                           str(tmp_path / "ckpt")], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "JAX-PACKAGE-MODULES []" in proc.stdout
    assert list((tmp_path / "ckpt" / "exp").glob("model_ckpt_steps_2.ckpt"))
    assert (Path(hp["binary_data_dir"]) / "train.data").exists()


@pytest.mark.parametrize("over,error", [
    ({"pe": "harvest"}, "harvest"), ({"pe": "rmvpe"}, "rmvpe"), ({"hnsep": "world"}, "world")])
def test_other_extractors_build_with_the_jax_provenance(stores, over, error):
    """``harvest`` and ``world`` build and record the JAX package's
    provenance strings (``tests/test_torch_binarize_ext.py`` holds their
    features to the JAX package); ``rmvpe`` with the shipped config's
    ``pe_ckpt``, which is missing, raises."""
    from diffsinger_tpu_torch.cli.binarize import binarizer_class

    hp = hparams("variance", stores["root"], f"raises_{error}")
    hp.update(over)
    cls = binarizer_class(hp["binarizer_cls"])
    if error == "rmvpe":
        with pytest.raises(FileNotFoundError, match=hp["pe_ckpt"].split("/")[-1]):
            cls(hp, device="cpu")
        return
    provenance = cls(hp, device="cpu").feature_provenance()
    assert provenance["pe"] == ("native-harvest-v3" if error == "harvest"
                                else "native-acf-viterbi(very_accurate=False)")
    assert provenance["hnsep"] == ("native-world-v2(d4c-v1,host)" if error == "world" else "vr")


def test_a_worker_that_ends_without_its_result_raises():
    import os

    from diffsinger_tpu_torch.utils.multiprocess_utils import chunked_multiprocess_run

    with pytest.raises(RuntimeError, match=r"ended \(exit code 3\)"):
        list(chunked_multiprocess_run(os._exit, [(3,)], 1))


def test_world_provenance_is_the_backend_that_the_workers_run(stores, monkeypatch):
    """With worker processes, ``hnsep: world`` records the backend that the
    split resolves in them: the host goldens on the CPU, the twin when
    DS_WORLD_BACKEND=device asks for it."""
    from diffsinger_tpu_torch.cli.binarize import binarizer_class

    monkeypatch.delenv("DS_WORLD_BACKEND", raising=False)
    hp = hparams("variance", stores["root"], "world_workers", num_workers=2)
    hp.update(hnsep="world")
    cls = binarizer_class(hp["binarizer_cls"])
    assert cls(hp, device="cpu").feature_provenance()["hnsep"] == "native-world-v2(d4c-v1,host)"
    monkeypatch.setenv("DS_WORLD_BACKEND", "device")
    assert cls(hp, device="cpu").feature_provenance()["hnsep"] == "native-world-v2(d4c-v1,device)"


def test_cli_wants_the_card_unless_the_cpu_is_asked_for(stores):
    import torch

    from diffsinger_tpu_torch.cli.binarize import binarizer_class

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    hp = hparams("variance", stores["root"], "no_card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        binarizer_class(hp["binarizer_cls"])(hp)
    with pytest.raises(ValueError, match="unknown binarizer"):
        binarizer_class("preprocessing.foo.FooBinarizer")

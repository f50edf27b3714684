"""The port's HDF5 store codec (``diffsinger_tpu_torch/data/hdf5.py``) against
h5py and the JAX package's store module, on the CPU.

Stores cross both ways bit for bit (dtype, shape, bytes, key order): the JAX
``IndexedDatasetBuilder``'s files through the port's ``IndexedDataset``, the
port's files through ``h5py`` and the JAX ``IndexedDataset``; every dtype the
stores hold, over shapes that hypothesis draws; 3,000 items, where libhdf5's
own group index is a B-tree of more than one level. Layouts and types outside
the codec raise ``HDF5FormatError`` naming the dataset. Then, in a process
that cannot import h5py, jax or the JAX package, the user's pipeline on a
tiny corpus: ``cli.binarize``, the store through ``AcousticDataset``,
``cli.train`` for 2 steps and resumed to 3, ``cli.infer acoustic`` and
``cli.export acoustic``, each through its ``main(argv)``.
"""

import json
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from chip_smoke import score_samples
from diffsinger_tpu.data.indexed_datasets import IndexedDataset as JaxDataset
from diffsinger_tpu.data.indexed_datasets import IndexedDatasetBuilder as JaxBuilder
from diffsinger_tpu_torch.data import hdf5
from diffsinger_tpu_torch.data.indexed_datasets import IndexedDataset, IndexedDatasetBuilder
from tests.test_torch_binarize import hparams, make_corpus
from tests.torch_parity import REPO, TINY_VOCODER


def item(rng, i: int) -> dict:
    """An acoustic-like item of small arrays: every dtype a store holds."""
    n = 3 + i % 5
    return {"mel": rng.standard_normal((n, 4)).astype(np.float32),
            "f0": rng.uniform(100, 400, n).astype(np.float32),
            "tokens": rng.integers(0, 60, 2 + i % 3),
            "mel2ph": rng.integers(0, 3, n).astype(np.int32),
            "uv": rng.random(n) < 0.5, "spk_id": i % 3, "key_shift": 0.5 * i,
            "speed": np.float32(1.25), "midi": rng.integers(40, 80, 2).astype(np.int16),
            "bytes": rng.integers(0, 255, 3).astype(np.uint8),
            "empty": np.zeros((0, 4), np.float64)}


def assert_same(got, want, what=""):
    """Equal dtype, shape and bytes (0-d values: equal Python values of one type)."""
    if np.ndim(want) == 0 and not isinstance(want, np.ndarray):
        assert type(got) is type(want) and got == want, (what, got, want)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


def root_level(path) -> int:
    """The level of the root group's B-tree root node (0: a single node)."""
    reader = hdf5.Reader(path)
    try:
        with open(path, "rb") as f:
            f.seek(reader.root_stab[0])
            return f.read(8)[5]
    finally:
        reader.close()


def test_a_store_written_by_the_jax_package_reads_back_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    items = [item(rng, i) for i in range(12)]
    builder = JaxBuilder(tmp_path, "train")
    for it in items:
        builder.add_item(it)
    builder.finalize()
    ds, want = IndexedDataset(tmp_path, "train"), JaxDataset(tmp_path, "train")
    assert len(ds) == len(want) == len(items)
    for i in range(len(items)):
        got, ref = ds[i], want[i]
        assert list(got) == list(ref)
        for k in ref:
            assert_same(got[k], ref[k], (i, k))
    with pytest.raises(IndexError):
        ds[len(items)]
    ds.close()


def test_a_store_written_by_the_port_reads_back_through_h5py_and_jax(tmp_path):
    rng = np.random.default_rng(1)
    items = [item(rng, i) for i in range(12)]
    builder = IndexedDatasetBuilder(tmp_path, "train", allowed_attr=[*items[0], "absent"])
    for it in items:
        builder.add_item(dict(it, name="left out", pitch=None))
    builder.finalize()
    jax_ds, port_ds = JaxDataset(tmp_path, "train"), IndexedDataset(tmp_path, "train")
    with h5py.File(tmp_path / "train.data", "r") as f:
        assert len(f) == len(jax_ds) == len(port_ds) == len(items)
        for i, it in enumerate(items):
            assert list(f[str(i)]) == sorted(it)
            ref, got = jax_ds[i], port_ds[i]
            assert list(got) == list(ref)
            for k, v in it.items():
                assert_same(f[str(i)][k][()], np.asarray(v), (i, k))
                assert_same(got[k], ref[k], (i, k))


DTYPES = {
    "float32": np.float32, "float64": np.float64, "int16": np.int16, "int32": np.int32,
    "int64": np.int64, "uint8": np.uint8, "bool": np.bool_, "float16": np.float16,
    "float32 big-endian": np.dtype(">f4"), "int32 big-endian": np.dtype(">i4"),
}
SHAPES = hnp.array_shapes(min_dims=1, max_dims=3, min_side=0, max_side=6)


def arrays_of(dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        elements = st.floats(width=8 * dtype.itemsize, allow_nan=False)
    else:
        elements = None
    return hnp.arrays(dtype, SHAPES, elements=elements)


CASES = {
    **{name: arrays_of(dt) for name, dt in DTYPES.items()},
    "0-d int": st.integers(-2 ** 63, 2 ** 63 - 1).map(np.int64),
    "0-d float": st.floats(allow_nan=False).map(np.float64),
    "0-d bool": st.booleans().map(np.bool_),
    "zero-size": hnp.arrays(np.float32, hnp.array_shapes(min_dims=1, max_dims=3, min_side=0,
                                                         max_side=3).filter(lambda s: 0 in s)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_every_dtype_crosses_both_ways(case, tmp_path_factory):
    folder = tmp_path_factory.mktemp("dtype")

    @settings(max_examples=12, deadline=None,
              suppress_health_check=[HealthCheck.function_scoped_fixture])
    @given(CASES[case], CASES[case])
    def cross(a, b):
        values = {"a": a, "b": b}
        mine, theirs = folder / "port.h5", folder / "h5py.h5"
        with hdf5.Writer(mine) as w:
            w.add_group("0", values)
        with h5py.File(theirs, "w") as f:
            for k, v in values.items():
                f.create_dataset(f"0/{k}", data=v)
        with h5py.File(mine, "r") as f:
            for k, v in values.items():
                assert_same(f["0"][k][()], np.asarray(v), (case, k))
        for path in (mine, theirs):
            with hdf5.Reader(path) as r:
                got = r.read_group("0")
            assert list(got) == ["a", "b"]
            for k, v in values.items():
                assert_same(got[k], np.asarray(v), (case, path.name, k))

    cross()


def test_three_thousand_items_need_a_deeper_index_both_ways(tmp_path):
    n = 3000
    values = [{"x": np.array([i], np.int32), "y": np.float32(i / 7)} for i in range(n)]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    builder = JaxBuilder(jax_dir, "train")
    for v in values:
        builder.add_item(v)
    builder.finalize()
    builder = IndexedDatasetBuilder(port_dir, "train")
    for v in values:
        builder.add_item(v)
    builder.finalize()
    # libhdf5 and the port both index 3,000 links with a B-tree of more than one level
    assert root_level(jax_dir / "train.data") > 0 and root_level(port_dir / "train.data") > 0

    ds = IndexedDataset(jax_dir, "train")
    assert len(ds) == n
    for i in range(n):
        got = ds[i]
        assert_same(got["x"], values[i]["x"], i)
        assert got["y"] == float(values[i]["y"])
    with h5py.File(port_dir / "train.data", "r") as f:
        assert len(f) == n and sorted(f) == sorted(str(i) for i in range(n))
        assert list(f) == sorted(str(i) for i in range(n))  # libhdf5's order: "0" < "1" < "10"
        for i in (0, 1, 9, 10, 99, 100, 999, 1000, n - 1):
            assert_same(f[str(i)]["x"][()], values[i]["x"], i)
    jax_ds = JaxDataset(port_dir, "train")
    assert len(jax_ds) == n
    assert all(jax_ds[i]["y"] == float(values[i]["y"]) for i in range(0, n, 7))


@pytest.mark.parametrize("kind,match", [
    ("chunked", "'0/mel' has chunked storage"),
    ("gzip", "'0/mel' is filtered"),
    ("string", "'0/mel' has a variable-length type"),
    ("latest", "superblock version 3"),
])
def test_what_the_codec_does_not_read_raises_a_clear_error(tmp_path, kind, match):
    path = tmp_path / "train.data"
    with h5py.File(path, "w", libver="latest" if kind == "latest" else "earliest") as f:
        if kind == "string":
            f.create_dataset("0/mel", data="not an array")
        else:
            f.create_dataset("0/mel", data=np.zeros((64, 4), np.float32),
                             chunks=(8, 4) if kind == "chunked" else None,
                             compression="gzip" if kind == "gzip" else None)
    with pytest.raises(hdf5.HDF5FormatError, match=match):
        IndexedDataset(tmp_path, "train")[0]


def test_the_writer_refuses_what_it_cannot_store(tmp_path):
    with hdf5.Writer(tmp_path / "x.h5") as w:
        with pytest.raises(TypeError, match="'name'"):
            w.add_group("0", {"name": "a string"})
        w.add_group("0", {"x": np.zeros(2)})
        with pytest.raises(ValueError, match="taken"):
            w.add_group("0", {"x": np.zeros(2)})
    # a store whose writer never finished has no superblock yet
    unfinished = hdf5.Writer(tmp_path / "unfinished.h5")
    unfinished.add_group("0", {"x": np.zeros(2)})
    unfinished.file.flush()
    with pytest.raises(hdf5.HDF5FormatError, match="not an HDF5 file"):
        hdf5.Reader(tmp_path / "unfinished.h5")
    unfinished.close()
    with hdf5.Reader(tmp_path / "unfinished.h5") as r:
        assert r.keys() == ["0"]


# ------------------------------------------------------------ the pipeline

PIPELINE = """
import sys
sys.modules["h5py"] = None  # import h5py raises ImportError
from pathlib import Path
cfg, root, score, out = sys.argv[1:5]
from diffsinger_tpu_torch.cli import binarize, export, infer, train
from diffsinger_tpu_torch.config import load_config
from diffsinger_tpu_torch.data.dataset import AcousticDataset

binarize.main(["--config", cfg, "--device", "cpu"])
hp = load_config(cfg)
ds = AcousticDataset(hp["binary_data_dir"], hp, "train")
batch = ds.collater([ds[i] for i in range(len(ds))])
print("DATASET", len(ds), batch["size"], sorted(batch))
args = ["--config", cfg, "--exp_name", "exp", "--ckpt_root", root, "--device", "cpu"]
print("STEP", train.main(args + ["--max_steps", "2"]).global_step)
print("STEP", train.main(args + ["--max_steps", "3"]).global_step)
infer.main(["acoustic", score, "--exp", "exp", "--device", "cpu", "--seed", "1", "--out", out])
export.main(["acoustic", "--exp", "exp", "--device", "cpu", "--buckets", "16x128",
             "--out", out + "/bundle"])
blocked = sorted(m for m in sys.modules if m.split(".")[0] in ("h5py", "jax", "diffsinger_tpu")
                 and sys.modules[m] is not None)
print("BLOCKED-MODULES", blocked)
"""
BLOCK_JAX = ("import sys\nclass _Block:\n    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('jax', 'diffsinger_tpu'):\n"
             "            raise ImportError(f'{name} is not to be imported')\n"
             "sys.meta_path.insert(0, _Block())\n"
             "[sys.modules.pop(m) for m in list(sys.modules) "
             "if m.split('.')[0] in ('jax', 'jaxlib', 'diffsinger_tpu', 'h5py')]\n")


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """cli.binarize -> AcousticDataset -> cli.train 2 steps -> resumed to 3 ->
    cli.infer acoustic -> cli.export acoustic in one process without h5py,
    jax or the JAX package; narrow widths, two sampler steps."""
    import os

    from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import Generator, NsfHifiGanConfig

    root = tmp_path_factory.mktemp("pipeline")
    make_corpus(root, n_items=4)
    hp = hparams("acoustic", root, "binary")
    voc = dict(TINY_VOCODER, num_mels=hp["audio_num_mel_bins"])
    (root / "vocoder").mkdir()
    (root / "vocoder" / "config.json").write_text(json.dumps(voc))
    torch.manual_seed(3)
    torch.save({"generator": Generator(NsfHifiGanConfig.from_json(voc), device="cpu")
                .state_dict()}, root / "vocoder" / "model.ckpt")
    cfg = dict(
        base_config=[str(REPO / "configs" / "acoustic.yaml")],
        **{k: hp[k] for k in ("binary_data_dir", "dictionary", "datasets", "hnsep")},
        vocoder_ckpt=str(root / "vocoder" / "model.ckpt"),
        hidden_size=32, enc_layers=2, sampling_steps=2, max_batch_frames=800,
        backbone_args=dict(num_channels=32, num_layers=2, kernel_size=31, dropout_rate=0.0,
                           strong_cond=True),
        shallow_diffusion_args=dict(aux_decoder_args=dict(num_channels=16, num_layers=1,
                                                          kernel_size=7, dropout_rate=0.1)),
        val_check_interval=100, num_valid_plots=0, val_with_vocoder=False)
    (root / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    d = 0.1
    score = [{"offset": o, "ph_seq": "AP k a SP", "ph_dur": f"{d} {d} {3 * d} {d}",
              "f0_seq": " ".join(["220.0"] * 61), "f0_timestep": 0.01} for o in (0.0, 0.75)]
    (root / "score.ds").write_text(json.dumps(score))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCK_JAX + PIPELINE, str(root / "cfg.yaml"), str(root / "ckpt"),
         str(root / "score.ds"), str(root / "out")], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, DS_CKPT_ROOT=str(root / "ckpt")))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return root, proc.stdout, score, hp


def test_binarize_and_the_dataset_run_without_h5py(pipeline):
    root, stdout, _, hp = pipeline
    line = next(ln for ln in stdout.splitlines() if ln.startswith("DATASET"))
    n, size = (int(v) for v in line.split()[1:3])
    assert n == size == 3  # four items, one of them the valid split
    with h5py.File(root / "binary" / "train.data", "r") as f:  # h5py reads what it wrote
        assert len(f) == n and f["0"]["mel"].shape[1] == hp["audio_num_mel_bins"]
    assert "BLOCKED-MODULES []" in stdout


def test_train_resume_infer_and_export_run_without_h5py(pipeline):
    root, stdout, score, hp = pipeline
    assert [ln for ln in stdout.splitlines() if ln.startswith("STEP")] == ["STEP 2", "STEP 3"]
    assert "resumed from" in stdout and "model_ckpt_steps_2.ckpt" in stdout
    assert (root / "ckpt" / "exp" / "model_ckpt_steps_3.ckpt").is_file()
    import wave

    with wave.open(str(root / "out" / "score.wav")) as f:
        assert f.getframerate() == hp["audio_sample_rate"]
        assert abs(f.getnframes() - score_samples(score, hp["audio_sample_rate"],
                                                  hp["hop_size"])) <= hp["hop_size"]
    manifest = yaml.safe_load((root / "out" / "bundle" / "dsconfig.yaml").read_text())
    assert manifest["device"] == "cpu" and manifest["flavor"] == "pt2"
    assert list((root / "out" / "bundle").glob("exp*.pt2"))

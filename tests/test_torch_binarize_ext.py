"""The port's binarizers with the extractors that voicebank makers configure
(``pe: rmvpe`` with ``hnsep: vr`` and a checkpoint; ``pe: harvest`` with
``hnsep: world``) against the JAX package's, on the CPU in float32.

Three sung items of 1.2 s (one length, so that the JAX side compiles each
program once) go through both packages' binarizers: acoustic and variance
with RMVPE (the full-width network at seeded weights) and the vocal remover
(a narrow CascadedNet at n_fft 2048, hop 512), variance with Harvest and
WORLD (the float64 host goldens on both sides: on the CPU ``auto`` is the
host). Every item of ``train`` and ``valid`` is compared by
``chip_smoke.binarized_item_errors`` at its default tolerances (exact
attributes equal; mel, f0, pitch and the curves as ``test_torch_binarize``
holds them), the provenance strings equal the JAX package's. Then
``cli.binarize`` runs both configurations in a process that cannot import
JAX (WORLD there on the port's twin, ``DS_WORLD_BACKEND=device``).
"""

import pickle
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import binarized_item_errors
from diffsinger_tpu_torch.dsp.harvest import ALGO_VERSION
from tests.test_torch_binarize import REPO, SEED, hparams, read_store, write_wav
from tests.test_torch_dsp import SR, sung

N_ITEMS = 3


def make_corpus(root: Path) -> None:
    raw = root / "raw"
    (raw / "wavs").mkdir(parents=True)
    (root / "dict.txt").write_text("a\ta\nka\tk a\n")
    rows = ["name,ph_seq,ph_dur,ph_num,note_seq,note_dur,note_glide"]
    for i in range(N_ITEMS):
        y = sung(20 + i, 1.2)
        write_wav(y, raw / "wavs" / f"item{i}.wav")
        d = len(y) / SR / 4
        rows.append(f"item{i},AP k a SP,{d:.4f} {d:.4f} {d:.4f} {d:.4f},1 2 1,"
                    f"rest {['A3', 'C4', 'E4'][i % 3]} rest,{d:.4f} {2 * d:.4f} {d:.4f},"
                    f"none {['up', 'down'][i % 2]} none")
    (raw / "transcriptions.csv").write_text("\n".join(rows) + "\n")


def write_checkpoints(folder: Path) -> None:
    """Seeded RMVPE (full width) and CascadedNet (narrow) checkpoints in the
    reference's formats, BatchNorm statistics moved off their defaults."""
    from diffsinger_tpu_torch.models.hnsep import CascadedNet
    from diffsinger_tpu_torch.models.rmvpe import E2E0

    torch.manual_seed(5)
    nets = {"rmvpe": E2E0(4, 1, (2, 2)), "vr": CascadedNet(2048, 512, nout=8, nout_lstm=16)}
    with torch.no_grad():
        for net in nets.values():
            for m in net.modules():
                if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                    m.running_mean.normal_(0, 0.3)
                    m.running_var.uniform_(0.5, 2.0)
    (folder / "rmvpe").mkdir()
    (folder / "vr").mkdir()
    torch.save({"model": nets["rmvpe"].state_dict()}, folder / "rmvpe" / "model.pt")
    torch.save(nets["vr"].state_dict(), folder / "vr" / "model.pt")
    (folder / "vr" / "config.yaml").write_text(yaml.safe_dump(
        {"n_fft": 2048, "hop_length": 512, "n_out": 8, "n_out_lstm": 16, "is_mono": False}))


CASES = {  # (family, pe, hnsep)
    "acoustic-rmvpe-vr": ("acoustic", "rmvpe", "vr"),
    "variance-rmvpe-vr": ("variance", "rmvpe", "vr"),
    "variance-harvest-world": ("variance", "harvest", "world"),
}


def case_hparams(root: Path, case: str, out: str) -> dict:
    family, pe, hnsep = CASES[case]
    hp = hparams(family, root, out)
    hp.update(pe=pe, hnsep=hnsep, pe_ckpt=str(root / "rmvpe" / "model.pt"),
              hnsep_ckpt=str(root / "vr" / "model.pt"))
    hp["augmentation_args"] = {k: dict(v, enabled=False)
                               for k, v in hp.get("augmentation_args", {}).items()}
    return hp


@pytest.fixture(scope="module")
def stores(tmp_path_factory, monkeypatch_module):
    from diffsinger_tpu.data.acoustic_binarizer import AcousticBinarizer
    from diffsinger_tpu.data.variance_binarizer import VarianceBinarizer
    from diffsinger_tpu_torch.cli.binarize import binarize

    monkeypatch_module.delenv("DS_WORLD_BACKEND", raising=False)
    root = tmp_path_factory.mktemp("binarize_ext")
    make_corpus(root)
    write_checkpoints(root)
    out = {}
    for case, (family, _, _) in CASES.items():
        dirs = []
        for pkg in ("jax", "port"):
            hp = case_hparams(root, case, f"{case}_{pkg}")
            random.seed(SEED)
            if pkg == "jax":
                (AcousticBinarizer if family == "acoustic" else VarianceBinarizer)(hp).process()
            else:
                binarize(hp, device="cpu")
            dirs.append(Path(hp["binary_data_dir"]))
        out[case] = tuple(dirs)
    out["root"] = root
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("prefix", ["train", "valid"])
def test_every_item_matches_the_jax_binarizer(stores, case, prefix):
    jax_dir, port_dir = stores[case]
    want, got = read_store(jax_dir, prefix), read_store(port_dir, prefix)
    assert len(got) == len(want) == (N_ITEMS - 1 if prefix == "train" else 1)
    for i, (g, w) in enumerate(zip(got, want)):
        _, failures = binarized_item_errors(g, w)
        assert not failures, (case, prefix, i, failures)


@pytest.mark.parametrize("case", list(CASES))
def test_provenance_is_the_jax_packages(stores, case):
    metas = []
    for d in stores[case]:
        with open(d / "train.meta", "rb") as f:
            metas.append(pickle.load(f)["provenance"])
    want, got = metas
    assert got.pop("framework").startswith("diffsinger_tpu_torch ")
    want.pop("framework")
    assert got == want
    harvest = f"native-harvest-v{ALGO_VERSION}"
    assert got["pe"] == {"rmvpe": "rmvpe(model.pt)", "harvest": harvest}[CASES[case][1]]
    assert got["hnsep"] == {"vr": "vr", "world": "native-world-v2(d4c-v1,host)"}[CASES[case][2]]


PIPELINE = """
import os, sys
from diffsinger_tpu_torch.cli import binarize
os.environ["DS_WORLD_BACKEND"] = "device"
for cfg in sys.argv[1:]:
    binarize.main(["--config", cfg, "--device", "cpu"])
jax_modules = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "diffsinger_tpu"))
print("JAX-PACKAGE-MODULES", jax_modules)
"""


def test_cli_binarize_without_the_jax_package(stores):
    """Both configurations through ``cli.binarize`` in a process that never
    imports jax or diffsinger_tpu (the import system refuses both); the
    stores hold every item, the WORLD one records the twin."""
    root = stores["root"]
    configs = []
    for case in ("acoustic-rmvpe-vr", "variance-harvest-world"):
        hp = case_hparams(root, case, f"cli_{case}")
        base = REPO / "configs" / f"{CASES[case][0]}.yaml"
        cfg = {k: v for k, v in hp.items() if k in (
            "binary_data_dir", "dictionary", "datasets", "pe", "pe_ckpt", "hnsep", "hnsep_ckpt",
            "augmentation_args", "binarization_args", "use_spk_id", "num_spk")
               or k.startswith(("use_", "predict_"))}
        cfg["base_config"] = [str(base)]
        path = root / f"cli_{case}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        configs.append((path, Path(hp["binary_data_dir"])))
    blocker = ("import sys\nclass _Block:\n    def find_spec(self, name, path=None, target=None):\n"
               "        if name.split('.')[0] in ('jax', 'diffsinger_tpu'):\n"
               "            raise ImportError(f'{name} is not to be imported')\n"
               "sys.meta_path.insert(0, _Block())\n"
               "[sys.modules.pop(m) for m in list(sys.modules) if m.split('.')[0] in "
               "('jax', 'jaxlib', 'diffsinger_tpu')]\n")
    proc = subprocess.run([sys.executable, "-c", blocker + PIPELINE, *(str(c) for c, _ in configs)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "JAX-PACKAGE-MODULES []" in proc.stdout
    for (_, out), case in zip(configs, ("acoustic-rmvpe-vr", "variance-harvest-world")):
        items = read_store(out, "train")
        assert len(items) == N_ITEMS - 1
        assert all(np.isfinite(it["breathiness"]).all() for it in items)
        with open(out / "train.meta", "rb") as f:
            prov = pickle.load(f)["provenance"]
        assert prov["hnsep"] == ("vr" if case.endswith("vr") else "native-world-v2(d4c-v1,device)")

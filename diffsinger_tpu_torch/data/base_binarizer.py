"""Binarization (counterpart of diffsinger_tpu/data/base_binarizer.py): the
speaker and language maps, the train/valid split by ``test_prefixes`` (four
matching passes), the shuffle, the phoneme coverage check with its
distribution figure, each item's features (in worker processes when
``num_workers`` > 0), the augmentation schedule, the item store and the
pickled ``.meta``.

The features are computed on ``device``, the card unless the caller names
another. The shuffle and the augmentation draws use Python's global
``random`` in the JAX package's order, so ``random.seed(n)`` before a run
gives both packages the same store.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import pickle
import random
import shutil
import time
import warnings
from collections import defaultdict
from copy import deepcopy

import numpy as np
import torch

from diffsinger_tpu_torch.data.indexed_datasets import IndexedDatasetBuilder
from diffsinger_tpu_torch.dsp.common import as_signal, sinusoidal_smooth
from diffsinger_tpu_torch.utils import resolve_device
from diffsinger_tpu_torch.utils.infer_utils import load_wav
from diffsinger_tpu_torch.utils.multiprocess_utils import chunked_multiprocess_run
from diffsinger_tpu_torch.utils.text import load_phoneme_dictionary

__version__ = "0.1.0"  # of the port's features, recorded in each .meta


class BinarizationError(Exception):
    pass


def dur_sec_to_frames(dur_sec: np.ndarray, timestep: float) -> np.ndarray:
    """Durations in seconds -> frames, rounded on the running sum (the reference's rounding)."""
    acc = np.round(np.cumsum(dur_sec) / timestep + 0.5).astype(np.int64)
    return np.diff(acc, prepend=0)


def expand_to_length(dur: np.ndarray, length: int) -> np.ndarray:
    """Frame durations -> the 1-based index of each frame, padded with the
    last index or cut to ``length``."""
    m = np.repeat(np.arange(1, len(dur) + 1), dur).astype(np.int64)
    if len(m) < length:
        m = np.pad(m, (0, length - len(m)), constant_values=m[-1] if len(m) else 0)
    return m[:length]


def dur_sec_to_mel2ph(ph_dur_sec: np.ndarray, length: int, timestep: float) -> np.ndarray:
    """Phoneme durations in seconds -> the phoneme index of each of ``length`` frames."""
    return expand_to_length(dur_sec_to_frames(ph_dur_sec, timestep), length)


class StageTimer:
    """Seconds spent in each named stage, summed over calls. Stages nest; an
    outer stage does not count the time of an inner one. On the card every
    boundary synchronises, so a stage's kernels count in it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds = defaultdict(float)
        self._stack = []
        self._last = 0.0

    def _mark(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._stack:
            self.seconds[self._stack[-1]] += now - self._last
        self._last = now

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._mark()
        self._stack.append(name)
        try:
            yield
        finally:
            self._mark()
            self._stack.pop()


class BaseBinarizer:
    def __init__(self, hparams: dict, datasets=None, data_attrs=None, device=None):
        self.hparams = hparams
        self.device = resolve_device(device)
        self.timer = StageTimer(self.device)
        self.datasets = datasets if datasets is not None else hparams["datasets"]
        self.raw_data_dirs = [pathlib.Path(ds["raw_data_dir"]) for ds in self.datasets]
        self.binary_data_dir = pathlib.Path(hparams["binary_data_dir"])
        self.data_attrs = data_attrs or []
        self.binarization_args = hparams["binarization_args"]
        self.augmentation_args = hparams.get("augmentation_args", {})

        self.spk_map = {}
        self.spk_ids = None
        self.build_spk_map()
        self.lang_map = {}
        self.dictionaries = hparams.get("dictionaries") or {}
        self.build_lang_map()

        self.items = {}
        self.item_names = None
        self._train_item_names = None
        self._valid_item_names = None
        self.totals = {}  # prefix -> items and seconds of audio written

        self.phoneme_dictionary = load_phoneme_dictionary(hparams)
        self.timestep = hparams["hop_size"] / hparams["audio_sample_rate"]

    # ------------------------------------------------------------------
    def build_spk_map(self):
        """Speaker ids, honouring explicit ``spk_id`` keys."""
        spk_ids = [ds.get("spk_id") for ds in self.datasets]
        assigned = {i for i in spk_ids if i is not None}
        idx = 0
        for i in range(len(spk_ids)):
            if spk_ids[i] is not None:
                continue
            while idx in assigned:
                idx += 1
            spk_ids[i] = idx
            assigned.add(idx)
        assert max(spk_ids) < self.hparams["num_spk"], (
            f"Index in spk_id sequence {spk_ids} is out of range. "
            f"All values should be smaller than num_spk."
        )
        for spk_id, dataset in zip(spk_ids, self.datasets):
            name = dataset["speaker"]
            if name in self.spk_map and self.spk_map[name] != spk_id:
                raise ValueError(
                    f"Invalid speaker ID assignment. Name '{name}' is assigned "
                    f"with different speaker IDs: {self.spk_map[name]} and {spk_id}."
                )
            self.spk_map[name] = spk_id
        self.spk_ids = spk_ids
        print("| spk_map: ", self.spk_map)

    def build_lang_map(self):
        dictionaries = self.hparams.get("dictionaries") or {}
        if not dictionaries:
            return
        assert len(dictionaries) <= self.hparams["num_lang"], (
            "Number of languages must not be greater than num_lang!"
        )
        for dataset in self.datasets:
            assert dataset["language"] in dictionaries, (
                f"Unrecognized language name: {dataset['language']}"
            )
        for lang_id, lang_name in enumerate(sorted(dictionaries.keys()), start=1):
            self.lang_map[lang_name] = lang_id
        print("| lang_map: ", self.lang_map)

    # ------------------------------------------------------------------
    def load_meta_data(self, raw_data_dir: pathlib.Path, ds_id, spk, lang) -> dict:
        raise NotImplementedError()

    def split_train_valid_set(self, prefixes: list):
        """Validation names by prefix, in four passes: the whole name, the name
        without its dataset id, a prefix of the whole name, a prefix of the
        name without its id."""
        prefixes = {str(p): 1 for p in prefixes}
        valid = {}
        for prefix in deepcopy(prefixes):
            if prefix in self.item_names:
                valid[prefix] = 1
                prefixes.pop(prefix)
        for match in (lambda name, p: name.split(":")[-1] == p,
                      lambda name, p: name.startswith(p),
                      lambda name, p: name.split(":")[-1].startswith(p)):
            for prefix in deepcopy(prefixes):
                matched = False
                for name in self.item_names:
                    if match(name, prefix):
                        valid[name] = 1
                        matched = True
                if matched:
                    prefixes.pop(prefix)
        if prefixes:
            warnings.warn(
                f"The following rules in test_prefixes have no matching names in "
                f"the dataset: {', '.join(prefixes.keys())}",
                category=UserWarning,
            )
        valid_names = list(valid.keys())
        assert valid_names, "Validation set is empty!"
        train_names = [x for x in self.item_names if x not in set(valid_names)]
        assert train_names, "Training set is empty!"
        return train_names, valid_names

    @property
    def train_item_names(self):
        return self._train_item_names

    @property
    def valid_item_names(self):
        return self._valid_item_names

    def meta_data_iterator(self, prefix):
        names = self.train_item_names if prefix == "train" else self.valid_item_names
        for name in names:
            yield name, self.items[name]

    # ------------------------------------------------------------------
    def process(self):
        """Binarize every dataset into ``binary_data_dir``."""
        test_prefixes = []
        for ds_id, dataset in enumerate(self.datasets):
            items = self.load_meta_data(
                pathlib.Path(dataset["raw_data_dir"]),
                ds_id=ds_id, spk=dataset["speaker"], lang=dataset.get("language"),
            )
            self.items.update(items)
            test_prefixes.extend(f"{ds_id}:{p}" for p in dataset.get("test_prefixes", []))
        self.item_names = sorted(self.items.keys())
        self._train_item_names, self._valid_item_names = self.split_train_valid_set(test_prefixes)

        if self.binarization_args["shuffle"]:
            random.shuffle(self.item_names)

        self.binary_data_dir.mkdir(parents=True, exist_ok=True)
        with open(self.binary_data_dir / "spk_map.json", "w", encoding="utf-8") as f:
            json.dump(self.spk_map, f, ensure_ascii=False)
        with open(self.binary_data_dir / "lang_map.json", "w", encoding="utf-8") as f:
            json.dump(self.lang_map, f, ensure_ascii=False)
        for lang, dict_path in (self.hparams.get("dictionaries") or {}).items():
            shutil.copy(dict_path, self.binary_data_dir / f"dictionary-{lang}.txt")
        if self.hparams.get("dictionary"):
            shutil.copy(self.hparams["dictionary"], self.binary_data_dir / "dictionary.txt")
        self.check_coverage()

        try:
            self.process_dataset("valid")
            self.process_dataset(
                "train",
                num_workers=int(self.binarization_args["num_workers"]),
                apply_augmentation=any(
                    args.get("enabled") for args in self.augmentation_args.values()
                ),
            )
        except KeyboardInterrupt:
            raise SystemExit(-1)

    def save_distribution(self, filename: str, **figure_args):
        """Draw ``utils.plot.distribution_to_figure(**figure_args)`` into
        ``binary_data_dir/filename``; without matplotlib the figure is left out."""
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            print(f"| matplotlib is not installed: '{filename}' is left out")
            return
        from diffsinger_tpu_torch.utils.plot import distribution_to_figure

        plt = distribution_to_figure(**figure_args)
        path = self.binary_data_dir / filename
        plt.savefig(fname=path, bbox_inches="tight", pad_inches=0.25)
        plt.close()
        print(f"| save summary to '{path}'")

    def check_coverage(self):
        """Phoneme distribution summary; every phoneme of the dictionary must occur."""
        required = set(range(1, len(self.phoneme_dictionary)))
        occurred = set()
        count_map = {idx: 0 for idx in required}
        for item in self.items.values():
            occurred.update(item["ph_seq"])
            for idx in item["ph_seq"]:
                count_map[idx] += 1
        ph_count = {
            self.phoneme_dictionary.decode_one(idx, scalar=False): c
            for idx, c in count_map.items()
        }

        def disp(p):
            return f"({', '.join(p)})" if isinstance(p, tuple) else p

        print("===== Phoneme Distribution Summary =====")
        keys = sorted(ph_count.keys(), key=lambda v: v[0] if isinstance(v, tuple) else v)
        print(", ".join(f"{disp(k)}: {ph_count[k]}" for k in keys))
        self.save_distribution(
            "phoneme_distribution.jpg", title="Phoneme Distribution Summary",
            x_label="Phoneme", y_label="Number of occurrences",
            items=[disp(k) for k in keys], values=[ph_count[k] for k in keys],
            rotate=len(self.dictionaries) > 1,
        )

        if occurred != required:
            missing = sorted(
                {self.phoneme_dictionary.decode_one(i, scalar=False) for i in required - occurred},
                key=lambda v: v[0] if isinstance(v, tuple) else v,
            )
            raise BinarizationError(
                f"The following phonemes are not covered in transcriptions: {missing}"
            )

    def process_dataset(self, prefix, num_workers=0, apply_augmentation=False):
        """Each item of the split (and its augmented copies) into the store,
        numbered in order, then ``{prefix}.meta``."""
        args = [
            [name, meta, self.binarization_args]
            for name, meta in self.meta_data_iterator(prefix)
        ]
        store = IndexedDatasetBuilder(self.binary_data_dir, prefix=prefix,
                                      allowed_attr=self.data_attrs)
        total_sec = {k: 0.0 for k in self.spk_map}
        total_raw_sec = {k: 0.0 for k in self.spk_map}
        extra_info = {"names": {}, "ph_texts": {}, "spk_ids": {}, "spk_names": {}, "lengths": {}}
        max_no = -1
        aug_map = (
            self.arrange_data_augmentation(self.meta_data_iterator(prefix))
            if apply_augmentation else {}
        )

        def record(item, item_no):
            nonlocal max_no
            max_no = max(max_no, item_no)
            for k, v in item.items():
                if isinstance(v, np.ndarray):
                    extra_info.setdefault(k, {})[item_no] = v.shape[0]
            extra_info["names"][item_no] = item["name"].split(":", 1)[-1]
            extra_info["ph_texts"][item_no] = item["ph_text"]
            extra_info["spk_ids"][item_no] = item["spk_id"]
            extra_info["spk_names"][item_no] = item["spk_name"]
            extra_info["lengths"][item_no] = item["length"]

        def add(item):
            with self.timer("write"):
                item_no = store.add_item(item)
            record(item, item_no)

        def postprocess(item):
            if item is None:
                return
            add(item)
            total_raw_sec[item["spk_name"]] += item["seconds"]
            total_sec[item["spk_name"]] += item["seconds"]
            for task in aug_map.get(item["name"], []):
                aug_item = task["func"](item, **task["kwargs"])
                add(aug_item)
                total_sec[aug_item["spk_name"]] += aug_item["seconds"]

        try:
            if num_workers > 0:
                for item in chunked_multiprocess_run(self.process_item, args, num_workers,
                                                     device=self.device):
                    postprocess(item)
            else:
                for a in args:
                    postprocess(self.process_item(*a))
            for k in extra_info:
                assert set(extra_info[k]) == set(range(max_no + 1)), (
                    "Item numbering is not consecutive."
                )
                extra_info[k] = [v for _, v in sorted(extra_info[k].items())]
        finally:
            with self.timer("write"):
                store.finalize()
        if prefix == "train":
            extra_info.pop("names")
            extra_info.pop("ph_texts")
            extra_info.pop("spk_names")
        extra_info["provenance"] = self.feature_provenance()
        with open(self.binary_data_dir / f"{prefix}.meta", "wb") as f:
            pickle.dump(extra_info, f)
        total = sum(total_raw_sec.values())
        aug_total = sum(total_sec.values())
        self.totals[prefix] = {"items": max_no + 1, "raw_seconds": total, "seconds": aug_total}
        print(f"| {prefix} total duration: {total:.2f}s")
        if apply_augmentation:
            print(f"| {prefix} total duration (after augmentation): "
                  f"{aug_total:.2f}s ({aug_total / max(total, 1e-9):.2f}x)")

    def feature_provenance(self) -> dict:
        """The binarizer and package that made the features, recorded in the ``.meta``."""
        return {
            "binarizer": type(self).__name__,
            "framework": f"diffsinger_tpu_torch {__version__}",
        }

    def hnsep_provenance(self) -> str:
        """The harmonic split's name as the JAX package records it: for
        ``world`` its versions and the backend that runs, resolved as the
        split resolves it in this process and in the workers
        (``dsp.world.resolve_world_backend``)."""
        algo = self.hparams.get("hnsep", "comb")
        if algo != "world":
            return algo
        from diffsinger_tpu_torch.dsp.d4c import ALGO_VERSION as D4C_VERSION
        from diffsinger_tpu_torch.dsp.world import ALGO_VERSION, resolve_world_backend

        return f"native-world-v{ALGO_VERSION}(d4c-v{D4C_VERSION},{resolve_world_backend(self.device)})"

    # ------------------------------------------------------------------
    def load_waveform(self, wav_fn) -> torch.Tensor:
        """The item's waveform at the config's rate, on the binarizer's device."""
        with self.timer("wav"):
            waveform, _ = load_wav(wav_fn, target_sr=self.hparams["audio_sample_rate"])
            return as_signal(waveform, self.device)

    def smooth(self, curve: np.ndarray, width_key: str) -> np.ndarray:
        """The half-sine smoothing of a curve over ``hparams[width_key]`` seconds."""
        k = max(1, round(self.hparams[width_key] / self.timestep))
        return sinusoidal_smooth(as_signal(curve, self.device)[None], k)[0].cpu().numpy()

    def split(self, part):
        """``part()`` of a ``DecomposedWaveform``, timed as the harmonic split."""
        with self.timer("harmonic split"):
            return part()

    def arrange_data_augmentation(self, data_iterator):
        raise NotImplementedError()

    def process_item(self, item_name, meta_data, binarization_args):
        raise NotImplementedError()

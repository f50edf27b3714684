"""SVS inference base: timing constants, speaker-mix parsing, bucketing
(counterpart of diffsinger_tpu/inference/base_svs_infer.py).

All of it is host-side numpy, the same arithmetic as the JAX package's, so a
score preprocesses into bit-equal arrays in both.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Tuple

import numpy as np

from diffsinger_tpu_torch.utils.infer_utils import resample_align_curve


def bucket_length(n: int, *, step: int = 128, minimum: int = 128) -> int:
    """Round ``n`` up to a bucket boundary (multiples of ``step``)."""
    return max(minimum, ((n + step - 1) // step) * step)


class BaseSVSInfer:
    def __init__(self, hparams: dict):
        self.hparams = hparams
        self.timestep = hparams["hop_size"] / hparams["audio_sample_rate"]
        self.spk_map: Dict[str, int] = {}
        self.lang_map: Dict[str, int] = {}

    def load_maps(self):
        work_dir = pathlib.Path(self.hparams["work_dir"])
        if self.hparams.get("use_spk_id", False):
            with open(work_dir / "spk_map.json", "r", encoding="utf8") as f:
                self.spk_map = json.load(f)
            assert isinstance(self.spk_map, dict) and len(self.spk_map) > 0, (
                "Invalid or empty speaker map!"
            )
            assert len(self.spk_map) == len(set(self.spk_map.values())), (
                "Duplicate speaker id in speaker map!"
            )
        lang_map_fn = work_dir / "lang_map.json"
        if lang_map_fn.exists():
            with open(lang_map_fn, "r", encoding="utf8") as f:
                self.lang_map = json.load(f)

    def load_speaker_mix(
        self, param_src: dict, summary_dst: dict, mix_mode: str = "frame",
        mix_length: int = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Parse static/dynamic speaker mixes.

        :return: (spk_mix_id [1, 1, N] int32, spk_mix_value [1, T|1, N] float32)
        """
        assert mix_mode in ("token", "frame")
        param_key = "spk_mix" if mix_mode == "frame" else "ph_spk_mix"
        summary_solo_key = "spk" if mix_mode == "frame" else "ph_spk"
        spk_mix_map = param_src.get(param_key)
        dynamic = False
        if spk_mix_map is None:
            assert len(self.spk_map) == 1, (
                "This is a multi-speaker model. "
                "Please specify a speaker or speaker mix by --spk option."
            )
            spk_mix_map = {next(iter(self.spk_map)): 1.0}
        else:
            for name in spk_mix_map:
                assert name in self.spk_map, f"Speaker '{name}' not found."
        if len(spk_mix_map) == 1:
            summary_dst[summary_solo_key] = next(iter(spk_mix_map))
        elif any(isinstance(v, str) for v in spk_mix_map.values()):
            summary_dst[param_key] = f"dynamic({'|'.join(spk_mix_map)})"
            dynamic = True
        else:
            mix_str = "|".join(f"{n}:{spk_mix_map[n]:.3f}" for n in spk_mix_map)
            summary_dst[param_key] = f"static({mix_str})"

        ids, values = [], []
        if dynamic:
            for name, val in spk_mix_map.items():
                ids.append(self.spk_map[name])
                if isinstance(val, str):
                    if mix_mode == "token":
                        cur = np.array(val.split(), np.float32)
                        assert len(cur) == mix_length, (
                            "Speaker mix checks failed. In dynamic token-level mix, "
                            "number of proportion values must equal number of tokens."
                        )
                    else:
                        cur = resample_align_curve(
                            np.array(val.split(), np.float32),
                            original_timestep=float(param_src["spk_mix_timestep"]),
                            target_timestep=self.timestep,
                            align_length=mix_length,
                        )
                    assert np.all(cur >= 0.0), (
                        f"Speaker mix checks failed.\n"
                        f"Proportions of speaker '{name}' on some {mix_mode}s are negative."
                    )
                else:
                    assert val >= 0.0, (
                        f"Speaker mix checks failed.\nProportion of speaker '{name}' is negative."
                    )
                    cur = np.full(mix_length, val, np.float32)
                values.append(cur)
            spk_mix_id = np.asarray(ids, np.int32)[None, None]  # [1, 1, N]
            spk_mix_value = np.stack(values, axis=1)[None]  # [1, T, N]
            total = spk_mix_value.sum(axis=2, keepdims=True)
            assert np.all(total > 0.0), (
                "Speaker mix checks failed.\nProportions of speaker mix on some frames sum to zero."
            )
            spk_mix_value = spk_mix_value / total
        else:
            for name, val in spk_mix_map.items():
                ids.append(self.spk_map[name])
                assert val >= 0.0, (
                    f"Speaker mix checks failed.\nProportion of speaker '{name}' is negative."
                )
                values.append(val)
            spk_mix_id = np.asarray(ids, np.int32)[None, None]
            spk_mix_value = np.asarray(values, np.float32)[None, None]  # [1, 1, N]
            total = spk_mix_value.sum()
            assert total > 0.0, (
                "Speaker mix checks failed.\nProportions of speaker mix sum to zero."
            )
            spk_mix_value = spk_mix_value / total
        return spk_mix_id, spk_mix_value

    def encode_languages(self, ph_seq: str, lang: str | None, phoneme_dictionary) -> np.ndarray:
        """Language ids per phoneme: cross-lingual phonemes get the segment
        language's id, others 0."""
        return np.asarray(
            [
                (
                    self.lang_map[lang if "/" not in p else p.split("/", 1)[0]]
                    if phoneme_dictionary.is_cross_lingual(p)
                    else 0
                )
                for p in ph_seq.split()
            ],
            np.int32,
        )

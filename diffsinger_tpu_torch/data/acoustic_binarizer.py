"""Acoustic binarizer (counterpart of diffsinger_tpu/data/acoustic_binarizer.py):
wav + transcriptions.csv -> {mel, mel2ph, f0, variance curves, ...}, with the
features computed on the binarizer's device.
"""

from __future__ import annotations

import copy
import csv
import pathlib
import random

import numpy as np

from diffsinger_tpu_torch.data.augmentation import SpectrogramStretchAugmentation
from diffsinger_tpu_torch.data.base_binarizer import BaseBinarizer, dur_sec_to_mel2ph
from diffsinger_tpu_torch.dsp.common import get_energy
from diffsinger_tpu_torch.dsp.decomposed_waveform import DecomposedWaveform
from diffsinger_tpu_torch.dsp.mel import MelSpectrogram
from diffsinger_tpu_torch.dsp.pe import initialize_pe

ACOUSTIC_ITEM_ATTRIBUTES = [
    "spk_id",
    "mel",
    "languages",
    "tokens",
    "mel2ph",
    "f0",
    "energy",
    "breathiness",
    "voicing",
    "tension",
    "key_shift",
    "speed",
]

VARIANCE_CHECKLIST = ["energy", "breathiness", "voicing", "tension"]

# random pitch-shift draws are snapped to this grid (semitones), as in the
# JAX package, so that both packages write the same store
KEY_SHIFT_QUANTUM = 0.1


class AcousticBinarizer(BaseBinarizer):
    def __init__(self, hparams: dict, datasets=None, device=None):
        super().__init__(hparams, datasets=datasets, data_attrs=ACOUSTIC_ITEM_ATTRIBUTES,
                         device=device)
        hp = hparams
        self.need = {v: hp.get(f"use_{v}_embed", False) for v in VARIANCE_CHECKLIST}
        assert hp["mel_base"] == "e", (
            "Mel base must be set to 'e' (2nd stage of the reference's migration plan)."
        )
        self.mel_spec = MelSpectrogram(
            sr=hp["audio_sample_rate"], n_mels=hp["audio_num_mel_bins"],
            n_fft=hp["fft_size"], win_size=hp["win_size"], hop_size=hp["hop_size"],
            fmin=hp["fmin"], fmax=hp["fmax"],
        )
        self.pe = initialize_pe(hp, device=self.device)

    def feature_provenance(self) -> dict:
        info = super().feature_provenance()
        info["pe"] = self.pe.provenance()
        if any(self.need.get(v) for v in ("breathiness", "voicing", "tension")):
            info["hnsep"] = self.hnsep_provenance()
        return info

    def load_meta_data(self, raw_data_dir: pathlib.Path, ds_id, spk, lang):
        meta = {}
        with open(raw_data_dir / "transcriptions.csv", "r", encoding="utf-8") as f:
            for label in csv.DictReader(f):
                item_name = label["name"]
                entry = {
                    "wav_fn": str(raw_data_dir / "wavs" / f"{item_name}.wav"),
                    "spk_id": self.spk_map[spk],
                    "spk_name": spk,
                    "lang_seq": [
                        (
                            self.lang_map[lang if "/" not in p else p.split("/", 1)[0]]
                            if self.phoneme_dictionary.is_cross_lingual(p)
                            else 0
                        )
                        for p in label["ph_seq"].split()
                    ],
                    "ph_seq": self.phoneme_dictionary.encode(label["ph_seq"], lang=lang),
                    "ph_dur": [float(x) for x in label["ph_dur"].split()],
                    "ph_text": label["ph_seq"],
                }
                assert len(entry["ph_seq"]) == len(entry["ph_dur"]), (
                    f"Lengths of ph_seq and ph_dur mismatch in '{item_name}'."
                )
                assert all(d >= 0 for d in entry["ph_dur"]), (
                    f"Negative ph_dur found in '{item_name}'."
                )
                meta[f"{ds_id}:{item_name}"] = entry
        return meta

    def process_item(self, item_name, meta_data, binarization_args):
        hp = self.hparams
        hop, win = hp["hop_size"], hp["win_size"]
        waveform = self.load_waveform(meta_data["wav_fn"])
        with self.timer("mel"):
            mel = self.mel_spec.bucketed(waveform).T  # [T, M]
        length = mel.shape[0]
        seconds = length * hop / hp["audio_sample_rate"]
        item = {
            "name": item_name,
            "wav_fn": meta_data["wav_fn"],
            "spk_id": meta_data["spk_id"],
            "spk_name": meta_data["spk_name"],
            "seconds": seconds,
            "length": length,
            "mel": mel.astype(np.float32),
            "languages": np.asarray(meta_data["lang_seq"], np.int64),
            "tokens": np.asarray(meta_data["ph_seq"], np.int64),
            "ph_dur": np.asarray(meta_data["ph_dur"], np.float32),
            "ph_text": meta_data["ph_text"],
        }
        item["mel2ph"] = dur_sec_to_mel2ph(item["ph_dur"], length, self.timestep)

        with self.timer("pitch"):
            gt_f0, uv = self.pe.get_pitch(
                waveform, samplerate=hp["audio_sample_rate"], length=length,
                hop_size=hop, f0_min=hp["f0_min"], f0_max=hp["f0_max"], interp_uv=True,
            )
        if uv.all():
            print(f"Skipped '{item_name}': empty gt f0")
            return None
        item["f0"] = gt_f0.astype(np.float32)

        with self.timer("curves"):
            if self.need["energy"]:
                energy = get_energy(waveform, length, hop_size=hop, win_size=win)
                item["energy"] = self.smooth(energy.astype(np.float32), "energy_smooth_width")

            if any(self.need[v] for v in ("breathiness", "voicing", "tension")):
                dec = DecomposedWaveform(
                    waveform, hp["audio_sample_rate"], gt_f0 * ~uv,
                    hop_size=hop, fft_size=hp["fft_size"], win_size=win,
                    algorithm=hp.get("hnsep", "comb"), hnsep_ckpt=hp.get("hnsep_ckpt"),
                )
                if self.need["breathiness"]:
                    curve = get_energy(self.split(dec.aperiodic), length, hop_size=hop, win_size=win)
                    item["breathiness"] = self.smooth(curve.astype(np.float32),
                                                      "breathiness_smooth_width")
                if self.need["voicing"]:
                    curve = get_energy(self.split(dec.harmonic), length, hop_size=hop, win_size=win)
                    item["voicing"] = self.smooth(curve.astype(np.float32), "voicing_smooth_width")
                if self.need["tension"]:
                    # the share of the harmonic energy above the base harmonic, as a logit
                    e_base = get_energy(self.split(lambda: dec.harmonic(0)), length,
                                        hop_size=hop, win_size=win, domain="amplitude")
                    e_full = get_energy(self.split(dec.harmonic), length,
                                        hop_size=hop, win_size=win, domain="amplitude")
                    tension = np.sqrt(np.clip(e_full ** 2 - e_base ** 2, 0, None)) / (e_full + 1e-5)
                    tension = np.clip(tension, 1e-4, 1 - 1e-4)
                    tension = np.log(tension / (1 - tension))
                    tension = self.smooth(tension.astype(np.float32), "tension_smooth_width")
                    if np.isnan(tension).any():
                        print("Error:", item_name)
                        return None
                    item["tension"] = tension

        if hp.get("use_key_shift_embed", False):
            item["key_shift"] = 0.0
        if hp.get("use_speed_embed", False):
            item["speed"] = 1.0
        return item

    def arrange_data_augmentation(self, data_iterator):
        """The augmentation schedule: random and fixed pitch shifting, random
        time stretching (the reference's draws, in its order)."""
        hp = self.hparams
        aug_map = {}
        aug_list = []
        all_item_names = [name for name, _ in data_iterator]
        total_scale = 0

        def add(name, task):
            aug_map.setdefault(name, []).append(task)
            aug_list.append(task)

        rps = self.augmentation_args.get("random_pitch_shifting", {})
        if rps.get("enabled"):
            key_shift_min, key_shift_max = rps["range"]
            assert hp["use_key_shift_embed"], (
                "Random pitch shifting augmentation requires use_key_shift_embed == True."
            )
            assert key_shift_min < 0 < key_shift_max, (
                "Random pitch shifting augmentation must have a range where min < 0 < max."
            )
            aug_ins = SpectrogramStretchAugmentation(self, rps)
            scale = rps["scale"]
            for name in random.choices(all_item_names, k=int(scale * len(all_item_names))):
                rand = random.uniform(-1, 1)
                key_shift = key_shift_min * abs(rand) if rand < 0 else key_shift_max * rand
                key_shift = round(key_shift / KEY_SHIFT_QUANTUM) * KEY_SHIFT_QUANTUM
                add(name, {"name": name, "func": aug_ins.process_item,
                           "kwargs": {"key_shift": key_shift}})
            total_scale += scale

        fps = self.augmentation_args.get("fixed_pitch_shifting", {})
        if fps.get("enabled"):
            targets = fps["targets"]
            scale = fps["scale"]
            spk_id_size = max(self.spk_ids) + 1
            assert not rps.get("enabled"), (
                "Fixed pitch shifting augmentation is not compatible with random pitch shifting."
            )
            assert len(targets) == len(set(targets)), "duplicate targets"
            assert hp["use_spk_id"], "Fixed pitch shifting requires use_spk_id == True."
            assert hp["num_spk"] >= (1 + len(targets)) * spk_id_size, (
                "Fixed pitch shifting requires num_spk >= (1 + len(targets)) * (max(spk_ids) + 1)."
            )
            assert scale < 1, "Fixed pitch shifting requires scale < 1."
            aug_ins = SpectrogramStretchAugmentation(self, fps)
            for i, target in enumerate(targets):
                for name in random.choices(all_item_names, k=int(scale * len(all_item_names))):
                    replace_spk_id = (
                        self.spk_ids[int(name.split(":", 1)[0])] + (i + 1) * spk_id_size
                    )
                    add(name, {"name": name, "func": aug_ins.process_item,
                               "kwargs": {"key_shift": target, "replace_spk_id": replace_spk_id}})
            total_scale += scale * len(targets)

        rts = self.augmentation_args.get("random_time_stretching", {})
        if rts.get("enabled"):
            speed_min, speed_max = rts["range"]
            assert hp["use_speed_embed"], (
                "Random time stretching augmentation requires use_speed_embed == True."
            )
            assert 0 < speed_min < 1 < speed_max, (
                "Random time stretching must have a range where 0 < min < 1 < max."
            )
            aug_ins = SpectrogramStretchAugmentation(self, rts)
            scale = rts["scale"]
            n = len(all_item_names)
            k_from_raw = int(scale / (1 + total_scale) * n)
            k_from_aug = int(total_scale * scale / (1 + total_scale) * n)
            k_mutate = int(total_scale * scale / (1 + scale) * n)
            aug_types = [0] * k_from_raw + [1] * k_from_aug + [2] * k_mutate
            aug_items = random.choices(all_item_names, k=k_from_raw) + random.choices(
                aug_list, k=k_from_aug + k_mutate
            )
            for aug_type, aug_item in zip(aug_types, aug_items):
                speed = speed_min * (speed_max / speed_min) ** random.random()
                if aug_type == 0:
                    add(aug_item, {"name": aug_item, "func": aug_ins.process_item,
                                   "kwargs": {"speed": speed}})
                elif aug_type == 1:
                    task = {"name": aug_item["name"], "func": aug_item["func"],
                            "kwargs": copy.deepcopy(aug_item["kwargs"])}
                    task["kwargs"]["speed"] = speed
                    add(aug_item["name"], task)
                else:
                    aug_item["kwargs"]["speed"] = speed
            total_scale += scale

        return aug_map

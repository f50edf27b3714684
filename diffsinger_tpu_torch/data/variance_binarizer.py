"""Variance binarizer (counterpart of diffsinger_tpu/data/variance_binarizer.py):
transcriptions.csv (and, under ``prefer_ds``, .ds files) + wavs ->
{ph_dur, midi, ph2word, mel2ph, note_midi/rest/dur/glide, mel2note,
base_pitch, pitch, uv, variance curves}, with the features computed on the
binarizer's device.
"""

from __future__ import annotations

import csv
import json
import pathlib

import numpy as np

from diffsinger_tpu_torch.data.base_binarizer import (BaseBinarizer, BinarizationError,
                                                      dur_sec_to_frames, expand_to_length)
from diffsinger_tpu_torch.dsp.common import get_energy, interp_f0
from diffsinger_tpu_torch.dsp.decomposed_waveform import DecomposedWaveform
from diffsinger_tpu_torch.dsp.pe import initialize_pe
from diffsinger_tpu_torch.inference.ds_variance import _nearest_interp_rests, note_to_midi_float
from diffsinger_tpu_torch.utils.infer_utils import hz_to_midi, midi_to_note, resample_align_curve

VARIANCE_ITEM_ATTRIBUTES = [
    "spk_id",
    "languages",
    "tokens",
    "ph_dur",
    "midi",
    "ph2word",
    "mel2ph",
    "note_midi",
    "note_rest",
    "note_dur",
    "note_glide",
    "mel2note",
    "base_pitch",
    "pitch",
    "uv",
    "energy",
    "breathiness",
    "voicing",
    "tension",
]
DS_INDEX_SEP = "#"


class VarianceBinarizer(BaseBinarizer):
    def __init__(self, hparams: dict, datasets=None, device=None):
        super().__init__(hparams, datasets=datasets, data_attrs=VARIANCE_ITEM_ATTRIBUTES,
                         device=device)
        hp = hparams
        self.use_glide_embed = hp["use_glide_embed"]
        glide_types = hp["glide_types"]
        assert "none" not in glide_types, (
            "Type name 'none' is reserved and should not appear in glide_types."
        )
        self.glide_map = {"none": 0, **{t: i + 1 for i, t in enumerate(glide_types)}}
        self.var_list = [
            v for v in ("energy", "breathiness", "voicing", "tension")
            if hp.get(f"predict_{v}", False)
        ]
        self.predict_variances = bool(self.var_list)
        self.prefer_ds = self.binarization_args.get("prefer_ds", False)
        self.cached_ds = {}
        self.pe = initialize_pe(hp, device=self.device)

    def feature_provenance(self) -> dict:
        info = super().feature_provenance()
        info["pe"] = self.pe.provenance()
        if any(v in self.var_list for v in ("breathiness", "voicing", "tension")):
            info["hnsep"] = self.hnsep_provenance()
        return info

    # ------------------------------------------------------------------
    def load_attr_from_ds(self, ds_id, name, attr, idx=0):
        """An attribute of segment ``idx`` of the item's .ds file
        (``ds/{name}#{idx}.ds``, else ``ds/{name}.ds``), or None."""
        item_name = f"{ds_id}:{name}"
        item_name_with_idx = f"{item_name}{DS_INDEX_SEP}{idx}"
        if item_name_with_idx in self.cached_ds:
            ds = self.cached_ds[item_name_with_idx][0]
        elif item_name in self.cached_ds:
            ds = self.cached_ds[item_name][idx]
        else:
            ds_path = self.raw_data_dirs[ds_id] / "ds" / f"{name}{DS_INDEX_SEP}{idx}.ds"
            cache_key = item_name_with_idx
            if not ds_path.exists():
                ds_path = self.raw_data_dirs[ds_id] / "ds" / f"{name}.ds"
                cache_key = item_name
            if not ds_path.exists():
                return None
            with open(ds_path, "r", encoding="utf8") as f:
                ds = json.load(f)
            if not isinstance(ds, list):
                ds = [ds]
            self.cached_ds[cache_key] = ds
            ds = ds[idx]
        return ds.get(attr)

    def load_meta_data(self, raw_data_dir: pathlib.Path, ds_id, spk, lang):
        hp = self.hparams
        meta = {}
        with open(raw_data_dir / "transcriptions.csv", "r", encoding="utf8") as f:
            for label in csv.DictReader(f):
                item_name = label["name"]
                item_idx = (
                    int(item_name.rsplit(DS_INDEX_SEP, 1)[-1]) if DS_INDEX_SEP in item_name else 0
                )

                def require(attr, optional=False):
                    value = (
                        self.load_attr_from_ds(ds_id, item_name, attr, item_idx)
                        if self.prefer_ds else None
                    )
                    if value is None:
                        value = label.get(attr)
                    if value is None and not optional:
                        raise ValueError(f"Missing required attribute {attr} of item '{item_name}'.")
                    return value

                entry = {
                    "ds_idx": item_idx,
                    "spk_id": self.spk_map[spk],
                    "spk_name": spk,
                    "language_id": self.lang_map.get(lang, 0),
                    "language_name": lang,
                    "wav_fn": str(raw_data_dir / "wavs" / f"{item_name}.wav"),
                    "lang_seq": [
                        (
                            self.lang_map[lang if "/" not in p else p.split("/", 1)[0]]
                            if self.phoneme_dictionary.is_cross_lingual(p)
                            else 0
                        )
                        for p in label["ph_seq"].split()
                    ],
                    "ph_seq": self.phoneme_dictionary.encode(require("ph_seq"), lang=lang),
                    "ph_dur": [float(x) for x in require("ph_dur").split()],
                    "ph_text": require("ph_seq"),
                }
                assert len(entry["ph_seq"]) == len(entry["ph_dur"]), (
                    f"Lengths of ph_seq and ph_dur mismatch in '{item_name}'."
                )
                assert all(d >= 0 for d in entry["ph_dur"]), (
                    f"Negative ph_dur found in '{item_name}'."
                )
                if hp["predict_dur"]:
                    entry["ph_num"] = [int(x) for x in require("ph_num").split()]
                    assert len(entry["ph_seq"]) == sum(entry["ph_num"]), (
                        f"Sum of ph_num does not equal length of ph_seq in '{item_name}'."
                    )
                if hp["predict_pitch"]:
                    entry["note_seq"] = require("note_seq").split()
                    entry["note_dur"] = [float(x) for x in require("note_dur").split()]
                    assert all(d >= 0 for d in entry["note_dur"]), (
                        f"Negative note_dur found in '{item_name}'."
                    )
                    assert len(entry["note_seq"]) == len(entry["note_dur"]), (
                        f"Lengths of note_seq and note_dur mismatch in '{item_name}'."
                    )
                    assert any(n != "rest" for n in entry["note_seq"]), (
                        f"All notes are rest in '{item_name}'."
                    )
                    if hp["use_glide_embed"]:
                        glide = require("note_glide", optional=True)
                        if glide is None:
                            glide = ["none"] * len(entry["note_seq"])
                        else:
                            glide = glide.split()
                            assert len(glide) == len(entry["note_seq"]), (
                                f"Lengths of note_seq and note_glide mismatch in '{item_name}'."
                            )
                            assert all(g in self.glide_map for g in glide), (
                                f"Invalid glide type found in '{item_name}'."
                            )
                        entry["note_glide"] = glide
                meta[f"{ds_id}:{item_name}"] = entry
        return meta

    def check_coverage(self):
        super().check_coverage()
        hp = self.hparams
        if not hp["predict_pitch"]:
            return
        midi_map = {}
        for item in self.items.values():
            for note in item["note_seq"]:
                if note == "rest":
                    continue
                midi = round(note_to_midi_float(note))
                midi_map[midi] = midi_map.get(midi, 0) + 1
        print("===== MIDI Pitch Distribution Summary =====")
        print(", ".join(f"'{midi_to_note(k)}': {midi_map[k]}" for k in sorted(midi_map)))
        midis = sorted(midi_map.keys())
        self.save_distribution(
            "midi_distribution.jpg", title="MIDI Pitch Distribution Summary",
            x_label="MIDI Key", y_label="Number of occurrences",
            items=[midi_to_note(m) for m in range(midis[0], midis[-1] + 1)],
            values=[midi_map.get(m, 0) for m in range(midis[0], midis[-1] + 1)],
        )

        if self.use_glide_embed:
            glide_count = {g: 0 for g in self.glide_map}
            for item in self.items.values():
                for glide in item["note_glide"]:
                    if glide == "none" or glide not in self.glide_map:
                        glide_count["none"] += 1
                    else:
                        glide_count[glide] += 1
            print("===== Glide Type Distribution Summary =====")
            print(", ".join(f"'{k}': {glide_count[k]}"
                            for k in sorted(glide_count, key=lambda k: self.glide_map[k])))
            if any(n == 0 for n in glide_count.values()):
                raise BinarizationError(
                    f"Missing glide types in dataset: "
                    f"{sorted([g for g, n in glide_count.items() if n == 0], key=lambda k: self.glide_map[k])}"
                )

    # ------------------------------------------------------------------
    def _curve_from_ds_or(self, ds_id, name, ds_seg_idx, attr, length, fallback):
        """Under ``prefer_ds`` the .ds curve resampled to the frames, else (or
        where the .ds has none) ``fallback()`` smoothed."""
        if self.prefer_ds:
            seq = self.load_attr_from_ds(ds_id, name, attr, idx=ds_seg_idx)
            if seq is not None:
                return resample_align_curve(
                    np.asarray(seq.split(), np.float32),
                    original_timestep=float(
                        self.load_attr_from_ds(ds_id, name, f"{attr}_timestep", idx=ds_seg_idx)
                    ),
                    target_timestep=self.timestep,
                    align_length=length,
                )
        return self.smooth(fallback().astype(np.float32), f"{attr}_smooth_width")

    def process_item(self, item_name, meta_data, binarization_args):
        hp = self.hparams
        hop, win = hp["hop_size"], hp["win_size"]
        ds_id, name = item_name.split(":", 1)
        name = name.rsplit(DS_INDEX_SEP, 1)[0]
        ds_id = int(ds_id)
        ds_seg_idx = meta_data["ds_idx"]
        seconds = sum(meta_data["ph_dur"])
        length = round(seconds / self.timestep)
        t_ph = len(meta_data["ph_seq"])
        item = {
            "name": item_name,
            "wav_fn": meta_data["wav_fn"],
            "spk_id": meta_data["spk_id"],
            "spk_name": meta_data["spk_name"],
            "seconds": seconds,
            "length": length,
            "languages": np.asarray(meta_data["lang_seq"], np.int64),
            "tokens": np.asarray(meta_data["ph_seq"], np.int64),
            "ph_text": meta_data["ph_text"],
        }
        ph_dur_sec = np.asarray(meta_data["ph_dur"], np.float32)
        ph_dur = dur_sec_to_frames(ph_dur_sec, self.timestep)
        item["ph_dur"] = ph_dur
        mel2ph = expand_to_length(ph_dur, length)
        if hp["predict_pitch"] or self.predict_variances:
            item["mel2ph"] = mel2ph

        wav_path = pathlib.Path(meta_data["wav_fn"])
        if wav_path.exists():
            waveform = self.load_waveform(wav_path)
        elif not self.prefer_ds:
            raise FileNotFoundError(meta_data["wav_fn"])
        else:
            waveform = None

        f0 = uv = None
        if self.prefer_ds:
            f0_seq = self.load_attr_from_ds(ds_id, name, "f0_seq", idx=ds_seg_idx)
            if f0_seq is not None:
                f0 = resample_align_curve(
                    np.asarray(f0_seq.split(), np.float32),
                    original_timestep=float(
                        self.load_attr_from_ds(ds_id, name, "f0_timestep", idx=ds_seg_idx)
                    ),
                    target_timestep=self.timestep,
                    align_length=length,
                )
                uv = f0 == 0
                f0, _ = interp_f0(f0, uv)
        if f0 is None:
            with self.timer("pitch"):
                f0, uv = self.pe.get_pitch(
                    waveform, samplerate=hp["audio_sample_rate"], length=length,
                    hop_size=hop, f0_min=hp["f0_min"], f0_max=hp["f0_max"], interp_uv=True,
                )
        if uv.all():
            print(f"Skipped '{item_name}': empty gt f0")
            return None
        pitch = hz_to_midi(f0.astype(np.float32)).astype(np.float32)

        if hp["predict_dur"]:
            ph_num = np.asarray(meta_data["ph_num"], np.int64)
            item["ph2word"] = np.repeat(np.arange(1, len(ph_num) + 1), ph_num).astype(np.int64)
            mel2dur = np.pad(ph_dur, (1, 0), constant_values=1)[mel2ph]
            ph_midi = np.zeros(t_ph + 1, np.float64)
            np.add.at(ph_midi, mel2ph, pitch / np.maximum(mel2dur, 1))
            item["midi"] = np.clip(np.round(ph_midi[1:]), 0, 127).astype(np.int64)

        if hp["predict_pitch"]:
            note_midi = np.asarray(
                [note_to_midi_float(n) if n != "rest" else -1 for n in meta_data["note_seq"]],
                np.float32,
            )
            note_rest = note_midi < 0
            note_midi = _nearest_interp_rests(note_midi, note_rest)
            item["note_midi"] = note_midi
            item["note_rest"] = note_rest
            note_dur = dur_sec_to_frames(np.asarray(meta_data["note_dur"], np.float32), self.timestep)
            item["note_dur"] = note_dur
            mel2note = expand_to_length(note_dur, len(mel2ph))
            item["mel2note"] = mel2note
            if hp["use_glide_embed"]:
                item["note_glide"] = np.asarray(
                    [self.glide_map.get(x, 0) for x in meta_data["note_glide"]], np.int64
                )
            frame_midi = np.pad(note_midi, (1, 0))[mel2note]
            with self.timer("curves"):
                item["base_pitch"] = self.smooth(frame_midi.astype(np.float32), "midi_smooth_width")

        if hp["predict_pitch"] or self.predict_variances:
            item["pitch"] = pitch
            item["uv"] = uv

        dec = (
            DecomposedWaveform(
                waveform, hp["audio_sample_rate"], f0 * ~uv,
                hop_size=hop, fft_size=hp["fft_size"], win_size=win,
                algorithm=hp.get("hnsep", "comb"), hnsep_ckpt=hp.get("hnsep_ckpt"),
            )
            if waveform is not None else None
        )

        def energy_of(part, domain="db"):
            return get_energy(self.split(part), length, hop_size=hop, win_size=win, domain=domain)

        with self.timer("curves"):
            if hp.get("predict_energy", False):
                item["energy"] = self._curve_from_ds_or(
                    ds_id, name, ds_seg_idx, "energy", length,
                    lambda: get_energy(waveform, length, hop_size=hop, win_size=win),
                )
            if hp.get("predict_breathiness", False):
                item["breathiness"] = self._curve_from_ds_or(
                    ds_id, name, ds_seg_idx, "breathiness", length,
                    lambda: energy_of(dec.aperiodic),
                )
            if hp.get("predict_voicing", False):
                item["voicing"] = self._curve_from_ds_or(
                    ds_id, name, ds_seg_idx, "voicing", length,
                    lambda: energy_of(dec.harmonic),
                )
            if hp.get("predict_tension", False):
                def tension_fallback():
                    e_base = energy_of(lambda: dec.harmonic(0), "amplitude")
                    e_full = energy_of(dec.harmonic, "amplitude")
                    tension = np.sqrt(np.clip(e_full ** 2 - e_base ** 2, 0, None)) / (e_full + 1e-5)
                    tension = np.clip(tension, 1e-4, 1 - 1e-4)
                    return np.log(tension / (1 - tension))

                tension = self._curve_from_ds_or(ds_id, name, ds_seg_idx, "tension", length,
                                                 tension_fallback)
                if np.isnan(tension).any():
                    print("Error:", item_name)
                    return None
                item["tension"] = tension
        return item

    def arrange_data_augmentation(self, data_iterator):
        return {}

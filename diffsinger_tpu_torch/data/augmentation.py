"""Pitch-shift and time-stretch augmentation (counterpart of
diffsinger_tpu/data/augmentation.py).

An augmented copy re-extracts the mel with the keyshift/speed STFT, scales the
durations by the real speed (the hop is rounded) and the f0 by the shift, and
resamples the variance curves in time.
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np

from diffsinger_tpu_torch.data.base_binarizer import dur_sec_to_mel2ph
from diffsinger_tpu_torch.utils.infer_utils import resample_align_curve

VARIANCE_CHECKLIST = ["energy", "breathiness", "voicing", "tension"]


class SpectrogramStretchAugmentation:
    """``binarizer`` gives the config, the waveform loader (its device), the
    stage timer, the mel transform and the pitch extractor."""

    def __init__(self, binarizer, augmentation_args: dict):
        self.binarizer = binarizer
        self.augmentation_args = augmentation_args

    def process_item(self, item: dict, key_shift=0.0, speed=1.0, replace_spk_id=None) -> dict:
        b = self.binarizer
        hp = b.hparams
        aug_item = deepcopy(item)
        waveform = b.load_waveform(aug_item["wav_fn"])
        with b.timer("mel"):
            mel = b.mel_spec.bucketed(waveform, keyshift=key_shift, speed=speed).T
        aug_item["mel"] = mel.astype(np.float32)

        if speed != 1.0 or hp.get("use_speed_embed", False):
            aug_item["length"] = mel.shape[0]
            real_speed = int(np.round(hp["hop_size"] * speed)) / hp["hop_size"]
            aug_item["speed"] = real_speed
            aug_item["seconds"] /= real_speed
            aug_item["ph_dur"] = aug_item["ph_dur"] / real_speed
            aug_item["mel2ph"] = dur_sec_to_mel2ph(aug_item["ph_dur"], aug_item["length"], b.timestep)
            with b.timer("pitch"):
                f0, _ = b.pe.get_pitch(
                    waveform, samplerate=hp["audio_sample_rate"], length=aug_item["length"],
                    hop_size=hp["hop_size"], f0_min=hp["f0_min"], f0_max=hp["f0_max"],
                    speed=speed, interp_uv=True,
                )
            aug_item["f0"] = f0.astype(np.float32)
            # the curves are resampled in time, an approximation the reference makes too
            for v_name in VARIANCE_CHECKLIST:
                if v_name in item:
                    aug_item[v_name] = resample_align_curve(
                        aug_item[v_name],
                        original_timestep=b.timestep,
                        target_timestep=b.timestep * real_speed,
                        align_length=aug_item["length"],
                    )

        if key_shift != 0.0 or hp.get("use_key_shift_embed", False):
            if replace_spk_id is None:
                aug_item["key_shift"] = key_shift
            else:
                aug_item["spk_id"] = replace_spk_id
            aug_item["f0"] = aug_item["f0"] * 2 ** (key_shift / 12)

        if set(item) != set(aug_item):
            raise AssertionError(
                "Item keys mismatch after augmentation.\n"
                f"Before: {sorted(item)}\nAfter: {sorted(aug_item)}")
        return aug_item

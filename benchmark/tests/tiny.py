"""Tiny versions of the benchmark's configurations, for runs on the CPU."""

import copy
import json
from pathlib import Path

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def config(name: str, precision: str = "float32", curves: bool = False) -> dict:
    """The cell's configuration at narrow widths and two sampler steps;
    ``curves`` turns on the variance model's four curves, which the
    published configuration leaves off."""
    with open(CONFIGS / f"{name}.json", encoding="utf-8") as f:
        cfg = copy.deepcopy(json.load(f))
    hp = cfg["hparams"]
    hp.update(hidden_size=32, enc_layers=2, sampling_steps=2)
    if name == "acoustic":
        hp["infer_precision"] = "bf16" if precision == "bf16" else None
        hp["backbone_args"] = dict(hp["backbone_args"], num_channels=32, num_layers=2)
        hp["shallow_diffusion_args"] = dict(
            hp["shallow_diffusion_args"],
            aux_decoder_args=dict(num_channels=32, num_layers=2, kernel_size=7, dropout_rate=0.1))
        cfg["vocoder"] = dict(cfg["vocoder"], upsample_initial_channel=32)
    else:
        hp["dur_prediction_args"] = dict(hp["dur_prediction_args"], hidden_size=32, num_layers=2)
        for key in ("pitch_prediction_args", "variances_prediction_args"):
            hp[key] = dict(hp[key], backbone_args=dict(num_layers=4, num_channels=16,
                                                       dilation_cycle_length=2))
        if curves:
            hp.update({f"predict_{v}": True for v in ("energy", "breathiness", "voicing",
                                                      "tension")})
    cfg["precision"] = precision
    return cfg

"""Copy-synthesis through the vocoder (counterpart of scripts/val_nsf_hifigan.py):

    python -m diffsinger_tpu_torch.cli.val_nsf_hifigan WAV_FILE --config CFG
        [--out DIR] [--device cpu]

wav -> log-mel (``dsp/mel.py::MelSpectrogram.bucketed``) and f0 (the
config's ``pe``, unvoiced frames interpolated) -> the config's vocoder ->
``<out>/<stem>_copysynth.wav``, for listening checks of a vocoder
checkpoint. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import pathlib
from typing import List, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m diffsinger_tpu_torch.cli.val_nsf_hifigan",
                                     description="Copy-synthesis through the NSF-HiFiGAN vocoder")
    parser.add_argument("wav", type=pathlib.Path, metavar="WAV_FILE")
    parser.add_argument("--config", type=pathlib.Path, required=True)
    parser.add_argument("--out", type=pathlib.Path)
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' to run without a card; default: the card")
    return parser


def main(argv: Optional[List[str]] = None) -> pathlib.Path:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.wav.is_file():
        parser.error(f"file '{args.wav}' does not exist")

    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.dsp.mel import MelSpectrogram
    from diffsinger_tpu_torch.dsp.pe import initialize_pe
    from diffsinger_tpu_torch.utils import resolve_device
    from diffsinger_tpu_torch.utils.infer_utils import load_wav, save_wav
    from diffsinger_tpu_torch.vocoders.registry import get_vocoder_cls

    device = resolve_device(args.device)
    hp = load_config(args.config, infer=True)
    out = args.out or args.wav.parent
    out.mkdir(parents=True, exist_ok=True)

    sr = hp["audio_sample_rate"]
    waveform, _ = load_wav(args.wav, target_sr=sr)
    mel_spec = MelSpectrogram(sr=sr, n_mels=hp["audio_num_mel_bins"], n_fft=hp["fft_size"],
                              win_size=hp["win_size"], hop_size=hp["hop_size"],
                              fmin=hp["fmin"], fmax=hp["fmax"])
    mel = mel_spec.bucketed(waveform, device=device).T  # [T, M]
    f0, _ = initialize_pe(hp, device=device).get_pitch(
        waveform, samplerate=sr, length=mel.shape[0], hop_size=hp["hop_size"],
        f0_min=hp["f0_min"], f0_max=hp["f0_max"], interp_uv=True, device=device)
    vocoder = get_vocoder_cls(hp)(hp, device=device)
    wav_out = vocoder.spec2wav(mel, f0=np.asarray(f0, np.float32))
    save_path = out / f"{args.wav.stem}_copysynth.wav"
    save_wav(wav_out, save_path, sr)
    print(f"| save audio: {save_path}")
    return save_path


if __name__ == "__main__":
    main()

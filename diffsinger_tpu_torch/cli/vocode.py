"""Vocoder entry point of the port (counterpart of scripts/vocode.py):

    python -m diffsinger_tpu_torch.cli.vocode MEL_FILE (--exp EXP | --config CFG)
        [--out DIR] [--title NAME] [--device cpu]

MEL_FILE is a ``.mel.npz`` written by ``cli.infer acoustic --mel`` (keys
``mel_<i>``, ``f0_<i>``, ``offset_<i>``, ``num_segments``) or the
reference's ``.mel.pt`` (a list of dicts with ``mel`` [1, T, M] or [T, M],
``f0`` [1, T] and ``offset``). Each segment runs through the config's
vocoder; the segments are placed at their offsets, with silence between them
and a linear cross-fade where they overlap, and written as
``<out>/<name>.wav``. The experiment is found as ``cli.infer`` finds it
(``DS_CKPT_ROOT``). It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import pathlib
from typing import List, Optional, Tuple

import numpy as np


def read_segments(path: pathlib.Path) -> List[Tuple[np.ndarray, np.ndarray, float]]:
    """(mel [T, M], f0 [T], offset in seconds) of each segment of a mel file."""
    if path.name.endswith(".pt"):
        import torch

        seq = torch.load(path, map_location="cpu", weights_only=False)
        assert isinstance(seq, list) and seq, "Not a valid mel sequence."

        def arr(v):
            return (v.detach().cpu().numpy() if hasattr(v, "detach")
                    else np.asarray(v)).astype(np.float32)

        return [(arr(s["mel"]).reshape(-1, arr(s["mel"]).shape[-1]), arr(s["f0"]).reshape(-1),
                 float(s["offset"])) for s in seq]
    data = np.load(path)
    return [(data[f"mel_{i}"], data[f"f0_{i}"], float(data[f"offset_{i}"]))
            for i in range(int(data["num_segments"]))]


def place_segments(wavs: List[np.ndarray], offsets: List[float], sr: int) -> np.ndarray:
    """Concatenate waveforms at their offsets: silence before a segment that
    starts after the previous one ends, a cross-fade where they overlap."""
    from diffsinger_tpu_torch.utils.infer_utils import cross_fade

    result = np.zeros(0)
    current_length = 0
    for wav, offset in zip(wavs, offsets):
        silent_length = round(offset * sr) - current_length
        if silent_length >= 0:
            result = np.append(result, np.zeros(silent_length))
            result = np.append(result, wav)
        else:
            result = cross_fade(result, wav, current_length + silent_length)
        current_length = current_length + silent_length + wav.shape[0]
    return result


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m diffsinger_tpu_torch.cli.vocode",
                                     description="Run DiffSinger vocoder")
    parser.add_argument("mel", type=pathlib.Path, metavar="MEL_FILE")
    parser.add_argument("--exp", type=str, metavar="EXP", help="Read vocoder config from experiment")
    parser.add_argument("--config", type=pathlib.Path, help="Read vocoder config from file")
    parser.add_argument("--out", type=pathlib.Path)
    parser.add_argument("--title", type=str)
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' to run without a card; default: the card")
    return parser


def main(argv: Optional[List[str]] = None) -> pathlib.Path:
    parser = build_parser()
    args = parser.parse_args(argv)
    mel = args.mel.resolve()
    if not mel.is_file():
        parser.error(f"file '{args.mel}' does not exist")
    name = args.title or mel.name.removesuffix(".mel.npz").removesuffix(".mel.pt")
    out = mel.parent if args.out is None else args.out

    from diffsinger_tpu_torch.config import load_config

    if args.exp is not None:
        from diffsinger_tpu_torch.cli.infer import ckpt_root_dir, find_exp

        hp = load_config(exp_name=find_exp(args.exp), infer=True, ckpt_root=ckpt_root_dir())
    elif args.config is not None:
        hp = load_config(args.config, infer=True)
    else:
        parser.error("Either --exp or --config must be specified.")

    from diffsinger_tpu_torch.utils.infer_utils import save_wav
    from diffsinger_tpu_torch.vocoders.registry import get_vocoder_cls

    vocoder = get_vocoder_cls(hp)(hp, device=args.device)
    segments = read_segments(mel)
    wavs = [vocoder.spec2wav(m, f0=f0) for m, f0, _ in segments]
    sr = hp["audio_sample_rate"]
    result = place_segments(wavs, [offset for *_, offset in segments], sr)
    out.mkdir(parents=True, exist_ok=True)
    save_path = out / f"{name}.wav"
    print(f"| save audio: {save_path}")
    save_wav(result, save_path, sr)
    return save_path


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Hold this checkout's PReLU path bit for bit against another checkout's.

    python3 tools/compare_checkouts.py OTHER_ROOT [--out FILE]

Runs, in one process for each checkout (each imports its own
``diffsinger_tpu_torch`` and builds its own kernels), on the card:
K1 at [16, 1024, 2048] bf16 k=31 and K2 at x [16, 1024, 1024] bf16, I=2048
with PReLU on seeded inputs, and configs/acoustic.yaml at full width with
seeded weights (PReLU) at bench.py's request (B=16, T_mel 1024, 50 steps,
bf16) with the mini-NSF vocoder, its noise from a seeded generator. Each
process saves its outputs; this script then reports, for each output,
whether the two checkouts' are equal to the bit, and the max |difference|.
Needs one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

WORKER = r'''
import sys
root, out = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np
import torch

from diffsinger_tpu_torch.config import load_config
from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
from diffsinger_tpu_torch.ops import depthwise_conv, lynx_fused
from diffsinger_tpu_torch.vocoders.nsf_hifigan_model import Generator, NsfHifiGanConfig

dev, bf = torch.device("cuda"), torch.bfloat16
g = torch.Generator(device=dev).manual_seed(0)
rnd = lambda *s, scale=1.0, shift=0.0: (shift + scale * torch.randn(s, generator=g, device=dev)).to(bf)
s = rnd(16, 1024, 2048)
w, b, a = rnd(2048, 31, scale=0.2), rnd(2048, scale=0.1), rnd(2048, scale=0.1, shift=0.25)
outs = {"k1": depthwise_conv.depthwise_conv1d_prelu(s, w, a, b)}
x = rnd(16, 1024, 1024)
p = dict(ln_scale=rnd(1024, scale=0.2, shift=1.0), ln_bias=rnd(1024, scale=0.1),
         w1=rnd(4096, 1024, scale=1024 ** -0.5), b1=rnd(4096, scale=0.1), dw_w=w, dw_b=b,
         alpha=a, w2=rnd(1024, 2048, scale=2048 ** -0.5), b2=rnd(1024, scale=0.1))
outs["k2"] = lynx_fused.fused_conv_module(x, **p)

hp = load_config(f"{root}/configs/acoustic.yaml", "sampling_steps=50")
torch.manual_seed(5)
model32 = DiffSingerAcoustic(hp, vocab_size=62, out_dims=128, dtype=torch.float32)
cpu = torch.Generator().manual_seed(6)
with torch.no_grad():
    for name, t in model32.module.named_parameters():
        t.add_((0.02 * torch.randn(t.shape, generator=cpu)).to(t.device))
model = DiffSingerAcoustic(hp, vocab_size=62, out_dims=128, dtype=bf)
model.module.load_state_dict(model32.module.state_dict())
torch.manual_seed(7)
voc = Generator(NsfHifiGanConfig(num_mels=128, sampling_rate=44100, mini_nsf=True), dtype=bf).eval()
rng = np.random.default_rng(0)
tokens = torch.from_numpy(rng.integers(1, 62, (16, 128))).to(dev)
mel2ph = torch.from_numpy(np.tile(np.repeat(np.arange(1, 129), 8)[None], (16, 1))).to(dev)
f0 = torch.from_numpy((220.0 * 2 ** rng.uniform(-1, 1, (16, 1))
                       * np.ones((1, 1024))).astype(np.float32)).to(dev)
mel = model.forward_infer(tokens, mel2ph, f0, steps=50,
                          generator=torch.Generator(device=dev).manual_seed(1)).diff_out
with torch.no_grad():
    wav = voc(mel, f0)
outs.update(mel=mel, wav=wav)
torch.cuda.synchronize()
np.savez(out, **{k: v.float().cpu().numpy() for k, v in outs.items()})
'''


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "compare_checkouts.json")
    args = parser.parse_args()
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        saved = {}
        for label, root in (("this", ROOT), ("other", args.other.resolve())):
            path = Path(tmp) / f"{label}.npz"
            subprocess.run([sys.executable, "-c", WORKER, str(root), str(path)], check=True)
            saved[label] = np.load(path)
        report = {k: {"bit_equal": bool(np.array_equal(saved["this"][k], saved["other"][k])),
                      "max_abs_diff": float(np.abs(saved["this"][k] - saved["other"][k]).max()),
                      "shape": list(saved["this"][k].shape)}
                  for k in saved["this"].files}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0 if all(v["bit_equal"] for v in report.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

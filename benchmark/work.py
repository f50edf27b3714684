"""Operations and bytes from shapes, for the MFU and roofline metrics.

``flops`` count the products (matrix products and convolutions, 2 per
multiply-add, the count ``torch.utils.flop_counter`` gives); elementwise
work is left out of them, as MFU conventionally does. The LYNXNet conv
module's roofline also counts its elementwise work on the CUDA cores
(LayerNorm 8, SwiGLU 5, bias and PReLU 3 operations an element: fewer than a
kernel executes, so the bound stays a lower bound) and its bytes: each input
read once, each output written once, the weights once.
"""

from __future__ import annotations

import math
from typing import Dict

# NVIDIA H100 SXM data sheet, dense
PEAKS = {"bf16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def conv1d(b: int, t_out: int, c_in: int, c_out: int, k: int, groups: int = 1) -> float:
    return 2.0 * b * t_out * c_out * (c_in // groups) * k


def linear(rows: int, c_in: int, c_out: int) -> float:
    return 2.0 * rows * c_in * c_out


def lynx_convmodule(b: int, t: int, c: int, inner: int, k: int, elem_bytes: int = 2) -> Dict:
    """One LYNXNet conv module call on x [b, t, c]: tensor-core FLOPs (the
    two 1x1 convolutions), CUDA-core FLOPs (the depthwise conv and the
    elementwise work), and bytes."""
    rows = b * t
    tc = linear(rows, c, 2 * inner) + linear(rows, inner, c)
    cuda = conv1d(b, t, inner, inner, k, groups=inner) + rows * (8 * c + 5 * inner + 3 * inner)
    weights = 2 * inner * c + 2 * inner + inner * k + 2 * inner + c * inner + c + 2 * c
    return {"tc_flops": tc, "cuda_flops": cuda,
            "bytes": float(elem_bytes * (2 * rows * c + weights))}


def least_seconds(work: Dict, tc_peak: float, cuda_peak: float = PEAKS["float32"]) -> float:
    """The least time the chip could take: the largest of its three bounds."""
    return max(work["tc_flops"] / tc_peak, work["cuda_flops"] / cuda_peak,
               work["bytes"] / HBM_BYTES_PER_S)


def encoder(b: int, t: int, h: int, layers: int, k: int) -> float:
    per_layer = (linear(b * t, h, 3 * h) + 2 * (2.0 * b * t * t * h) + linear(b * t, h, h)
                 + conv1d(b, t, h, 4 * h, k) + linear(b * t, 4 * h, h))
    return layers * per_layer


def aux_decoder(b: int, t: int, h: int, c: int, layers: int, k: int, out: int) -> float:
    block = conv1d(b, t, c, c, 7, groups=c) + 2 * linear(b * t, c, 4 * c)
    return conv1d(b, t, h, c, k) + layers * block + conv1d(b, t, c, out, k)


def lynxnet_call(b: int, t: int, c: int, layers: int, inner: int, k: int, m: int) -> float:
    """One denoiser call (the condition's projections hoisted out of it)."""
    step = linear(b, c, 4 * c) + linear(b, 4 * c, c)
    layer = linear(b, c, c) + lynx_convmodule(b, t, c, inner, k)["tc_flops"] + conv1d(
        b, t, inner, inner, k, groups=inner)
    return linear(b * t, m, c) + step + layers * layer + linear(b * t, c, m)


def acoustic(b: int, t_txt: int, t: int, hp: dict) -> float:
    """The acoustic model's inference at [b, t_txt] tokens and [b, t] frames."""
    h, m = hp["hidden_size"], hp["audio_num_mel_bins"]
    aux = hp["shallow_diffusion_args"]["aux_decoder_args"]
    bb = hp["backbone_args"]
    c, layers = bb["num_channels"], bb["num_layers"]
    inner = c * bb.get("expansion_factor", 2)
    return (linear(b * t_txt, 1, h) + linear(b * t, 1, h)  # the duration and f0 embeds
            + encoder(b, t_txt, h, hp["enc_layers"], hp["enc_ffn_kernel_size"])
            + aux_decoder(b, t, h, aux["num_channels"], aux["num_layers"], aux["kernel_size"], m)
            + layers * linear(b * t, h, c)
            + hp["sampling_steps"] * lynxnet_call(b, t, c, layers, inner, bb["kernel_size"], m))


def acoustic_train(b: int, t_txt: int, t: int, hp: dict) -> float:
    """The acoustic model's training forward at [b, t_txt] tokens and [b, t]
    frames: the encoder, the aux decoder and one denoiser call (with the
    condition's projections). Its backward does twice the products."""
    return acoustic(b, t_txt, t, dict(hp, sampling_steps=1))


def vocoder(b: int, frames: int, cfg: dict) -> float:
    """NSF-HiFiGAN (full NSF, ResBlock1) on [b, frames] mel frames."""
    rates, kernels = cfg["upsample_rates"], cfg["upsample_kernel_sizes"]
    c = cfg["upsample_initial_channel"]
    total = conv1d(b, frames, cfg["num_mels"], c, 7)
    length = frames
    for i, (u, k) in enumerate(zip(rates, kernels)):
        total += 2.0 * b * length * c * (c // 2) * k  # transposed: each input tap feeds k outputs
        c //= 2
        length *= u
        if i + 1 < len(rates):
            s = math.prod(rates[i + 1:])
            total += conv1d(b, length, 1, c, 2 * s)
        else:
            total += conv1d(b, length, 1, c, 1)
        for rk, dil in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]):
            total += 2 * len(dil) * conv1d(b, length, c, c, rk)
    return total + conv1d(b, length, c, 1, 7) + 2.0 * b * length * 9


def wavenet_call(b: int, t: int, width: int, args: dict) -> float:
    c, layers = args["num_channels"], args["num_layers"]
    step = linear(b, c, 4 * c) + linear(b, 4 * c, c)
    layer = linear(b, c, c) + conv1d(b, t, c, 2 * c, 3) + linear(b * t, c, 2 * c)
    return (linear(b * t, width, c) + step + layers * layer + linear(b * t, c, c)
            + linear(b * t, c, width))


def variance(b: int, t_ph: int, t: int, hp: dict) -> float:
    """The variance model's score-only inference at [b, t_ph] phonemes and [b, t] frames."""
    h = hp["hidden_size"]
    d = hp["dur_prediction_args"]
    dur = 0.0
    cin = h
    for _ in range(d["num_layers"]):
        dur += conv1d(b, t_ph, cin, d["hidden_size"], d["kernel_size"])
        cin = d["hidden_size"]
    dur += linear(b * t_ph, cin, 1)
    p = hp["pitch_prediction_args"]
    v = hp["variances_prediction_args"]
    n_var = sum(bool(hp.get(f"predict_{x}")) for x in ("energy", "breathiness", "voicing",
                                                       "tension"))
    steps = hp["sampling_steps"]
    pc, vc = p["backbone_args"], v["backbone_args"]
    flops = (linear(b * t_ph, 1, h) + linear(b * t, 1, h)  # word-duration, base-pitch embeds
             + encoder(b, t_ph, h, hp["enc_layers"], hp["enc_ffn_kernel_size"]) + dur
             + pc["num_layers"] * linear(b * t, h, 2 * pc["num_channels"])
             + steps * wavenet_call(b, t, p["repeat_bins"], pc))
    if n_var:  # the pitch embed and the curves' sampler
        flops += (linear(b * t, 1, h) + vc["num_layers"] * linear(b * t, h, 2 * vc["num_channels"])
                  + steps * wavenet_call(b, t, v["total_repeat_bins"] // n_var * n_var, vc))
    return flops


"""Operations and bytes from shapes for the WaveNet-DDPM acoustic model, for
its MFU and its residual stacks' roofline.

The products are counted as ``work.py`` counts them (2 per multiply-add,
elementwise work left out). A sampling makes ``ddim_calls`` denoiser calls:
DDIM from ``(K - 1) // s * s`` down to 0 at stride ``s``, ``K`` the smaller
of ``K_step_infer`` and ``K_step``.

The residual stack's least time (:func:`stack_least_seconds`) counts only
the work that every implementation of the blocks has to do, whatever its
precision: the dilated conv (C -> 2C, 3 taps) and the output projection
(C -> 2C) of every block at every frame as bf16 tensor-core FLOPs at 989
TFLOP/s, and as bytes at 3.35 TB/s x read once, the hoisted conditioner
projections read once, the skip sum written once and each call's weights
read once, all in bf16. The step projections (per row, not per frame) and
the gates' elementwise work are left out, so the bound stays a lower bound
and the share of it cannot pass 100 % unless the work is undercounted.
"""

from __future__ import annotations

from benchmark import work

ELEM_BYTES = 2  # bf16


def ddim_calls(hp: dict) -> int:
    k = min(hp["K_step_infer"], hp["K_step"])
    return (k - 1) // hp["diff_speedup"] + 1


def acoustic(b: int, t_txt: int, t: int, hp: dict) -> float:
    """The WaveNet-DDPM acoustic model's inference at [b, t_txt] tokens and
    [b, t] frames: the embeds, the encoder, the ConvNeXt draft, the hoisted
    conditioner projections and ``ddim_calls`` WaveNet calls."""
    h, m = hp["hidden_size"], hp["audio_num_mel_bins"]
    aux = hp["shallow_diffusion_args"]["aux_decoder_args"]
    bb = hp["backbone_args"]
    c, layers = bb["num_channels"], bb["num_layers"]
    return (work.linear(b * t_txt, 1, h) + work.linear(b * t, 1, h)
            + work.encoder(b, t_txt, h, hp["enc_layers"], hp["enc_ffn_kernel_size"])
            + work.aux_decoder(b, t, h, aux["num_channels"], aux["num_layers"],
                               aux["kernel_size"], m)
            + layers * work.linear(b * t, h, 2 * c)
            + ddim_calls(hp) * work.wavenet_call(b, t, m, bb))


def stack_tc_flops(frames: float, c: int, layers: int) -> float:
    """The blocks' dilated convs and output projections over ``frames`` frames."""
    return layers * (work.conv1d(1, 1, c, 2 * c, 3) + work.linear(1, c, 2 * c)) * frames


def stack_bytes(frames: float, calls: float, c: int, layers: int) -> float:
    """x, the conditioner projections and the skip sum once a frame; each
    call's conv, output and step-projection weights and biases once."""
    per_frame = c + layers * 2 * c + c
    per_call = layers * (3 * c * 2 * c + 2 * c + c * 2 * c + 2 * c + c * c + c)
    return ELEM_BYTES * (per_frame * frames + per_call * calls)


def stack_least_seconds(frames: float, calls: float, c: int, layers: int) -> float:
    """The least time for the stacks' work: the larger of its FLOPs at the bf16
    tensor-core peak and its bytes at HBM's bandwidth (over all the calls
    together, which is no more than the sum of the calls' own bounds)."""
    return max(stack_tc_flops(frames, c, layers) / work.PEAKS["bf16"],
               stack_bytes(frames, calls, c, layers) / work.HBM_BYTES_PER_S)

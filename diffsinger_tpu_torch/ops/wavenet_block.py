"""K4: the WaveNet's residual blocks, at inference.

The blocks of ``models/backbones/wavenet.py``: the dilated conv of x plus the
step's projection d, the hoisted conditioner projection, the gate, the 1x1
output projection, the residual and the skip sum. The CUDA kernels are in
``csrc/wavenet_block.cu`` (its header note gives the bounds and the designs):
kernel A, the conv and the gate, and kernel B, the output projection, the
residual, the skip sum and the next block's conv input, two launches a
block. The JAX package computes the WaveNet as XLA ops, so K4 replaces no
TPU kernel.

:func:`wavenet_block_plain` is the stock block's math (stock PyTorch ops),
which ``ResidualBlock`` runs; :func:`residual_stack_plain` runs it block
after block. :func:`residual_stack` is the wrapper: the plain version on a
CPU tensor, the kernels on a CUDA tensor, or it raises. The dtype of x picks
the kernels (:func:`on_tensor_cores`):

- float32: products in float32 FMAs on the CUDA cores (no TF32) and the
  stock block's elementwise arithmetic; only the order of the sums differs.
- bfloat16: products on the tensor cores from bfloat16 operands with float32
  sums; x + d and the gate's output z are rounded to bfloat16, as the stock
  bfloat16 blocks round them, while the residual stream x and the skip sum
  stay in float32 across the blocks (the stock blocks round both at every
  block). :func:`residual_stack_bf16_plain` is that arithmetic in plain
  PyTorch. The skip sum is returned in bfloat16.

Weights use the torch layouts: ``diff_ws`` [C, C] (``diffusion_projection``),
``conv_ws`` [2C, C, 3] (``dilated_conv``), ``out_ws`` [2C, C, 1]
(``output_projection``); the kernels' copies (float32 and k-major [3C, 2C],
[C, 2C]; or bfloat16 [2C, 3C], [2C, C] with k contiguous, and float32 biases)
are made once and kept while the weights are unchanged.

For ``torch.export`` the stack is also the operator ``ds::wavenet_stack``
(``residual_stack_op``), one graph node whose card implementation is
:func:`residual_stack` and whose CPU implementation is the plain version.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from diffsinger_tpu_torch.ops import native

# kernel launches in this process (two a block)
launches = 0

# the CUDA division of a float32 tensor by a Python scalar multiplies by the
# scalar's float32 reciprocal: the stock block's (x + residual) / sqrt(2)
INV_SQRT2 = (torch.tensor(1.0) / torch.tensor(math.sqrt(2.0))).item()

_kept = WeakIdKeyDictionary()


def kept(owner: torch.Tensor, sources: Sequence[torch.Tensor], make: Callable):
    """``make()``, made again only when one of ``sources`` has new storage or
    was written in place since; kept as long as ``owner`` lives."""
    key = tuple((t.data_ptr(), t._version) for t in sources)
    hit = _kept.get(owner)
    if hit is None or hit[0] != key:
        hit = (key, make())
        _kept[owner] = hit
    return hit[1]


def step_projections(step: torch.Tensor, weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every block's ``diffusion_projection`` of the step embedding in one
    float32 product: step [B, C], L weights [C, C] and biases [C] -> [B, L, C]."""
    w, b = kept(weights[0], (*weights, *biases),
                lambda: (torch.cat(list(weights)).float(), torch.cat(list(biases)).float()))
    return F.linear(step.float(), w, b).view(step.shape[0], len(weights), -1)


def wavenet_block_plain(x, d, cond_proj, conv_w, conv_b, out_w, out_b,
                        dilation: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stock block: x [B, T, C], d [B, C] (the step's projection),
    cond_proj [B, T, 2C] -> (residual output [B, T, C], skip [B, T, C])."""
    y = x + d[:, None, :]
    y = F.conv1d(y.transpose(1, 2), conv_w, conv_b, padding=dilation,
                 dilation=dilation).transpose(1, 2)
    gate, filt = (y + cond_proj).chunk(2, dim=-1)
    y = F.linear(torch.sigmoid(gate) * torch.tanh(filt), out_w[:, :, 0], out_b)
    residual, skip = y.chunk(2, dim=-1)
    return (x + residual) / math.sqrt(2.0), skip


def residual_stack_plain(x, step, cond_proj, diff_ws, diff_bs, conv_ws, conv_bs, out_ws,
                         out_bs, dilations) -> torch.Tensor:
    """The stock blocks one after another: x [B, T, C], step [B, C] (the step
    embedding), cond_proj [L, B, T, 2C] -> the sum of the blocks' skips
    [B, T, C]."""
    skip_sum = torch.zeros_like(x)
    for i, dilation in enumerate(dilations):
        x, skip = wavenet_block_plain(x, F.linear(step, diff_ws[i], diff_bs[i]), cond_proj[i],
                                      conv_ws[i], conv_bs[i], out_ws[i], out_bs[i], dilation)
        skip_sum = skip_sum + skip
    return skip_sum


def residual_stack_bf16_plain(x, step, cond_proj, diff_ws, diff_bs, conv_ws, conv_bs, out_ws,
                              out_bs, dilations) -> torch.Tensor:
    """The bfloat16 kernels' arithmetic in plain PyTorch: the float32 blocks
    on the bfloat16 values, with x + d and z rounded to bfloat16 where the
    kernels round them and x and the skip sum kept in float32. Returns the
    skip sum in bfloat16. (On the card, under ``utils.no_tf32``.)"""
    bf16 = torch.bfloat16
    x = x.float()
    d = step_projections(step, diff_ws, diff_bs)
    skip_sum = torch.zeros_like(x)
    for i, dilation in enumerate(dilations):
        y = (x + d[:, i, None, :]).to(bf16).float()
        y = F.conv1d(y.transpose(1, 2), conv_ws[i].float(), conv_bs[i].float(),
                     padding=dilation, dilation=dilation).transpose(1, 2)
        gate, filt = (y + cond_proj[i].float()).chunk(2, dim=-1)
        z = (torch.sigmoid(gate) * torch.tanh(filt)).to(bf16).float()
        residual, skip = F.linear(z, out_ws[i][:, :, 0].float(), out_bs[i].float()).chunk(2, -1)
        x = (x + residual) * INV_SQRT2
        skip_sum = skip_sum + skip
    return skip_sum.to(bf16)


def on_tensor_cores(x: torch.Tensor) -> bool:
    """Whether the kernels for x are the tensor cores' (bfloat16) rather than
    the float32 CUDA cores'."""
    return x.dtype == torch.bfloat16


def _check_weights(x, conv_ws, conv_bs, out_ws, out_bs):
    c = x.shape[-1]
    like = dict(device=x.device, dtype=x.dtype)
    for ws, shape in ((conv_ws, (2 * c, c, 3)), (out_ws, (2 * c, c, 1)),
                      (conv_bs, (2 * c,)), (out_bs, (2 * c,))):
        for w in ws:
            native.require(w, "weight", shape=shape, **like)


def _kernel_weights(x, conv_ws, conv_bs, out_ws, out_bs):
    """The float32 kernels' weights, checked, k-major: [3C, 2C] (row tap * C +
    ci) and [C, 2C], and the biases [2C]."""
    _check_weights(x, conv_ws, conv_bs, out_ws, out_bs)
    c = x.shape[-1]
    return ([w.permute(2, 1, 0).reshape(3 * c, 2 * c).contiguous() for w in conv_ws],
            [w[:, :, 0].t().contiguous() for w in out_ws],
            [w.contiguous() for w in conv_bs], [w.contiguous() for w in out_bs])


def _tc_weights(x, conv_ws, conv_bs, out_ws, out_bs):
    """The bfloat16 kernels' weights, checked, k contiguous: [2C, 3C] (row n:
    tap * C + ci) and [2C, C], and the biases in float32 [2C]."""
    _check_weights(x, conv_ws, conv_bs, out_ws, out_bs)
    c = x.shape[-1]
    return ([w.permute(0, 2, 1).reshape(2 * c, 3 * c).contiguous() for w in conv_ws],
            [w[:, :, 0].contiguous() for w in out_ws],
            [w.float().contiguous() for w in conv_bs], [w.float().contiguous() for w in out_bs])


def residual_stack(x, step, cond_proj, diff_ws, diff_bs, conv_ws, conv_bs, out_ws, out_bs,
                   dilations) -> torch.Tensor:
    """The skip sum as :func:`residual_stack_plain` computes it. On a CPU
    tensor this is the plain version; on a CUDA tensor it launches two
    kernels a block or raises: float32, or bfloat16 on the tensor cores
    (:func:`residual_stack_bf16_plain`'s arithmetic), C a multiple of 64,
    contiguous inputs."""
    if x.device.type == "cpu":
        return residual_stack_plain(x, step, cond_proj, diff_ws, diff_bs, conv_ws, conv_bs,
                                    out_ws, out_bs, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch_stack(x, step, cond_proj, diff_ws, diff_bs, conv_ws, conv_bs, out_ws,
                         out_bs, dilations)


def _launch_stack(x, step, cond_proj, diff_ws, diff_bs, conv_ws, conv_bs, out_ws, out_bs,
                  dilations) -> torch.Tensor:
    """The kernels' route for x's dtype, after the checks both routes share."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K4 takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, C], not of shape {tuple(x.shape)}")
    b, t, c = x.shape
    n = len(dilations)
    if c % 64:
        raise ValueError(f"channels ({c}) must be a multiple of 64")
    if not 1 <= b <= 65535 or t < 1 or n < 1 or min(dilations) < 1:
        raise ValueError(f"no kernel for x of shape {tuple(x.shape)}, dilations {dilations}")
    if not len(diff_ws) == len(diff_bs) == len(conv_ws) == len(conv_bs) == len(out_ws) \
            == len(out_bs) == n:
        raise ValueError(f"{n} dilations need {n} weights and biases of each kind")
    like = dict(device=x.device, dtype=x.dtype)
    native.require(x, "x", shape=(b, t, c), **like)
    native.require(step, "step", shape=(b, c), **like)
    native.require(cond_proj, "cond_proj", shape=(n, b, t, 2 * c), **like)
    for w, bias in zip(diff_ws, diff_bs):
        native.require(w, "diffusion weight", shape=(c, c), **like)
        native.require(bias, "diffusion bias", shape=(c,), **like)
    weights = (conv_ws, conv_bs, out_ws, out_bs)
    tc = on_tensor_cores(x)
    w_conv, w_out, b_conv, b_out = kept(
        conv_ws[0], tuple(w for ws in weights for w in ws),
        lambda: (_tc_weights if tc else _kernel_weights)(x, *weights))
    d = step_projections(step, diff_ws, diff_bs)
    stream = native.stream_ptr(x)
    lib = native.load("wavenet_block")
    skip_sum = torch.empty(b, t, c, device=x.device)
    if tc:
        # x and the skip sum in float32, updated in place by kernel B; z and
        # x + d in bfloat16 (kernel B writes the next x + d over the one
        # kernel A has read)
        z = torch.empty_like(x)
        x = x.float()
        xd = (x + d[:, 0, None, :]).to(torch.bfloat16)
        for i, dilation in enumerate(dilations):
            native.check(lib.ds_wavenet_conv_gate_bf16(
                xd.data_ptr(), w_conv[i].data_ptr(), b_conv[i].data_ptr(),
                cond_proj[i].data_ptr(), z.data_ptr(), b, t, c, dilation, stream),
                "wavenet conv_gate_bf16")
            last = i == n - 1
            native.check(lib.ds_wavenet_out_skip_bf16(
                z.data_ptr(), w_out[i].data_ptr(), b_out[i].data_ptr(), x.data_ptr(),
                x.data_ptr(), skip_sum.data_ptr(), int(i == 0), INV_SQRT2,
                None if last else d[:, i + 1].data_ptr(), None if last else xd.data_ptr(),
                n * c, b, t, c, stream), "wavenet out_skip_bf16")
    else:
        z = torch.empty_like(x)
        xs = (torch.empty_like(z), torch.empty_like(z))  # the blocks' outputs, in turns
        xds = (torch.empty_like(z), torch.empty_like(z))  # x + d of the next block, in turns
        xd = x + d[:, 0, None, :]
        for i, dilation in enumerate(dilations):
            native.check(lib.ds_wavenet_conv_gate(
                xd.data_ptr(), w_conv[i].data_ptr(), b_conv[i].data_ptr(),
                cond_proj[i].data_ptr(), z.data_ptr(), b, t, c, dilation, stream),
                "wavenet conv_gate")
            last = i == n - 1
            out, xd = xs[i % 2], None if last else xds[i % 2]
            native.check(lib.ds_wavenet_out_skip(
                z.data_ptr(), w_out[i].data_ptr(), b_out[i].data_ptr(), x.data_ptr(),
                out.data_ptr(), skip_sum.data_ptr(), int(i == 0), INV_SQRT2,
                None if last else d[:, i + 1].data_ptr(), None if last else xd.data_ptr(),
                n * c, b, t, c, stream), "wavenet out_skip")
            x = out
    global launches
    launches += 2 * n
    return skip_sum.to(like["dtype"])


# K4 as one graph node that torch.export keeps whole (see lynx_fused.py)
_lib = torch.library.Library("ds", "FRAGMENT")
_lib.define("wavenet_stack(Tensor x, Tensor step, Tensor cond_proj, Tensor[] diff_ws, "
            "Tensor[] diff_bs, Tensor[] conv_ws, Tensor[] conv_bs, Tensor[] out_ws, "
            "Tensor[] out_bs, int[] dilations) -> Tensor")
_lib.impl("wavenet_stack", residual_stack, "CUDA")
_lib.impl("wavenet_stack", residual_stack_plain, "CPU")


@torch.library.register_fake("ds::wavenet_stack", lib=_lib)
def _(x, *args):
    return torch.empty_like(x)


residual_stack_op = torch.ops.ds.wavenet_stack.default

"""K1: 'same'-padded depthwise 1-D conv + optional bias + per-channel PReLU.

Counterpart of diffsinger_tpu/ops/depthwise_conv.py. The CUDA kernel is
``csrc/depthwise_conv.cu`` (its header note gives the bound and the design: a
tile kernel with the taps in registers for the kernel sizes of the shipped
configs, a generic kernel for any other size or width);
:func:`depthwise_conv1d_prelu_plain` is its plain PyTorch version with the same
arithmetic: taps accumulated in float32 in tap order, then the bias, then
PReLU, stored in the input dtype.

Weights use the torch layout: ``w`` is the depthwise Conv1d weight
``[C, 1, k]`` with its singleton axis dropped, ``[C, k]``.

For ``torch.export`` K1 is also the operator ``ds::depthwise_conv1d_prelu``
(``depthwise_conv1d_prelu_op``): the kernel on the card, the plain version on
the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from diffsinger_tpu_torch.ops import native

# launches of the CUDA kernel in this process; tests and chip_smoke.py reset it
launches = 0

# kernel sizes the tile kernel is built for (configs/acoustic.yaml: LYNXNet 31,
# ConvNeXt 7); any other size runs the generic kernel
TILE_K = (7, 31)
# output rows per tile that the tile kernel is built for, largest first
TILE_ROWS = (128, 64)
TILE_CHANNELS = 64
# four blocks share an SM: a grid of this many fills the card's 132 SMs once
MIN_BLOCKS = 4 * 132


def choose_tile(b: int, t: int, c: int, k: int) -> Tuple[int, int]:
    """(rows per tile, tiles per block) for x [b, t, c] with k taps; rows 0 =
    the generic kernel.

    The tile kernel takes k in ``TILE_K`` and c % 8 == 0 (16-byte copies). A
    block walks ``span`` consecutive tiles of one sequence and one 64-channel
    column with the next tile's copy in flight, so the longest span is the
    best one that still leaves a block for every slot of the card: each
    column is cut into as few blocks as make the grid reach ``MIN_BLOCKS``.
    The 128-row tile re-reads the fewest halo rows; 64 rows are for sequences
    that short.
    """
    if k not in TILE_K or c % 8:
        return 0, 1
    rows = TILE_ROWS[0] if t > TILE_ROWS[1] else TILE_ROWS[1]
    tiles = -(-t // rows)
    columns = -(-c // TILE_CHANNELS) * b
    per_column = max(1, min(tiles, -(-MIN_BLOCKS // columns)))
    return rows, -(-tiles // per_column)


def depthwise_conv1d_prelu_plain(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
                                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K1. x [B, T, C], w [C, k], alpha [C], bias [C] or None."""
    k = w.shape[1]
    pad_l = k // 2
    t = x.shape[1]
    xp = F.pad(x.float(), (0, 0, pad_l, k - 1 - pad_l))
    wf = w.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(k):
        acc = acc + xp[:, j:j + t, :] * wf[:, j]
    if bias is not None:
        acc = acc + bias.float()
    acc = torch.where(acc >= 0, acc, alpha.float() * acc)
    return acc.to(x.dtype)


def depthwise_conv1d_prelu(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
                           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """'same' depthwise conv over x [B, T, C] with taps w [C, k], then PReLU.

    Pads ``(k // 2, k - 1 - k // 2)``. On a CPU tensor this is the plain
    version; on a CUDA tensor it launches the kernel or raises.
    """
    if x.device.type == "cpu":
        return depthwise_conv1d_prelu_plain(x, w, alpha, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    b, t, c = x.shape
    k = w.shape[-1]
    like = dict(device=x.device, dtype=x.dtype)
    native.require(x, "x", shape=(b, t, c), **like)
    native.require(w, "w", shape=(c, k), **like)
    native.require(alpha, "alpha", shape=(c,), **like)
    if bias is not None:
        native.require(bias, "bias", shape=(c,), **like)
    if not 1 <= k <= 61:
        raise ValueError(f"kernel size {k} outside 1..61")
    if not 1 <= b <= 65535 or t < 1 or c < 1:
        raise ValueError(f"no kernel for x of shape {tuple(x.shape)}")
    out = torch.empty_like(x)
    rows, span = choose_tile(b, t, c, k)
    lib = native.load("depthwise_conv")
    rc = lib.ds_dwconv_prelu(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        alpha.data_ptr(), out.data_ptr(), b, t, c, k, native.dtype_code(x.dtype),
        rows, span, native.stream_ptr(x))
    native.check(rc, "depthwise_conv1d_prelu")
    global launches
    launches += 1
    return out


# K1 as one graph node that torch.export keeps whole (see lynx_fused.py)
_lib = torch.library.Library("ds", "FRAGMENT")
_lib.define("depthwise_conv1d_prelu(Tensor x, Tensor w, Tensor alpha, Tensor? bias=None) -> Tensor")
_lib.impl("depthwise_conv1d_prelu", depthwise_conv1d_prelu, "CUDA")
_lib.impl("depthwise_conv1d_prelu", depthwise_conv1d_prelu_plain, "CPU")


@torch.library.register_fake("ds::depthwise_conv1d_prelu", lib=_lib)
def _(x, w, alpha, bias=None):
    return torch.empty_like(x)


depthwise_conv1d_prelu_op = torch.ops.ds.depthwise_conv1d_prelu.default

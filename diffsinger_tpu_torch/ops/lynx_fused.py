"""K2: the LYNXNet conv module forward without its residual,
LN -> pw1 (C -> 2I) -> SwiGLU -> depthwise k-tap conv + bias -> PReLU -> pw2.

Counterpart of diffsinger_tpu/ops/lynx_fused.py. The CUDA kernels are in
``csrc/lynx_fused.cu`` (its header note gives the bound and the design): LN
statistics, pw1 with an LN prologue and a bias + SwiGLU epilogue, K1 for the
depthwise stage, pw2 with a bias epilogue. In bfloat16 the two products run
on the tensor cores (TMA loads, ``wgmma``); in float32 on the CUDA cores. :func:`fused_conv_module_plain` is
the plain PyTorch version with the same arithmetic: LN statistics in float32,
products of compute-dtype operands accumulated in float32, the normalised x,
the SwiGLU output and the PReLU output rounded to the compute dtype (the dtype
of x) where the kernel stores them.

Weights use the torch layouts (see :func:`conv_module_params_from_module`):
w1 [2I, C] (value rows first, gate rows second), dw_w [I, k], w2 [C, I].

In training K2 runs inside :class:`FusedConvModuleFn`. The JAX package has no
backward kernel for K2 (its trainer runs LYNXNet as XLA ops), so neither has
the port: the forward launches K2 and keeps its input, and the backward
recomputes the module in stock PyTorch ops (:func:`conv_module_stock`) and
differentiates them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diffsinger_tpu_torch.ops import native
from diffsinger_tpu_torch.ops.depthwise_conv import (
    depthwise_conv1d_prelu, depthwise_conv1d_prelu_plain,
)

LN_EPS = 1e-5

# launches of the fused module in this process (one per call on CUDA)
launches = 0


def fused_conv_module_plain(x, ln_scale, ln_bias, w1, b1, dw_w, dw_b, alpha, w2, b2):
    """Plain version of K2: x [B, T, C] -> [B, T, C]."""
    inner = dw_w.shape[0]
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + LN_EPS) * ln_scale.float()
          + ln_bias.float()).to(x.dtype)
    h = xn.float() @ w1.float().t() + b1.float()
    value, gate = h[..., :inner], h[..., inner:]
    s = (value * (gate * torch.sigmoid(gate))).to(x.dtype)
    z = depthwise_conv1d_prelu_plain(s, dw_w, alpha, dw_b)
    return (z.float() @ w2.float().t() + b2.float()).to(x.dtype)


def fused_conv_module(x, ln_scale, ln_bias, w1, b1, dw_w, dw_b, alpha, w2, b2):
    """LYNXConvModule forward, residual not added: x [B, T, C] -> [B, T, C].

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    the kernels or raises. Every parameter has the dtype of x (float32 or
    bfloat16); C and I must be multiples of 32.
    """
    if x.device.type == "cpu":
        return fused_conv_module_plain(x, ln_scale, ln_bias, w1, b1, dw_w, dw_b, alpha, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    b, t, c = x.shape
    inner, k = dw_w.shape
    if c % 32 or inner % 32:
        raise ValueError(f"channels ({c}) and inner width ({inner}) must be multiples of 32")
    like = dict(device=x.device, dtype=x.dtype)
    native.require(x, "x", shape=(b, t, c), **like)
    native.require(ln_scale, "ln_scale", shape=(c,), **like)
    native.require(ln_bias, "ln_bias", shape=(c,), **like)
    native.require(w1, "w1", shape=(2 * inner, c), **like)
    native.require(b1, "b1", shape=(2 * inner,), **like)
    native.require(w2, "w2", shape=(c, inner), **like)
    native.require(b2, "b2", shape=(c,), **like)
    m = b * t
    code = native.dtype_code(x.dtype)
    stream = native.stream_ptr(x)
    lib = native.load("lynx_fused")
    mean = torch.empty(m, device=x.device, dtype=torch.float32)
    rstd = torch.empty(m, device=x.device, dtype=torch.float32)
    native.check(lib.ds_lynx_ln_stats(x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                      m, c, LN_EPS, code, stream), "lynx ln_stats")
    s = torch.empty((b, t, inner), **like)
    native.check(lib.ds_lynx_pw1_swiglu(
        x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), s.data_ptr(),
        m, c, inner, code, stream), "lynx pw1_swiglu")
    z = depthwise_conv1d_prelu(s, dw_w, alpha, dw_b)
    y = torch.empty_like(x)
    native.check(lib.ds_lynx_pw2(z.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
                                 m, inner, c, code, stream), "lynx pw2")
    global launches
    launches += 1
    return y


PARAM_NAMES = ("ln_scale", "ln_bias", "w1", "b1", "dw_w", "dw_b", "alpha", "w2", "b2")


def conv_module_stock(x, ln_scale, ln_bias, w1, b1, dw_w, dw_b, alpha, w2, b2):
    """The conv module in stock PyTorch ops, for K2's backward to differentiate.

    LayerNorm with float32 statistics, pw1 and pw2 as matmuls, SwiGLU,
    ``F.conv1d(groups=I)`` for the taps and ``F.prelu``, all in x's dtype (on
    the card's tensor cores in bf16). In float32 it computes K2's function with
    K2's arithmetic up to the order of sums; in bf16 it rounds the pw1 output
    to bf16 before SwiGLU, where K2's epilogue keeps it in float32.
    """
    inner, k = dw_w.shape
    xn = F.layer_norm(x.float(), x.shape[-1:], ln_scale.float(), ln_bias.float(),
                      LN_EPS).to(x.dtype)
    value, gate = F.linear(xn, w1, b1).chunk(2, dim=-1)
    s = (value * F.silu(gate)).transpose(1, 2)  # [B, I, T]
    z = F.conv1d(F.pad(s, (k // 2, k - 1 - k // 2)), dw_w[:, None, :], dw_b, groups=inner)
    return F.linear(F.prelu(z, alpha).transpose(1, 2), w2, b2)


class FusedConvModuleFn(torch.autograd.Function):
    """K2 under autograd. Forward: :func:`fused_conv_module` (the kernels on a
    CUDA tensor), saving only its inputs. Backward: recompute the module with
    :func:`conv_module_stock` and backpropagate through it. Every input has
    the dtype the module computes in; :func:`fused_conv_module_train` casts."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, *params):
        ctx.save_for_backward(x, *params)
        return fused_conv_module(x, *params)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (x, *params)]
            y = conv_module_stock(*inputs)
        return torch.autograd.grad(y, inputs, dy)


def fused_conv_module_train(x, **params):
    """The conv module where gradients are wanted: K2 forward, stock backward.

    Under autocast the module computes in autocast's dtype, else in x's: x,
    the two weights and every other parameter are cast to it (as the
    inference path passes them to K2 in a model of that dtype), and the casts
    carry the gradients back to the float32 parameters.
    """
    dev = x.device.type
    dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype
    args = [t.to(dtype).contiguous() for t in (x, *(params[n] for n in PARAM_NAMES))]
    return FusedConvModuleFn.apply(*args)


def conv_module_params_from_module(module) -> dict:
    """The kernel's arguments from a port ``LYNXConvModule`` (activation PReLU).

    Counterpart of ``conv_module_params_from_flax``, in the torch layouts:
    ``net.0`` LayerNorm, ``net.2`` pw1 [2I, C, 1], ``net.4`` depthwise
    [I, 1, k], ``net.5`` PReLU, ``net.6`` pw2 [C, I, 1]. The tensors are views
    of the parameters, so no copy is made.
    """
    net = module.net
    return dict(
        ln_scale=net[0].weight, ln_bias=net[0].bias,
        w1=net[2].weight[:, :, 0], b1=net[2].bias,
        dw_w=net[4].weight[:, 0, :], dw_b=net[4].bias,
        alpha=net[5].weight,
        w2=net[6].weight[:, :, 0], b2=net[6].bias,
    )

"""K2: the LYNXNet conv module forward without its residual,
LN -> pw1 (C -> 2I) -> SwiGLU -> depthwise k-tap conv + bias -> activation -> pw2.

Counterpart of diffsinger_tpu/ops/lynx_fused.py. The CUDA kernels are in
``csrc/lynx_fused.cu`` (its header note gives the bound and the design): LN
statistics, pw1 with an LN prologue and a bias + SwiGLU epilogue, K1 for the
depthwise stage, pw2 with a bias epilogue. In bfloat16 the two products run
on the tensor cores (TMA loads, ``wgmma``); in float32 on the CUDA cores. :func:`fused_conv_module_plain` is
the plain PyTorch version with the same arithmetic: LN statistics in float32,
products of compute-dtype operands accumulated in float32, the normalised x,
the SwiGLU output and the activation's output rounded to the compute dtype
(the dtype of x) where the kernel stores them. The activation is LYNXNet's:
PReLU (slopes ``alpha``), SiLU or ReLU (``alpha`` None); K1's epilogue applies
it, so it is the last argument of every function here, PReLU by default.

Weights use the torch layouts (see :func:`conv_module_params_from_module`):
w1 [2I, C] (value rows first, gate rows second), dw_w [I, k], w2 [C, I].

In training K2 runs inside :class:`FusedConvModuleFn`. The JAX package has no
backward kernel for K2 (its trainer runs LYNXNet as XLA ops), so neither has
the port: the forward launches K2 and keeps its input, and the backward
recomputes the module in stock PyTorch ops (:func:`conv_module_stock`) and
differentiates them.

For ``torch.export`` K2 is also the operator ``ds::fused_conv_module``
(``fused_conv_module_op``), one graph node whose card implementation is
:func:`fused_conv_module` and whose CPU implementation is the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diffsinger_tpu_torch.ops import native
from diffsinger_tpu_torch.utils import tracing
from diffsinger_tpu_torch.ops.depthwise_conv import (
    depthwise_conv1d_prelu, depthwise_conv1d_prelu_plain,
)

LN_EPS = 1e-5

# launches of the fused module in this process (one per call on CUDA)
launches = 0


def fused_conv_module_plain(x, ln_scale, ln_bias, w1, b1, dw_w, dw_b, alpha, w2, b2,
                            activation="PReLU"):
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
    z = depthwise_conv1d_prelu_plain(s, dw_w, alpha, dw_b, activation)
    return (z.float() @ w2.float().t() + b2.float()).to(x.dtype)


def fused_conv_module(x, ln_scale, ln_bias, w1, b1, dw_w, dw_b, alpha, w2, b2,
                      activation="PReLU"):
    """LYNXConvModule forward, residual not added: x [B, T, C] -> [B, T, C].

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    the kernels or raises. Every parameter has the dtype of x (float32 or
    bfloat16); C and I must be multiples of 32.
    """
    if x.device.type == "cpu":
        return fused_conv_module_plain(x, ln_scale, ln_bias, w1, b1, dw_w, dw_b, alpha, w2, b2,
                                       activation)
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
    z = depthwise_conv1d_prelu(s, dw_w, alpha, dw_b, activation)
    y = torch.empty_like(x)
    native.check(lib.ds_lynx_pw2(z.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
                                 m, inner, c, code, stream), "lynx pw2")
    global launches
    launches += 1
    return y


PARAM_NAMES = ("ln_scale", "ln_bias", "w1", "b1", "dw_w", "dw_b", "alpha", "w2", "b2")


def conv_module_stock(x, ln_scale, ln_bias, w1, b1, dw_w, dw_b, alpha, w2, b2,
                      activation="PReLU"):
    """The conv module in stock PyTorch ops, for K2's backward to differentiate.

    LayerNorm with float32 statistics, pw1 and pw2 as matmuls, SwiGLU,
    ``F.conv1d(groups=I)`` for the taps and ``F.prelu`` (``F.silu``,
    ``F.relu``), all in x's dtype (on
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
    if activation == "PReLU":
        z = F.prelu(z, alpha)
    elif activation == "SiLU":
        z = F.silu(z)
    else:
        z = F.relu(z)
    return F.linear(z.transpose(1, 2), w2, b2)


class FusedConvModuleFn(torch.autograd.Function):
    """K2 under autograd. Forward: the operator ``ds::fused_conv_module``
    (:func:`fused_conv_module`, the kernels on a CUDA tensor), saving only its
    inputs. Backward: recompute the module with :func:`conv_module_stock` and
    backpropagate through it. Every input has the dtype the module computes
    in; :func:`fused_conv_module_train` casts. Without PReLU, ``alpha`` is
    None and has no gradient. Through the operator the forward is one op to a
    selective recomputation's policy (``models.commons.REMAT_SAVED_OPS``),
    which recomputes it, whatever runs inside."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, activation, x, *params):
        ctx.activation = activation
        ctx.save_for_backward(x, *params)
        return fused_conv_module_op(x, *params, activation=activation)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        with tracing.span("ds.lynx.bwd"):
            with torch.enable_grad():
                inputs = [None if t is None else t.detach().requires_grad_()
                          for t in (x, *params)]
                y = conv_module_stock(*inputs, activation=ctx.activation)
            wanted = [t for t in inputs if t is not None]
            grads = iter(torch.autograd.grad(y, wanted, dy))
            return (None, *(None if t is None else next(grads) for t in inputs))


def fused_conv_module_train(x, activation="PReLU", **params):
    """The conv module where gradients are wanted: K2 forward, stock backward.

    Under autocast the module computes in autocast's dtype, else in x's: x,
    the two weights and every other parameter are cast to it (as the
    inference path passes them to K2 in a model of that dtype), and the casts
    carry the gradients back to the float32 parameters.
    """
    dev = x.device.type
    dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype
    args = [None if t is None else t.to(dtype).contiguous()
            for t in (x, *(params[n] for n in PARAM_NAMES))]
    return FusedConvModuleFn.apply(activation, *args)


def conv_module_params_from_module(module) -> dict:
    """The kernel's arguments from a port ``LYNXConvModule``.

    Counterpart of ``conv_module_params_from_flax``, in the torch layouts:
    ``net.0`` LayerNorm, ``net.2`` pw1 [2I, C, 1], ``net.4`` depthwise
    [I, 1, k], ``net.5`` the activation (PReLU's slopes, else None),
    ``net.6`` pw2 [C, I, 1]. The tensors are views of the parameters, so no
    copy is made. The activation's name is ``module.activation``.
    """
    net = module.net
    return dict(
        ln_scale=net[0].weight, ln_bias=net[0].bias,
        w1=net[2].weight[:, :, 0], b1=net[2].bias,
        dw_w=net[4].weight[:, 0, :], dw_b=net[4].bias,
        alpha=net[5].weight if module.activation == "PReLU" else None,
        w2=net[6].weight[:, :, 0], b2=net[6].bias,
    )


# K2 as one graph node that torch.export keeps whole, so that an exported
# program launches the kernels on the card; the CPU runs the plain version.
# Registered through torch.library.Library and not torch.library.custom_op,
# whose Python wrappers (an alias check and a dynamo guard around every call)
# made an exported request host-bound at twice the eager time on the card.
_lib = torch.library.Library("ds", "FRAGMENT")
_lib.define("fused_conv_module(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor w1, Tensor b1, "
            "Tensor dw_w, Tensor dw_b, Tensor? alpha, Tensor w2, Tensor b2, "
            "str activation='PReLU') -> Tensor")
_lib.impl("fused_conv_module", fused_conv_module, "CUDA")
_lib.impl("fused_conv_module", fused_conv_module_plain, "CPU")


@torch.library.register_fake("ds::fused_conv_module", lib=_lib)
def _(x, *params, activation="PReLU"):
    return torch.empty_like(x)


fused_conv_module_op = torch.ops.ds.fused_conv_module.default

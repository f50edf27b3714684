"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA card with ``nvcc`` (sm_90a) and skip elsewhere. On a
machine without JAX, skip tests/conftest.py (it sets JAX up):
``python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest``. Each
wrapper must launch its kernel (its launch counter moves) and agree with the
plain version: float32 within 1e-4 (summation order), bf16 within one or two
bf16 ulps of the largest output.
"""

import pytest
import torch

from diffsinger_tpu_torch.ops import depthwise_conv, flash_attention, lynx_fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype,k,t", [(torch.float32, 31, 100), (torch.bfloat16, 7, 64)])
def test_k1_kernel(dev, dtype, k, t):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, t, 96, generator=g, device=dev).to(dtype)
    w = (0.2 * torch.randn(96, k, generator=g, device=dev)).to(dtype)
    alpha = torch.full((96,), 0.25, device=dev, dtype=dtype)
    bias = (0.1 * torch.randn(96, generator=g, device=dev)).to(dtype)
    n = depthwise_conv.launches
    got = depthwise_conv.depthwise_conv1d_prelu(x, w, alpha, bias)
    assert depthwise_conv.launches == n + 1
    want = depthwise_conv.depthwise_conv1d_prelu_plain(x, w, alpha, bias)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7 * want.float().abs().max().item()
    assert _max_err(got, want) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_kernel(dev, dtype):
    from diffsinger_tpu_torch.models.backbones.lynxnet import LYNXConvModule

    torch.manual_seed(0)
    mod = LYNXConvModule(64, 2, 31).to(dev, dtype)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.1 * torch.randn_like(p))
    x = torch.randn(3, 77, 64, device=dev).to(dtype)
    args = lynx_fused.conv_module_params_from_module(mod)
    n = lynx_fused.launches
    got = lynx_fused.fused_conv_module(x, **args)
    assert lynx_fused.launches == n + 1
    want = lynx_fused.fused_conv_module_plain(x, **args)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6 * want.float().abs().max().item()
    assert _max_err(got, want) <= tol


@pytest.mark.parametrize("d,length", [(128, 128), (64, 70)])
def test_k3_kernel(dev, d, length):
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(2, 2, length, d, generator=g, device=dev) for _ in range(3))
    pad = torch.zeros(2, length, dtype=torch.bool, device=dev)
    pad[1, length // 2:] = True
    n = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, pad)
    assert flash_attention.launches == n + 1
    assert _max_err(got, flash_attention.flash_attention_plain(q, k, v, pad)) <= 1e-4


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.randn(1, 8, 48, device=dev)  # C = 48 is not a multiple of 32
    mod_args = dict(ln_scale=torch.ones(48, device=dev), ln_bias=torch.zeros(48, device=dev),
                    w1=torch.zeros(192, 48, device=dev), b1=torch.zeros(192, device=dev),
                    dw_w=torch.zeros(96, 3, device=dev), dw_b=torch.zeros(96, device=dev),
                    alpha=torch.zeros(96, device=dev), w2=torch.zeros(48, 96, device=dev),
                    b2=torch.zeros(48, device=dev))
    with pytest.raises(ValueError):
        lynx_fused.fused_conv_module(x, **mod_args)
    with pytest.raises(TypeError):
        depthwise_conv.depthwise_conv1d_prelu(x.double(), torch.zeros(48, 3, device=dev).double(),
                                              torch.zeros(48, device=dev).double())
    q = torch.randn(1, 1, 8, 48, device=dev)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q, q)

"""Fast ODE solvers for DDPM sampling: DPM-Solver++ (2M) and UniPC (bh2)
(counterpart of diffsinger_tpu/core/fast_solvers.py).

The sampling grid (alpha_t, sigma_t, lambda_t, the model's input times and
UniPC's corrector coefficients) is computed on the host in float64 numpy as in
the JAX module; the middle steps' coefficients are rounded to float32 there
as the JAX module stacks them. The tensor arithmetic is float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diffsinger_tpu_torch.utils import tracing

from .ddpm import DenoiseFn
from .schedule import DiffusionSchedule


@dataclasses.dataclass(frozen=True)
class _Grid:
    """Per-gridpoint schedule values along the sampling trajectory."""

    t_input: np.ndarray  # model input times (discrete labels), [steps+1] float32
    lam: np.ndarray  # half-logSNR, [steps+1]
    alpha: np.ndarray  # [steps+1]
    sigma: np.ndarray  # [steps+1]


def _discrete_grid(sched: DiffusionSchedule, t_max: int, steps: int) -> _Grid:
    """The discrete VP noise schedule over betas[:t_max] and its time-uniform
    grid of ``steps`` steps, in float64 numpy."""
    betas = np.asarray(sched.betas[:t_max], dtype=np.float64)
    log_alphas = 0.5 * np.cumsum(np.log(1 - betas))
    # numerical clip of alpha: drop the tail where lambda < -5.1
    log_sigmas = 0.5 * np.log(1 - np.exp(2 * log_alphas))
    lambdas = log_alphas - log_sigmas
    idx = np.searchsorted(lambdas[::-1], -5.1)
    if idx > 0:
        log_alphas = log_alphas[:-idx]
    n = len(log_alphas)
    t_array = np.linspace(0.0, 1.0, n + 1)[1:]

    t_0, t_t = 1.0 / n, 1.0
    grid = np.linspace(t_t, t_0, steps + 1)
    # piecewise-linear interpolation of log_alpha over t
    la = np.interp(grid, t_array, log_alphas)
    sigma = np.sqrt(1.0 - np.exp(2.0 * la))
    lam = la - 0.5 * np.log(1.0 - np.exp(2.0 * la))
    t_input = (grid - 1.0 / n) * n
    return _Grid(t_input=t_input.astype(np.float32), lam=lam,
                 alpha=np.exp(la).astype(np.float64), sigma=sigma)


def _times(x: torch.Tensor, t_in) -> torch.Tensor:
    return torch.full((x.shape[0],), float(t_in), dtype=torch.float32, device=x.device)


def _data_pred(denoise_fn: DenoiseFn, x: torch.Tensor, t_in, alpha, sigma) -> torch.Tensor:
    """x0-prediction from a noise-prediction model: a step of its own."""
    with tracing.span("ds.sampler.step"):
        eps = denoise_fn(x, _times(x, t_in)).to(x.dtype)
        return (x - float(sigma) * eps) / float(alpha)


def sample_dpmpp_2m(denoise_fn: DenoiseFn, sched: DiffusionSchedule, x: torch.Tensor,
                    t_max: int, steps: int, lower_order_final: bool = True) -> torch.Tensor:
    """Multistep DPM-Solver++ of order 2; ``steps`` denoiser calls."""
    g = _discrete_grid(sched, t_max, steps)
    if steps == 1:
        m0 = _data_pred(denoise_fn, x, g.t_input[0], g.alpha[0], g.sigma[0])
        h = g.lam[1] - g.lam[0]
        return float(g.sigma[1] / g.sigma[0]) * x - float(g.alpha[1] * float(np.expm1(-h))) * m0

    # step 0: model eval at the start
    m_prev0 = _data_pred(denoise_fn, x, g.t_input[0], g.alpha[0], g.sigma[0])
    # step 1: first-order update, then eval
    h = g.lam[1] - g.lam[0]
    x = float(g.sigma[1] / g.sigma[0]) * x - float(g.alpha[1] * float(np.expm1(-h))) * m_prev0
    m_prev1, m_prev0 = m_prev0, _data_pred(denoise_fn, x, g.t_input[1], g.alpha[1], g.sigma[1])

    # middle steps 2..steps-1: second-order update + model eval, with the
    # per-step scalars in float32
    for i in range(2, steps):
        with tracing.span("ds.sampler.step"):
            h0 = g.lam[i - 1] - g.lam[i - 2]
            h = g.lam[i] - g.lam[i - 1]
            ratio, aphi, r0 = (float(v) for v in np.array(
                [g.sigma[i] / g.sigma[i - 1], g.alpha[i] * np.expm1(-h), h0 / h], np.float32))
            d1 = (m_prev0 - m_prev1) / r0
            x = ratio * x - aphi * m_prev0 - 0.5 * aphi * d1
            eps = denoise_fn(x, _times(x, g.t_input[i])).to(x.dtype)
            m_new = (x - float(np.float32(g.sigma[i])) * eps) / float(np.float32(g.alpha[i]))
            m_prev1, m_prev0 = m_prev0, m_new

    # final step: first order when steps < 10
    i = steps
    h = g.lam[i] - g.lam[i - 1]
    if lower_order_final and steps < 10:
        return float(g.sigma[i] / g.sigma[i - 1]) * x - float(
            g.alpha[i] * float(np.expm1(-h))) * m_prev0
    h0 = g.lam[i - 1] - g.lam[i - 2]
    r0 = h0 / h
    phi_1 = float(np.expm1(-h))
    d1 = (m_prev0 - m_prev1) / float(r0)
    return (float(g.sigma[i] / g.sigma[i - 1]) * x - float(g.alpha[i] * phi_1) * m_prev0
            - float(0.5 * g.alpha[i] * phi_1) * d1)


def _unipc_rhos_c2(h: float, rk0: float) -> tuple[float, float]:
    """Order-2 corrector coefficients rhos_c = solve(R, b) for bh2, with
    R = [[1, 1], [rk0, 1]], in float64."""
    hh = -h  # predict_x0
    h_phi_1 = np.expm1(hh)
    b_h = np.expm1(hh)
    h_phi_k = h_phi_1 / hh - 1
    b1 = h_phi_k * 1 / b_h
    factorial_i = 2
    h_phi_k = h_phi_k / hh - 1 / factorial_i
    b2 = h_phi_k * factorial_i / b_h
    rho0 = (b1 - b2) / (1.0 - rk0)
    rho1 = b1 - rho0
    return rho0, rho1


def sample_unipc_2(denoise_fn: DenoiseFn, sched: DiffusionSchedule, x: torch.Tensor,
                   t_max: int, steps: int, lower_order_final: bool = True) -> torch.Tensor:
    """Multistep UniPC of order 2, variant bh2, predicting x0; ``steps``
    denoiser calls."""
    g = _discrete_grid(sched, t_max, steps)

    def model(xv, i):
        return _data_pred(denoise_fn, xv, g.t_input[i], g.alpha[i], g.sigma[i])

    def order1_update(x, m_prev0, i, use_corrector):
        h = g.lam[i] - g.lam[i - 1]
        hh = -h
        h_phi_1 = float(np.expm1(hh))
        b_h = float(np.expm1(hh))
        ratio = g.sigma[i] / g.sigma[i - 1]
        x_t_ = float(ratio) * x - float(g.alpha[i] * h_phi_1) * m_prev0
        if not use_corrector:
            return x_t_, None
        m_t = model(x_t_, i)
        return x_t_ - float(g.alpha[i] * b_h) * (0.5 * (m_t - m_prev0)), m_t

    if steps == 1:
        m0 = model(x, 0)
        x, _ = order1_update(x, m0, 1, use_corrector=False)
        return x

    m_prev0 = model(x, 0)
    # init step: order 1 with corrector, whose model eval is reused
    x, m_t = order1_update(x, m_prev0, 1, use_corrector=True)
    m_prev1, m_prev0 = m_prev0, m_t

    # middle steps 2..steps-1: order-2 predictor + corrector, float32 scalars
    for i in range(2, steps):
        with tracing.span("ds.sampler.step"):
            h = g.lam[i] - g.lam[i - 1]
            rk0 = (g.lam[i - 2] - g.lam[i - 1]) / h
            h_phi_1 = np.expm1(-h)
            b_h = np.expm1(-h)
            c1, c2 = _unipc_rhos_c2(h, rk0)
            ratio, aphi, rk0_f, a_bh, c1, c2, t_in, alpha_i, sigma_i = (
                float(v) for v in np.array(
                    [g.sigma[i] / g.sigma[i - 1], g.alpha[i] * h_phi_1, rk0, g.alpha[i] * b_h,
                     c1, c2, g.t_input[i], g.alpha[i], g.sigma[i]], np.float32))
            d1_0 = (m_prev1 - m_prev0) / rk0_f
            x_t_ = ratio * x - aphi * m_prev0
            # predictor (rhos_p = [0.5] for order 2)
            x_t = x_t_ - a_bh * 0.5 * d1_0
            # corrector
            eps = denoise_fn(x_t, _times(x_t, t_in)).to(x.dtype)
            m_t = (x_t - sigma_i * eps) / alpha_i
            x = x_t_ - a_bh * (c1 * d1_0 + c2 * (m_t - m_prev0))
            m_prev1, m_prev0 = m_prev0, m_t

    # final step: order 1 (lower_order_final), no corrector
    if lower_order_final:
        x, _ = order1_update(x, m_prev0, steps, use_corrector=False)
        return x
    i = steps
    h = g.lam[i] - g.lam[i - 1]
    rk0 = (g.lam[i - 2] - g.lam[i - 1]) / h
    h_phi_1 = float(np.expm1(-h))
    b_h = float(np.expm1(-h))
    d1_0 = (m_prev1 - m_prev0) / float(rk0)
    return (float(g.sigma[i] / g.sigma[i - 1]) * x - float(g.alpha[i] * h_phi_1) * m_prev0
            - float(g.alpha[i] * b_h * 0.5) * d1_0)

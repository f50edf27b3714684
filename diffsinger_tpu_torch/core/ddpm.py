"""DDPM samplers: ancestral, DDIM and PLMS (PNDM), and the inference function
that dispatches to them or to the fast solvers
(counterpart of diffsinger_tpu/core/ddpm.py).

``denoise_fn(x, t) -> eps`` works on flat [B, T, D] tensors; ``t`` is an
int32 [B] tensor of discrete steps (the fast solvers pass float32 times).
The step loops are Python loops. Per-step scalars come from the float32
tables of :class:`DiffusionSchedule` and are combined in float32 numpy, as
the JAX scan combines them on the device; the denoiser's output is taken to
float32 before it meets them, so the update arithmetic is float32 under a
bf16 denoiser too. ``inference_dynamic`` (export) waits for its slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .schedule import DiffusionSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# step index (0 for the first step of the loop) -> the noise that step adds
StepNoiseFn = Callable[[int], torch.Tensor]


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(like.device)


def q_sample(sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward-process sample x_t; t [B] int."""
    c1 = _table(sched.sqrt_alphas_cumprod, x_start)[t.long()][:, None, None]
    c2 = _table(sched.sqrt_one_minus_alphas_cumprod, x_start)[t.long()][:, None, None]
    return c1 * x_start + c2 * noise


def p_losses_inputs(sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor, *,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Noisy input and its noise for the epsilon-prediction loss; t [B] int.
    ``noise`` is drawn from ``generator`` when not given. Returns (x_t, noise)."""
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator, device=x_start.device,
                            dtype=x_start.dtype)
    return q_sample(sched, x_start, t, noise), noise


def predict_start_from_noise(sched: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor,
                             noise: torch.Tensor) -> torch.Tensor:
    c1 = _table(sched.sqrt_recip_alphas_cumprod, x_t)[t.long()][:, None, None]
    c2 = _table(sched.sqrt_recipm1_alphas_cumprod, x_t)[t.long()][:, None, None]
    return c1 * x_t - c2 * noise


def _steps(b: int, t: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((b,), t, dtype=torch.int32, device=like.device)


def sample_ddpm(denoise_fn: DenoiseFn, sched: DiffusionSchedule, x: torch.Tensor, t_max: int, *,
                generator: Optional[torch.Generator] = None,
                noise_fn: Optional[StepNoiseFn] = None) -> torch.Tensor:
    """Ancestral sampling from t_max - 1 down to 0. Every step draws fresh
    noise from ``generator``; ``noise_fn(i)`` supplies step i's instead."""
    b = x.shape[0]
    c1, c2 = sched.posterior_mean_coef1, sched.posterior_mean_coef2
    log_var = sched.posterior_log_variance_clipped
    for i, t in enumerate(range(t_max - 1, -1, -1)):
        tb = _steps(b, t, x)
        eps = denoise_fn(x, tb).to(x.dtype)
        x0 = predict_start_from_noise(sched, x, tb, eps)
        mean = float(c1[t]) * x0 + float(c2[t]) * x
        if noise_fn is not None:
            noise = noise_fn(i).to(device=x.device, dtype=x.dtype)
        else:
            noise = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        scale = np.float32(t > 0) * np.exp(np.float32(0.5) * log_var[t])
        x = mean + float(scale) * noise
    return x


def _ddim_coefs(acp: np.ndarray, t: int, interval: int):
    """(sqrt(a_prev), sqrt(a_t), the eps coefficient) in float32; a_prev
    at t < interval is acp[0], not 1, as in the reference."""
    a_t = acp[t]
    a_prev = acp[max(t - interval, 0)]
    one = np.float32(1)
    eps_c = np.sqrt((one - a_prev) / a_prev) - np.sqrt((one - a_t) / a_t)
    return float(np.sqrt(a_prev)), float(np.sqrt(a_t)), float(eps_c)


def sample_ddim(denoise_fn: DenoiseFn, sched: DiffusionSchedule, x: torch.Tensor, t_max: int,
                interval: int) -> torch.Tensor:
    """DDIM (eta = 0) with a fixed stride, t = ((t_max - 1) // interval) * interval .. 0."""
    b = x.shape[0]
    acp = sched.alphas_cumprod
    for t in range((t_max - 1) // interval * interval, -1, -interval):
        sq_prev, sq_t, eps_c = _ddim_coefs(acp, t, interval)
        eps = denoise_fn(x, _steps(b, t, x)).to(x.dtype)
        x = sq_prev * (x / sq_t + eps_c * eps)
    return x


def sample_plms(denoise_fn: DenoiseFn, sched: DiffusionSchedule, x: torch.Tensor, t_max: int,
                interval: int) -> torch.Tensor:
    """PLMS / PNDM: linear multistep on the noise prediction with a history of
    three. The first step takes a second evaluation at its end point (the
    reference's warm-up), so ``n_steps + 1`` denoiser calls in all. The history
    stays in x's dtype (float32) under a bf16 denoiser."""
    b = x.shape[0]
    acp = sched.alphas_cumprod
    one = np.float32(1)

    def get_x_pred(x, noise_t, t):
        a_t = acp[t]
        a_prev = acp[max(t - interval, 0)]
        a_t_sq, a_prev_sq = np.sqrt(a_t), np.sqrt(a_prev)
        c_x = one / (a_t_sq * (a_t_sq + a_prev_sq))
        c_n = one / (a_t_sq * (np.sqrt((one - a_prev) * a_t) + np.sqrt((one - a_t) * a_prev)))
        x_delta = float(a_prev - a_t) * (float(c_x) * x - float(c_n) * noise_t)
        return x + x_delta

    n_steps = (t_max + interval - 1) // interval
    history = []  # newest first
    for t in range((n_steps - 1) * interval, -1, -interval):
        noise_pred = denoise_fn(x, _steps(b, t, x)).to(x.dtype)
        if not history:
            x_pred = get_x_pred(x, noise_pred, t)
            noise_prev = denoise_fn(x_pred, _steps(b, max(t - interval, 0), x)).to(x.dtype)
            noise_prime = (noise_pred + noise_prev) / 2
        elif len(history) == 1:
            noise_prime = (3 * noise_pred - history[0]) / 2
        elif len(history) == 2:
            noise_prime = (23 * noise_pred - 16 * history[0] + 5 * history[1]) / 12
        else:
            noise_prime = (55 * noise_pred - 59 * history[0] + 37 * history[1]
                           - 9 * history[2]) / 24
        x = get_x_pred(x, noise_prime, t)
        history = [noise_pred] + history[:2]
    return x


def inference(denoise_fn: DenoiseFn, sched: DiffusionSchedule, shape: tuple, *, k_step: int,
              depth: Optional[int], speedup: int, algorithm: str, device,
              generator: Optional[torch.Generator] = None,
              x_start: Optional[torch.Tensor] = None, use_shallow_diffusion: bool = False,
              noise: Optional[torch.Tensor] = None,
              noise_fn: Optional[StepNoiseFn] = None) -> torch.Tensor:
    """DDPM inference on flat [B, T, D] tensors of ``shape``.

    Starts from noise, or from the shallow source noised to ``t_max - 1``, and
    samples down to 0: DDIM, PLMS, DPM-Solver++ or UniPC when ``speedup`` > 1,
    else ancestral sampling. ``noise`` [shape] float32 replaces the first draw
    from ``generator`` and ``noise_fn`` the ancestral sampler's per-step draws.
    """
    timesteps = sched.timesteps
    depth = k_step if depth is None else depth
    t_max = min(depth, k_step) if use_shallow_diffusion else k_step

    if noise is None:
        noise = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    if t_max >= timesteps:
        x = noise
    elif t_max > 0:
        if x_start is None:
            raise ValueError("Missing shallow diffusion source.")
        x = q_sample(sched, x_start, _steps(x_start.shape[0], t_max - 1, x_start), noise)
    else:
        if x_start is None:
            raise ValueError("Missing shallow diffusion source.")
        return x_start

    if speedup > 1 and t_max > 0:
        if algorithm == "ddim":
            return sample_ddim(denoise_fn, sched, x, t_max, speedup)
        if algorithm in ("pndm", "plms"):  # the schema documents both spellings
            return sample_plms(denoise_fn, sched, x, t_max, speedup)
        if algorithm in ("dpm-solver", "unipc"):
            from .fast_solvers import sample_dpmpp_2m, sample_unipc_2

            fn = sample_dpmpp_2m if algorithm == "dpm-solver" else sample_unipc_2
            return fn(denoise_fn, sched, x, t_max, t_max // speedup)
        raise ValueError(f"Unsupported acceleration algorithm for DDPM: {algorithm}.")
    return sample_ddpm(denoise_fn, sched, x, t_max, generator=generator, noise_fn=noise_fn)

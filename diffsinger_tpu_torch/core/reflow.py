"""Rectified-flow training targets and ODE samplers: euler, rk2, rk4, rk5
(counterpart of diffsinger_tpu/core/reflow.py).

``velocity_fn(x, t_scaled) -> v`` works on flat [B, T, D] tensors; ``t_scaled``
is a float32 [B] tensor already multiplied by ``time_scale_factor``. The step
loop is a Python loop; the times are formed in float32 arithmetic in the same
order as the JAX scan (t = t_start + i * dt), so both packages feed the
denoiser the same step values. The deployment sampler ``inference_dynamic``
waits for the export slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

VelocityFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def p_losses_inputs(x_end: torch.Tensor, t: torch.Tensor, *,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
    """Interpolated state and target velocity for the training loss.

    x_end [B, T, D] normalised data; t [B] float in [t_start, 1]; ``noise``
    (the start x_start, drawn from ``generator`` when not given) has x_end's
    shape. Returns (x_t, v_gt = x_end - x_start).
    """
    x_start = noise if noise is not None else torch.randn(
        x_end.shape, generator=generator, device=x_end.device, dtype=x_end.dtype)
    x_t = x_start + t[:, None, None] * (x_end - x_start)
    return x_t, x_end - x_start


def _step_euler(velocity_fn, x, t, dt, tsf):
    return x + velocity_fn(x, tsf * t) * dt


def _step_rk2(velocity_fn, x, t, dt, tsf):
    k1 = velocity_fn(x, tsf * t)
    k2 = velocity_fn(x + 0.5 * k1 * dt, tsf * (t + 0.5 * dt))
    return x + k2 * dt


def _step_rk4(velocity_fn, x, t, dt, tsf):
    k1 = velocity_fn(x, tsf * t)
    k2 = velocity_fn(x + 0.5 * k1 * dt, tsf * (t + 0.5 * dt))
    k3 = velocity_fn(x + 0.5 * k2 * dt, tsf * (t + 0.5 * dt))
    k4 = velocity_fn(x + k3 * dt, tsf * (t + dt))
    return x + (k1 + 2 * k2 + 2 * k3 + k4) * dt / 6


def _step_rk5(velocity_fn, x, t, dt, tsf):
    k1 = velocity_fn(x, tsf * t)
    k2 = velocity_fn(x + 0.25 * k1 * dt, tsf * (t + 0.25 * dt))
    k3 = velocity_fn(x + 0.125 * (k2 + k1) * dt, tsf * (t + 0.25 * dt))
    k4 = velocity_fn(x + 0.5 * (-k2 + 2 * k3) * dt, tsf * (t + 0.5 * dt))
    k5 = velocity_fn(x + 0.0625 * (3 * k1 + 9 * k4) * dt, tsf * (t + 0.75 * dt))
    k6 = velocity_fn(
        x + (-3 * k1 + 2 * k2 + 12 * k3 - 12 * k4 + 8 * k5) * dt / 7, tsf * (t + dt)
    )
    return x + (7 * k1 + 32 * k3 + 12 * k4 + 32 * k5 + 7 * k6) * dt / 90


_STEPS = {"euler": _step_euler, "rk2": _step_rk2, "rk4": _step_rk4, "rk5": _step_rk5}


def sample_ode(velocity_fn: VelocityFn, x: torch.Tensor, *, t_start: float, steps: int,
               algorithm: str = "euler", time_scale_factor: float = 1000.0) -> torch.Tensor:
    """Integrate from t_start to 1 in ``steps`` fixed steps."""
    step_fn = _STEPS.get(algorithm)
    if step_fn is None:
        raise ValueError(f"Unsupported algorithm for Rectified Flow: {algorithm}.")
    b = x.shape[0]
    dt = (1.0 - t_start) / max(1, steps)
    for i in range(steps):
        t = torch.full((b,), float(i), dtype=torch.float32, device=x.device) * dt + t_start
        x = step_fn(velocity_fn, x, t, dt, time_scale_factor)
    return x


def inference(velocity_fn: VelocityFn, shape: tuple, *, t_start: float, steps: int,
              algorithm: str, time_scale_factor: float, device,
              generator: Optional[torch.Generator] = None, x_end: Optional[torch.Tensor] = None,
              use_shallow_diffusion: bool = False,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Start from noise, or from the shallow source blended with noise at
    t_start (t0 * x_end + (1 - t0) * noise), and integrate to t = 1.

    ``noise`` [shape] float32 replaces the draw from ``generator``, so two
    implementations can be fed the same noise.
    """
    if noise is None:
        noise = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    if use_shallow_diffusion and t_start > 0:
        if x_end is None:
            raise ValueError("Missing shallow diffusion source.")
        if t_start >= 1.0:
            return x_end
        x = t_start * x_end + (1 - t_start) * noise
    else:
        t_start = 0.0
        x = noise
    return sample_ode(velocity_fn, x, t_start=t_start, steps=steps, algorithm=algorithm,
                      time_scale_factor=time_scale_factor)

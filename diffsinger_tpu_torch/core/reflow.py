"""Rectified-flow training targets and ODE samplers: euler, rk2, rk4, rk5
(counterpart of diffsinger_tpu/core/reflow.py).

``velocity_fn(x, t_scaled) -> v`` works on flat [B, T, D] tensors; ``t_scaled``
is a float32 [B] tensor already multiplied by ``time_scale_factor``. The step
loop is a Python loop; the times are formed in float32 arithmetic in the same
order as the JAX scan (t = t_start + i * dt), so both packages feed the
denoiser the same step values. ``inference_dynamic`` is the deployment
sampler, with depth and steps as tensors (``deployment/``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from diffsinger_tpu_torch.utils import tracing, while_loop

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
        with tracing.span("ds.sampler.step"):
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


def inference_dynamic(velocity_fn: VelocityFn, noise: torch.Tensor, *, depth: torch.Tensor,
                      steps: torch.Tensor, t_start_min: float, time_scale_factor: float,
                      x_end: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The deployment sampler: euler steps with ``depth`` (float32 scalar) and
    ``steps`` (int scalar) as tensors, so that one exported program serves
    every depth and step count (counterpart of JAX ``reflow.inference_dynamic``).

    Without ``x_end`` the path starts from ``noise`` at t = 0. With it, t_start
    is ``max(1 - depth, t_start_min)`` and the start blends ``x_end`` and
    ``noise`` at t_start (clamped to [0, 1]: pure noise at or below 0, pure
    ``x_end`` at or above 1). Depth <= 0 (t_start >= 1) passes ``x_end``
    through without a step. ``depth`` and ``steps`` live on the host with the
    step counter and the per-step times; only x is on ``noise``'s device, so a
    step's test of the counter waits for nothing there.
    """
    depth = torch.as_tensor(depth, dtype=torch.float32)
    steps = torch.clamp(torch.as_tensor(steps, dtype=torch.int64), min=1)
    b = noise.shape[0]
    if x_end is None:
        t_start = torch.zeros((), dtype=torch.float32)
        x = noise
    else:
        t_start = torch.clamp(1.0 - depth, min=t_start_min)
        w = torch.clamp(t_start, 0.0, 1.0)  # exact at either end: 0 * a + b == b
        x = w * x_end + (1.0 - w) * noise
        steps = torch.where(t_start >= 1.0, torch.zeros_like(steps), steps)
    dt = (1.0 - t_start) / torch.clamp(steps, min=1).float()
    ones = noise.new_ones(b, dtype=torch.float32)

    def cond_fn(i, x):
        return i < steps

    def body_fn(i, x):
        t = t_start + i.float() * dt
        return i + 1, x + velocity_fn(x, ones * (time_scale_factor * t)) * dt

    _, x = while_loop(cond_fn, body_fn, (torch.zeros((), dtype=torch.int64), x))
    return x

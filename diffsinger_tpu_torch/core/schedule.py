"""Diffusion noise schedules and their coefficient tables
(counterpart of diffsinger_tpu/core/schedule.py).

The tables are computed in float64 numpy and kept as float32 numpy arrays,
as the JAX module keeps them; the samplers index them on the host and move
the scalars they need onto the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    # ends at 0.01 always: the reference never forwards max_beta
    return np.linspace(1e-4, 0.01, timesteps)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


BETA_SCHEDULES = {
    "linear": linear_beta_schedule,
    "cosine": cosine_beta_schedule,
}


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The q and posterior coefficient tables, float32 numpy, one entry per step."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def timesteps(self) -> int:
        return len(self.betas)

    @classmethod
    def create(cls, schedule_type: str = "linear", timesteps: int = 1000) -> "DiffusionSchedule":
        betas = np.asarray(BETA_SCHEDULES[schedule_type](timesteps), dtype=np.float64)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)

        def f32(a):
            return np.asarray(a, dtype=np.float32)

        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(acp),
            alphas_cumprod_prev=f32(acp_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        )

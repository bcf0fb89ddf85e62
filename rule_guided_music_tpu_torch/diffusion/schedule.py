"""Diffusion noise schedules and respacing, as precomputed tables.

Port of ``rule_guided_music_tpu/diffusion/schedule.py``: the tables are
computed on the host in float64 exactly as there, and :meth:`Schedule.tables`
ships float32 copies to one device as a :class:`Tables` of tensors, so DDPM,
DDIM and any respacing share one step function.

Behavioral parity references:
  - beta schedules: guided_diffusion/gaussian_diffusion.py:31-82
  - derived q/posterior tables: guided_diffusion/gaussian_diffusion.py:152-189
  - respacing: guided_diffusion/respace.py:7-128
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    """Named beta schedules (host-side float64)."""
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    if schedule_name == "stable-diffusion":
        scale = 1000 / num_diffusion_timesteps
        beta_start = scale * math.sqrt(0.00085)
        beta_end = scale * math.sqrt(0.012)
        return (
            np.linspace(beta_start, beta_end, num_diffusion_timesteps, dtype=np.float64)
            ** 2
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps, alpha_bar, max_beta=0.999) -> np.ndarray:
    """Discretize a continuous alpha-bar function into betas."""
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Choose a subset of original timesteps to retain: "ddimN" or
    comma-separated / list of per-section counts (respace.py:7-60)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    elif isinstance(section_counts, int):
        section_counts = [section_counts]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        if section_count <= 1:
            frac_stride = 1
        else:
            frac_stride = (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken_steps = []
        for _ in range(section_count):
            taken_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken_steps
        start_idx += size
    return set(all_steps)


@dataclasses.dataclass(frozen=True)
class Tables:
    """Float32 per-step constants on one device."""

    betas: torch.Tensor
    log_betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    model_t: torch.Tensor           # denoiser conditioning value per step

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


@dataclasses.dataclass(frozen=True)
class Schedule:
    """All per-step diffusion constants, host-side float64.

    ``timestep_map[t]`` maps a (possibly respaced) step index to the original
    chain's step index, which is what the denoiser is conditioned on.
    """

    betas: np.ndarray
    timestep_map: np.ndarray
    original_num_steps: int
    rescale_timesteps: bool = False

    alphas_cumprod: np.ndarray = None
    alphas_cumprod_prev: np.ndarray = None
    alphas_cumprod_next: np.ndarray = None
    sqrt_alphas_cumprod: np.ndarray = None
    sqrt_one_minus_alphas_cumprod: np.ndarray = None
    log_one_minus_alphas_cumprod: np.ndarray = None
    sqrt_recip_alphas_cumprod: np.ndarray = None
    sqrt_recipm1_alphas_cumprod: np.ndarray = None
    posterior_variance: np.ndarray = None
    posterior_log_variance_clipped: np.ndarray = None
    posterior_mean_coef1: np.ndarray = None
    posterior_mean_coef2: np.ndarray = None

    def __post_init__(self):
        betas = np.asarray(self.betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        alphas = 1.0 - betas
        acp = np.cumprod(alphas, axis=0)
        acp_prev = np.append(1.0, acp[:-1])
        acp_next = np.append(acp[1:], 0.0)
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)

        def _set(name, val):
            object.__setattr__(self, name, val)

        _set("betas", betas)
        _set("timestep_map", np.asarray(self.timestep_map, dtype=np.int32))
        _set("alphas_cumprod", acp)
        _set("alphas_cumprod_prev", acp_prev)
        _set("alphas_cumprod_next", acp_next)
        _set("sqrt_alphas_cumprod", np.sqrt(acp))
        _set("sqrt_one_minus_alphas_cumprod", np.sqrt(1.0 - acp))
        _set("log_one_minus_alphas_cumprod", np.log(1.0 - acp))
        _set("sqrt_recip_alphas_cumprod", np.sqrt(1.0 / acp))
        _set("sqrt_recipm1_alphas_cumprod", np.sqrt(1.0 / acp - 1.0))
        _set("posterior_variance", post_var)
        _set("posterior_log_variance_clipped",
             np.log(np.append(post_var[1], post_var[1:])))
        _set("posterior_mean_coef1", betas * np.sqrt(acp_prev) / (1.0 - acp))
        _set("posterior_mean_coef2",
             (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp))

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @property
    def fixed_large_variance(self) -> np.ndarray:
        """"Fixed large" variance [posterior_var[1], betas[1:]]
        (gaussian_diffusion.py:316-322)."""
        return np.append(self.posterior_variance[1], self.betas[1:])

    def model_t(self) -> np.ndarray:
        """Denoiser conditioning value of every step of this chain."""
        mapped = self.timestep_map.astype(np.float32)
        if self.rescale_timesteps:
            return mapped * np.float32(1000.0 / self.original_num_steps)
        return mapped

    def tables(self, device="cuda") -> Tables:
        """Float32 copies of every table on ``device``."""
        f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32),
                                        device=device)
        return Tables(
            betas=f32(self.betas),
            log_betas=f32(np.log(self.betas)),
            alphas_cumprod=f32(self.alphas_cumprod),
            alphas_cumprod_prev=f32(self.alphas_cumprod_prev),
            alphas_cumprod_next=f32(self.alphas_cumprod_next),
            sqrt_alphas_cumprod=f32(self.sqrt_alphas_cumprod),
            sqrt_one_minus_alphas_cumprod=f32(self.sqrt_one_minus_alphas_cumprod),
            log_one_minus_alphas_cumprod=f32(self.log_one_minus_alphas_cumprod),
            sqrt_recip_alphas_cumprod=f32(self.sqrt_recip_alphas_cumprod),
            sqrt_recipm1_alphas_cumprod=f32(self.sqrt_recipm1_alphas_cumprod),
            posterior_variance=f32(self.posterior_variance),
            posterior_log_variance_clipped=f32(self.posterior_log_variance_clipped),
            posterior_mean_coef1=f32(self.posterior_mean_coef1),
            posterior_mean_coef2=f32(self.posterior_mean_coef2),
            fixed_large_variance=f32(self.fixed_large_variance),
            fixed_large_log_variance=f32(np.log(self.fixed_large_variance)),
            model_t=f32(self.model_t()),
        )


def make_schedule(
    noise_schedule: str = "linear",
    steps: int = 1000,
    timestep_respacing="",
    rescale_timesteps: bool = False,
) -> Schedule:
    """Build a (possibly respaced) Schedule (script_util.py
    create_gaussian_diffusion + respace.SpacedDiffusion tables)."""
    betas = get_named_beta_schedule(noise_schedule, steps)
    if not timestep_respacing:
        timestep_respacing = [steps]
    use_timesteps = space_timesteps(steps, timestep_respacing)

    acp = np.cumprod(1.0 - betas)
    last_alpha_cumprod = 1.0
    new_betas, timestep_map = [], []
    for i, alpha_cumprod in enumerate(acp):
        if i in use_timesteps:
            new_betas.append(1 - alpha_cumprod / last_alpha_cumprod)
            last_alpha_cumprod = alpha_cumprod
            timestep_map.append(i)
    return Schedule(
        betas=np.array(new_betas, dtype=np.float64),
        timestep_map=np.array(timestep_map, dtype=np.int32),
        original_num_steps=steps,
        rescale_timesteps=rescale_timesteps,
    )

"""Diffusion schedulers of the unCLIP de-tokenizer: deterministic DDIM and the
DDPM ``add_noise`` of the image-embedding noiser (counterpart of
seed_tpu/models/unclip/schedulers.py).

The stable-diffusion-2-1-unclip checkpoint runs DDIM with v-prediction over a
scaled-linear beta schedule; the image embedding is noised with a
squaredcos_cap_v2 DDPM schedule. The tables are built on the host in numpy
float64, as seed_tpu builds them, and cast once (timesteps int32, alphas
float32) onto the device of the call, so a denoise loop indexes device
tensors and never waits on the host. ``step`` runs in fp32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ... import resolve_device


def make_betas(num_train_timesteps: int = 1000, schedule: str = "scaled_linear",
               beta_start: float = 0.00085, beta_end: float = 0.012) -> np.ndarray:
    if schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                           num_train_timesteps, dtype=np.float64) ** 2
    if schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float64)
    if schedule == "squaredcos_cap_v2":
        # Karlo/unCLIP cosine schedule
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        betas = []
        for i in range(num_train_timesteps):
            t1, t2 = i / num_train_timesteps, (i + 1) / num_train_timesteps
            betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), 0.999))
        return np.asarray(betas, dtype=np.float64)
    raise ValueError(schedule)


@dataclass(frozen=True)
class DDIMScheduler:
    """Deterministic DDIM (eta=0) supporting epsilon / v_prediction."""
    num_train_timesteps: int = 1000
    beta_schedule: str = "scaled_linear"
    beta_start: float = 0.00085
    beta_end: float = 0.012
    prediction_type: str = "v_prediction"
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    clip_sample: bool = False

    def alphas_cumprod(self) -> np.ndarray:
        betas = make_betas(self.num_train_timesteps, self.beta_schedule,
                           self.beta_start, self.beta_end)
        return np.cumprod(1.0 - betas)

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        # diffusers 'leading' spacing + steps_offset
        ratio = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * ratio).round()[::-1]
        return (ts + self.steps_offset).astype(np.int64)

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def make_tables(self, num_inference_steps: int, device="cuda"
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-inference-step (timestep int32, alpha_t fp32, alpha_prev fp32)
        tables on ``device``."""
        device = resolve_device(device)
        ac = self.alphas_cumprod()
        ts = self.timesteps(num_inference_steps)
        alpha_t = ac[ts]
        prev_ts = ts - self.num_train_timesteps // num_inference_steps
        final = 1.0 if self.set_alpha_to_one else float(ac[0])
        alpha_prev = np.where(prev_ts >= 0, ac[np.clip(prev_ts, 0, None)], final)
        return (torch.from_numpy(ts.astype(np.int32)).to(device),
                torch.from_numpy(alpha_t.astype(np.float32)).to(device),
                torch.from_numpy(alpha_prev.astype(np.float32)).to(device))

    def step(self, model_output: torch.Tensor, sample: torch.Tensor,
             alpha_t: torch.Tensor, alpha_prev: torch.Tensor) -> torch.Tensor:
        """One deterministic DDIM update x_t -> x_{t-1} (fp32)."""
        x = sample.float()
        eps_or_v = model_output.float()
        sqrt_a, sqrt_1ma = torch.sqrt(alpha_t), torch.sqrt(1.0 - alpha_t)
        if self.prediction_type == "v_prediction":
            # x0 = sqrt(a)*x - sqrt(1-a)*v ; eps = sqrt(a)*v + sqrt(1-a)*x
            x0 = sqrt_a * x - sqrt_1ma * eps_or_v
            eps = sqrt_a * eps_or_v + sqrt_1ma * x
        elif self.prediction_type == "epsilon":
            eps = eps_or_v
            x0 = (x - sqrt_1ma * eps) / sqrt_a
        else:
            raise ValueError(self.prediction_type)
        if self.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        return torch.sqrt(alpha_prev) * x0 + torch.sqrt(1.0 - alpha_prev) * eps


@dataclass(frozen=True)
class DDPMNoiser:
    """add_noise only — the image-embedding noising scheduler
    (StableUnCLIP image_noising_scheduler, squaredcos_cap_v2)."""
    num_train_timesteps: int = 1000
    beta_schedule: str = "squaredcos_cap_v2"

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        ac = np.cumprod(1.0 - make_betas(self.num_train_timesteps,
                                         self.beta_schedule))
        ac = torch.from_numpy(ac.astype(np.float32)).to(sample.device)
        a = ac[timesteps]
        while a.dim() < sample.dim():
            a = a[..., None]
        return (torch.sqrt(a) * sample.float()
                + torch.sqrt(1 - a) * noise.float()).to(sample.dtype)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings (diffusers get_timestep_embedding semantics),
    fp32 [B, dim]."""
    half = dim // 2
    dev = timesteps.device
    # a host float: a tensor made on the card here would be a blocking copy,
    # one host sync in every UNet pass of the denoise loop
    log_period = float(np.float32(np.log(np.float32(max_period))))
    exponent = -log_period * torch.arange(half, dtype=torch.float32, device=dev)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.exp(exponent)
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb

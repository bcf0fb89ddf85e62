"""What the three distill CLIs share (``distill_scoring_{decoder,features,
rollout}``): the ``--bf16`` flag, its autocast, Flax's default
initialisation of a random teacher or student, the training log, and the
npz the serving stack loads.

``--bf16`` (the JAX scripts' ``dtype=jnp.bfloat16`` modules: bf16
compute over float32 parameters) is ``torch.autocast`` in bf16 over
float32 modules, as the trainers run (``training/train_loop.py``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import convert, pipeline
from ..models.vae import AutoencoderKL

# Flax's truncated_normal divides by the std of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def str2bool(s: str) -> bool:
    """The JAX scripts' ``--bf16`` parser: anything but "false" is True."""
    return s.lower() != "false"


def autocast(device: torch.device, bf16: bool):
    """bf16 compute over float32 parameters where ``bf16``, else a no-op."""
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16)


@torch.no_grad()
def flax_init_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Flax's default initialisation, from a CPU generator seeded with
    ``seed`` (the same weights on every device): kernels lecun_normal
    (truncated at 2 std, variance 1 / fan_in), biases 0, norm scales 1.
    The JAX scripts' random teachers and students are Flax-initialised."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            std = (1.0 / p[0].numel()) ** 0.5 / _TRUNC_STD
            w = torch.nn.init.trunc_normal_(torch.empty(p.shape), 0.0, 1.0, -2.0,
                                            2.0, generator=gen)
            p.copy_(w * std)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    return module


class TrainLog:
    """Each step's host wall ms (the loss read back, so the device is
    done) and the losses printed every ``every`` steps."""

    def __init__(self, every: int):
        self.every = every
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.step_ms: List[float] = []
        self.logged: List[Tuple[int, float]] = []

    def step(self, i: int, loss: float, fmt: str) -> None:
        now = time.perf_counter()
        self.step_ms.append(1e3 * (now - self.last))
        self.last = now
        if i % self.every == 0:
            self.logged.append((i, loss))
            print(f"distill step {i}: {fmt} ({now - self.t0:.0f}s)", flush=True)


def teacher_vae(ch: int, vae_path: str):
    """The decoder distills' teacher: an ``AutoencoderKL`` decoder of width
    ``ch`` from ``vae_path``, else Flax-initialised from seed 1 (the JAX
    scripts' init key), float32 on the CPU."""
    teacher = flax_init_(AutoencoderKL(ch=ch), 1)
    if vae_path:
        pipeline.load_weights(teacher, vae_path, "vae")
        print(f"teacher: {vae_path}")
    else:
        print("teacher: random-init VAE (no --vae_path)")
    return teacher


def write_npz(path: str, module: torch.nn.Module, kind: str, agreement: float,
              save_dtype: str = "float32") -> Dict[str, np.ndarray]:
    """``module``'s Flax tree (``convert.flax_params``) beside the scalar
    ``agreement``, compressed: the file ``pipeline.ScoringBundle.create``
    and the JAX package's ``_load_scoring_npz`` read."""
    flat = convert.flax_params(module, kind)
    if save_dtype == "float16":
        flat = {k: v.astype(np.float16) for k, v in flat.items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, agreement=np.float32(agreement), **flat)
    print(f"wrote {path}")
    return flat


def softmax_targets(gen: torch.Generator, k: int, n: int, device) -> torch.Tensor:
    """(k, n) copies of softmax(2 N(0, 1)): a random pitch_hist target."""
    return torch.softmax(torch.randn(n, generator=gen, device=device) * 2.0,
                         dim=-1)[None].repeat(k, 1)


def uniform_targets(gen: torch.Generator, k: int, n: int, device) -> torch.Tensor:
    """(k, n) copies of U(1, 5): a random note_density target."""
    return (torch.rand(n, generator=gen, device=device) * 4.0 + 1.0)[None].repeat(k, 1)

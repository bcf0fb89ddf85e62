"""Seeded weights for the measured program and the reference alike.

The weights are inputs of the benchmark, so they come from the benchmark
and never from the program: every parameter, taken in the order of its
name, gets a slice of one standard-normal draw made on the module's
device by one ``torch.Generator`` seeded from the run's seed. The scheme
keeps activations O(1) through depth and makes every adaLN-Zero block a
real function: a weight of two or more dims is N(0, 1 / fan_in) (fan_in 1
for an embedding table), a norm's scale 1 + N(0, 0.1^2), anything else
N(0, 0.02^2). ``round_to`` rounds the values to the served dtype first, so
a bf16 program and an fp32 reference hold the same numbers.
"""

from __future__ import annotations

import torch


def _scaled(name: str, shape, noise: torch.Tensor) -> torch.Tensor:
    if len(shape) >= 2:
        fan_in = 1 if name.endswith("embedding_table.weight") else noise[0].numel()
        return noise / fan_in ** 0.5
    if "norm" in name and name.endswith("weight"):
        return 1.0 + 0.1 * noise
    return 0.02 * noise


@torch.no_grad()
def values(named_shapes, seed: int, device, round_to=None):
    """(name, value) of every parameter, in the order of the names, from
    one draw of ``seed``; ``named_shapes``: (name, shape) pairs."""
    items = sorted(named_shapes, key=lambda kv: kv[0])
    total = sum(int(torch.Size(shape).numel()) for _, shape in items)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    at = 0
    for name, shape in items:
        n = int(torch.Size(shape).numel())
        value = _scaled(name, shape, flat[at:at + n].view(shape))
        at += n
        yield name, (value.to(round_to) if round_to is not None else value)


@torch.no_grad()
def init_(module: torch.nn.Module, seed: int, round_to=None) -> torch.nn.Module:
    """Overwrite every parameter of ``module`` from ``seed``."""
    params = dict(module.named_parameters())
    device = next(iter(params.values())).device
    for name, value in values([(n, p.shape) for n, p in params.items()], seed, device, round_to):
        params[name].copy_(value)
    return module

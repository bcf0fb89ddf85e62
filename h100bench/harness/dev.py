"""Device calls that the CPU tests can reach: on a CUDA device they
synchronise and read the allocator's peak; on the CPU (tests of the
harness only, never a measurement) they do nothing and read 0."""

import torch


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def record(device, count: int = 1) -> dict:
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
            "count": count, "memory_peak_bytes": peak_bytes(device)}


def empty_cache(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()

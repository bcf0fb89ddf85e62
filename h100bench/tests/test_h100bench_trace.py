"""The trace arithmetic on hand-made intervals: the union of device
intervals, the attribution of kernels to the ranges around their launches,
the idle gaps named by the host's range, and the roofline and idle
shares."""

from types import SimpleNamespace

import pytest
import torch

from harness import peaks, readers, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, start, dur, device=CPU, corr=0, tid=1, annotation=False):
        self._n, self._s, self._d, self._dev = name, start, dur, device
        self._c, self._t, self._a = corr, tid, annotation

    def name(self): return self._n
    def start_ns(self): return self._s
    def duration_ns(self): return self._d
    def device_type(self): return self._dev
    def correlation_id(self): return self._c
    def linked_correlation_id(self): return 0
    def start_thread_id(self): return self._t
    def is_user_annotation(self): return self._a


def fake_prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_merge():
    assert trace.merge([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]


def test_summarize_attributes_kernels_and_gaps():
    ms = 1_000_000
    events = [
        Ev("dit.trajectory", 0, 10 * ms, annotation=True),
        Ev("attention", 2 * ms, 3 * ms, annotation=True),
        Ev("cudaLaunchKernel", 1 * ms, 1000, corr=1),          # in dit only
        Ev("cudaLaunchKernel", 3 * ms, 1000, corr=2),          # in attention
        Ev("cuLaunchKernelEx", 12 * ms, 1000, corr=3),         # in no range
        Ev("cudaLaunchKernel", 4 * ms, 1000, corr=4, tid=2),   # another thread
        Ev("gemm", 20 * ms, 4 * ms, CUDA, corr=1),
        Ev("flash", 24 * ms, 2 * ms, CUDA, corr=2),
        Ev("copy", 30 * ms, 1 * ms, CUDA, corr=3),
        Ev("bwd", 31 * ms, 1 * ms, CUDA, corr=4),
        Ev("lost", 40 * ms, 1 * ms, CUDA, corr=9),
    ]
    s = trace.summarize(fake_prof(events), window_s=0.05)
    assert s.kernels == 5 and s.unmatched == 1
    assert s.busy_s == pytest.approx(9e-3)                  # [20,26] + [30,32] + [40,41]
    assert s.layer_device_s["dit.trajectory"] == pytest.approx(6e-3)
    assert s.layer_device_s["attention"] == pytest.approx(2e-3)
    assert s.device_ops[0] == ["gemm", pytest.approx(4e-3)]
    # gaps [26,30] and [32,40] begin where the host is in no range
    assert dict(s.idle_gaps) == {"other": pytest.approx(12e-3)}


def test_roofline_idle_and_mfu():
    summary = trace.TraceSummary(window_s=2.0, busy_s=1.5,
                                 layer_device_s={"decoder": 0.5}, device_ops=[],
                                 idle_gaps=[], kernels=1, unmatched=0)
    work = {"flops": 0.25 * peaks.BF16_FLOPS, "bytes": 1.0}
    # two units traced; untraced, a unit took 1 s of the 2 s traced window
    ctx = SimpleNamespace(summary=summary, dtype="bfloat16", units=2, unit_s=1.0,
                          calls=[("decoder", work), ("decoder", work), ("attention", work)])
    assert readers.roofline(ctx, ["decoder"]) == pytest.approx(100.0)
    assert readers.roofline(ctx, ["attention"]) is None      # no device time read
    assert readers.idle(ctx) == pytest.approx(25.0)
    assert readers.mfu(ctx, ["decoder"]) == pytest.approx(25.0)
    slow = SimpleNamespace(**dict(vars(ctx), unit_s=1.5))     # 3 s untraced
    assert readers.idle(slow) == pytest.approx(50.0)
    assert readers.mfu(slow, ["decoder"]) == pytest.approx(50.0 / 3)


def test_least_time_takes_the_larger_bound():
    assert peaks.least_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_s(989e12, 6.7e12) == pytest.approx(2.0)

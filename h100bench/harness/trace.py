"""Layer ranges, work records and the reading of the profiler's trace.

The benchmark does not edit the program: it wraps the calls into each
layer in ``torch.profiler.record_function`` ranges from forward pre-hooks
and forward hooks on the program's module classes, and records each
call's shape for the work arithmetic of ``work/``. A kernel belongs to a
range when the host call that launched it (matched by CUPTI's correlation
id) lies inside the range on the same thread. Busy time is the union of
the device's kernel, copy and fill intervals; the idle gaps are named by
the innermost range the host was in when each began.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

LAUNCH = re.compile(r"^cu(da)?[A-Z]")


@dataclass
class Recorder:
    """Forward hooks that, while ``on``, open a named range around each
    call and record the call's work."""

    on: bool = False
    calls: List[tuple] = field(default_factory=list)
    _stack: List = field(default_factory=list)
    _handles: List = field(default_factory=list)

    def attach(self, modules, name_of: Callable, work_of: Optional[Callable] = None):
        """Hook every module in ``modules``: ``name_of(module, args)`` names
        the range, ``work_of(module, args)`` gives {flops, bytes}."""
        def pre(mod, args):
            if not self.on:
                return
            name = name_of(mod, args)
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            self._stack.append(rf)
            if work_of is not None:
                self.calls.append((name, work_of(mod, args)))

        def post(mod, args, out):
            if self.on:
                self._stack.pop().__exit__(None, None, None)

        for m in modules:
            self._handles.append(m.register_forward_pre_hook(pre))
            self._handles.append(m.register_forward_hook(post))

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.autograd.profiler.record_function(name)

    def detach(self):
        for h in self._handles:
            h.remove()
        self._handles.clear()


def merge(intervals):
    """Union of (start, end) intervals, sorted and merged."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _segments(ranges):
    """Nested (start, end, name) ranges of one thread -> sorted segments
    (start, end, names open there, innermost last)."""
    bounds = []
    for i, (s, e, n) in enumerate(ranges):
        bounds.append((s, 1, -e, i))
        bounds.append((e, 0, 0, i))
    bounds.sort()
    stack, segs, last = [], [], None
    for t, opening, _, i in bounds:
        if last is not None and t > last and stack:
            segs.append((last, t, tuple(ranges[j][2] for j in stack)))
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        last = t
    return segs


def _lookup(segs, starts, t):
    k = bisect.bisect_right(starts, t) - 1
    if k >= 0 and segs[k][0] <= t < segs[k][1]:
        return segs[k][2]
    return ()


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    layer_device_s: Dict[str, float]
    device_ops: List[list]
    idle_gaps: List[list]
    kernels: int
    unmatched: int


def summarize(prof, window_s: float, top: int = 10) -> TraceSummary:
    """Busy time, device seconds per layer range, the top device
    operations and the longest idle gaps by host range."""
    events = prof.profiler.kineto_results.events()
    device, launches, ranges = [], {}, defaultdict(list)
    for e in events:
        on_device = e.device_type() != torch.autograd.DeviceType.CPU
        if e.is_user_annotation():
            if not on_device:
                ranges[e.start_thread_id()].append(
                    (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif on_device:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                           e.correlation_id(), e.linked_correlation_id()))
        elif LAUNCH.match(e.name()):
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
    main = max(ranges, key=lambda tid: len(ranges[tid])) if ranges else None
    segs = _segments(ranges.get(main, []))
    starts = [s[0] for s in segs]
    per_layer, per_op = defaultdict(float), defaultdict(float)
    unmatched = 0
    for s, e, name, corr, linked in device:
        dur = (e - s) * 1e-9
        per_op[name] += dur
        launch = launches.get(corr) or launches.get(linked)
        if launch is None:
            unmatched += 1
            continue
        if launch[1] != main:
            continue
        for layer in set(_lookup(segs, starts, launch[0])):
            per_layer[layer] += dur
    busy = merge((s, e) for s, e, *_ in device)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        names = _lookup(segs, starts, e0)
        gaps[names[-1] if names else "other"] += (s1 - e0) * 1e-9
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    gap_list = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(window_s, busy_s, dict(per_layer),
                        [[n[:200], v] for n, v in ops],
                        [[n, v] for n, v in gap_list], len(device), unmatched)


def profile():
    """A profiler of host and device activity, without stacks or shapes."""
    from torch.profiler import ProfilerActivity
    return torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

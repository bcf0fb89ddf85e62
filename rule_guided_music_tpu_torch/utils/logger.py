"""Key-value experiment logger with stdout/log/csv/json/tensorboard sinks.

A copy of ``rule_guided_music_tpu/utils/logger.py`` (reference
guided_diffusion/logger.py, the OpenAI-baselines logger), which the
trainers write through: ``configure``, ``logkv``, ``logkv_mean``,
``logkvs``, ``dumpkvs``, ``log``, ``warn``, ``get_dir`` and ``profile_kv``,
the ``loggings/<dir>/`` run directory and the same file names
(``log.txt``, ``progress.csv``, ``progress.json``, ``tb/``). Under a
``torch.distributed`` group, rank 0 writes them and every other rank
writes its ``log-rankNNN.txt`` only, as JAX's process index decides. TensorBoard is imported where that format is asked for, and wandb
falls back to stdout where it is missing, as in the JAX package.
:func:`torch_trace` takes the place of ``jax_trace``: a
``torch.profiler`` trace of a block (one train step), written as a Chrome
trace, with the device's busy time and idle share over the block.
"""

from __future__ import annotations

import csv as csv_mod
import datetime
import json
import os
import os.path as osp
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

import torch.distributed as dist

DEBUG = 10
INFO = 20
WARN = 30
ERROR = 40
DISABLED = 50


class KVWriter:
    def writekvs(self, kvs):
        raise NotImplementedError


class SeqWriter:
    def writeseq(self, seq):
        raise NotImplementedError


class HumanOutputFormat(KVWriter, SeqWriter):
    def __init__(self, filename_or_file):
        if isinstance(filename_or_file, str):
            self.file = open(filename_or_file, "wt")
            self.own_file = True
        else:
            self.file = filename_or_file
            self.own_file = False

    def writekvs(self, kvs):
        key2str = {}
        for key, val in sorted(kvs.items()):
            valstr = f"{val:<8.3g}" if hasattr(val, "__float__") else str(val)
            key2str[self._truncate(key)] = self._truncate(valstr)
        if not key2str:
            return
        keywidth = max(map(len, key2str.keys()))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for key, val in sorted(key2str.items(), key=lambda kv: kv[0].lower()):
            lines.append(
                f"| {key}{' ' * (keywidth - len(key))} | "
                f"{val}{' ' * (valwidth - len(val))} |"
            )
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    @staticmethod
    def _truncate(s, maxlen=30):
        return s[: maxlen - 3] + "..." if len(s) > maxlen else s

    def writeseq(self, seq):
        self.file.write(" ".join(map(str, seq)) + "\n")
        self.file.flush()

    def close(self):
        if self.own_file:
            self.file.close()


class JSONOutputFormat(KVWriter):
    def __init__(self, filename):
        self.file = open(filename, "wt")

    def writekvs(self, kvs):
        out = {
            k: float(v) if hasattr(v, "dtype") or hasattr(v, "__float__") else v
            for k, v in kvs.items()
        }
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class CSVOutputFormat(KVWriter):
    def __init__(self, filename):
        self.filename = filename
        self.keys = []
        self.sep = ","
        # resume-append: adopt an existing header so a restarted run
        # extends the file instead of rewriting the header from scratch
        # (which would misalign/drop the prior run's columns)
        if os.path.exists(filename):
            with open(filename) as f:
                header = f.readline().strip()
            if header:
                self.keys = header.split(self.sep)
        open(filename, "a").close()

    def writekvs(self, kvs):
        extra_keys = sorted(set(kvs.keys()) - set(self.keys))
        if extra_keys:
            self.keys.extend(extra_keys)
            # rewrite the file with the extended header
            with open(self.filename, "r") as f:
                lines = f.readlines()
            with open(self.filename, "w") as f:
                f.write(self.sep.join(self.keys) + "\n")
                for line in lines[1:]:
                    f.write(line.rstrip("\n") + self.sep * len(extra_keys) + "\n")
        else:
            with open(self.filename, "r") as f:
                has_header = bool(f.readline().strip())
            if not has_header:
                with open(self.filename, "w") as f:
                    f.write(self.sep.join(self.keys) + "\n")
        with open(self.filename, "a") as f:
            f.write(
                self.sep.join(
                    "" if kvs.get(k) is None else str(kvs.get(k)) for k in self.keys
                )
                + "\n"
            )

    def close(self):
        pass


class TensorBoardOutputFormat(KVWriter):
    def __init__(self, logdir):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(logdir)
        self.step = 0

    def writekvs(self, kvs):
        step = int(kvs.get("step", self.step))
        for k, v in kvs.items():
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass
        self.step = step + 1
        self.writer.flush()

    def close(self):
        self.writer.close()


def make_output_format(fmt, ev_dir, log_suffix=""):
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(osp.join(ev_dir, f"log{log_suffix}.txt"))
    if fmt == "json":
        return JSONOutputFormat(osp.join(ev_dir, f"progress{log_suffix}.json"))
    if fmt == "csv":
        return CSVOutputFormat(osp.join(ev_dir, f"progress{log_suffix}.csv"))
    if fmt == "tensorboard":
        return TensorBoardOutputFormat(osp.join(ev_dir, f"tb{log_suffix}"))
    if fmt == "wandb":  # optional; degrade gracefully when not installed
        try:
            import wandb  # noqa: F401
        except ImportError:
            print("wandb not installed; falling back to stdout sink",
                  file=sys.stderr)
            return HumanOutputFormat(sys.stdout)
        return WandbOutputFormat(ev_dir)
    raise ValueError(f"Unknown format specified: {fmt}")


class WandbOutputFormat(KVWriter):
    """wandb sink (reference logger.py:193-230): one run per log dir, named
    after it; env WANDB_PROJECT / WANDB_RUN_NAME override the defaults."""

    def __init__(self, ev_dir):
        import wandb

        self._wandb = wandb
        if wandb.run is None:
            wandb.init(
                project=os.environ.get("WANDB_PROJECT",
                                       "rule-guided-music-tpu"),
                name=os.environ.get("WANDB_RUN_NAME",
                                    osp.basename(osp.normpath(ev_dir))),
                dir=ev_dir,
                config={"log_dir": ev_dir},
            )

    def writekvs(self, kvs):
        numeric = {}
        for k, v in kvs.items():
            try:
                numeric[k] = float(v)
            except (TypeError, ValueError):
                continue
        step = int(numeric.pop("step", 0)) or None
        self._wandb.log(numeric, step=step)

    def close(self):
        if self._wandb.run is not None:
            self._wandb.finish()


class Logger:
    DEFAULT = None
    CURRENT = None

    def __init__(self, dir, output_formats):
        self.name2val = defaultdict(float)
        self.name2cnt = defaultdict(int)
        self.level = INFO
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self):
        if self.level == DISABLED:
            return {}
        out = self.name2val.copy()
        for fmt in self.output_formats:
            if isinstance(fmt, KVWriter):
                fmt.writekvs(self.name2val)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    def log(self, *args, level=INFO):
        if self.level <= level:
            for fmt in self.output_formats:
                if isinstance(fmt, SeqWriter):
                    fmt.writeseq(map(str, args))

    def set_level(self, level):
        self.level = level

    def get_dir(self):
        return self.dir

    def close(self):
        for fmt in self.output_formats:
            fmt.close()


def configure(dir=None, format_strs=None, log_suffix="", args=None):
    """Create the run directory (``loggings/<args.dir>`` convention,
    logger.py:458-497) and install the global logger."""
    if dir is None and args is not None and getattr(args, "dir", ""):
        dir = osp.join("loggings", args.dir)
    if dir is None:
        dir = os.environ.get("OPENAI_LOGDIR")
    if dir is None:
        dir = osp.join(
            "loggings",
            datetime.datetime.now().strftime("openai-%Y-%m-%d-%H-%M-%S-%f"),
        )
    os.makedirs(os.path.expanduser(dir), exist_ok=True)

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    if format_strs is None:
        if rank == 0:
            format_strs = os.environ.get(
                "OPENAI_LOG_FORMAT", "stdout,log,csv"
            ).split(",")
        else:
            format_strs = os.environ.get("OPENAI_LOG_FORMAT_MPI", "log").split(",")
            log_suffix = log_suffix or f"-rank{rank:03d}"
    format_strs = [f for f in format_strs if f]
    output_formats = [make_output_format(f, dir, log_suffix) for f in format_strs]
    Logger.CURRENT = Logger(dir=dir, output_formats=output_formats)
    if output_formats:
        log(f"Logging to {dir}")
    return Logger.CURRENT


def get_current():
    if Logger.CURRENT is None:
        configure(dir="loggings/tmp", format_strs=["stdout"])
    return Logger.CURRENT


def logkv(key, val):
    get_current().logkv(key, val)


def logkv_mean(key, val):
    get_current().logkv_mean(key, val)


def logkvs(d):
    for k, v in d.items():
        logkv(k, v)


def dumpkvs():
    return get_current().dumpkvs()


def log(*args, level=INFO):
    get_current().log(*args, level=level)


def warn(*args):
    get_current().log(*args, level=WARN)


def get_dir():
    return get_current().get_dir()


@contextmanager
def profile_kv(scopename):
    """Accumulate wall time under wait_<scopename> (logger.py:309-333)."""
    logkey = "wait_" + scopename
    tstart = time.time()
    try:
        yield
    finally:
        get_current().name2val[logkey] += time.time() - tstart


class TraceSummary:
    """What :func:`torch_trace` read from its window: wall ms of the block
    (host clock, the device synchronized at both ends), ms in which at
    least one device kernel, copy or set ran (the union of their
    intervals), the idle share 1 - busy / wall, and the count of device
    events. ``events`` is 0 where the profiler saw no device activity."""

    def __init__(self):
        self.wall_ms = self.device_busy_ms = self.idle_share = float("nan")
        self.events = 0
        self.path = None


def _device_busy_ms(events) -> tuple:
    """(busy ms, count) over the device events of a profile: the union of
    their [start, end) intervals, so overlapping streams count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if str(getattr(e, "device_type", "")).endswith("CUDA"))
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3, len(spans)


@contextmanager
def torch_trace(log_dir=None):
    """Trace a block with ``torch.profiler`` (CPU, and CUDA where a card is
    present) and write it as a Chrome trace under ``<dir>/torch_trace``;
    yields a :class:`TraceSummary`, filled when the block ends and logged.
    A profiler that cannot start leaves the block untraced, with a log
    line, as ``jax_trace`` does."""
    import torch

    dir_ = log_dir or osp.join(get_dir() or ".", "torch_trace")
    summary = TraceSummary()
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # a profiler that cannot start: run untraced
        log(f"torch.profiler trace unavailable: {e}")
        prof = None
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        yield summary
    finally:
        if cuda:
            torch.cuda.synchronize()
        summary.wall_ms = 1e3 * (time.perf_counter() - t0)
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(dir_, exist_ok=True)
            summary.path = osp.join(dir_, "trace.json")
            prof.export_chrome_trace(summary.path)
            summary.device_busy_ms, summary.events = _device_busy_ms(prof.events())
            if summary.events:
                summary.idle_share = 1.0 - summary.device_busy_ms / summary.wall_ms
            log(f"torch trace written to {summary.path}: {summary.wall_ms:.3f} ms "
                f"wall, device busy {summary.device_busy_ms:.3f} ms over "
                f"{summary.events} device events, idle share "
                f"{summary.idle_share:.4f}")


def profile(n):
    def decorator_with_name(func):
        def func_wrapper(*args, **kwargs):
            with profile_kv(n):
                return func(*args, **kwargs)

        return func_wrapper

    return decorator_with_name

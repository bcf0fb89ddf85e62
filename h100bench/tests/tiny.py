"""Cells at fixture size, for the harness's CPU tests: the same files'
layout with narrow models and short chains."""

import copy
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from harness import common

BENCH = Path(__file__).resolve().parent.parent

TINY_DIT = {"model": "DiTRotary_XS_8", "hidden_size": 64, "depth": 2, "num_heads": 2}
TINY_VAE = {"ch": 32, "ch_mult": [1, 1, 2, 2], "num_res_blocks": 1}
TINY_CLS = {"model": "DiTRotary-XS/8-cls", "depth": 4}


def cell(name: str, limits=None) -> common.Cell:
    """The named cell of BENCHMARK.json with narrow models, batch 2, k=4
    and four-step chains (train: batch 8 of 2 rolls)."""
    c = common.load_cell(name)
    cfg, tr = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    cfg["dtype"] = "float32"
    cfg["denoiser"].update(TINY_DIT)
    cfg["vae"].update(TINY_VAE)
    for cls in cfg.get("classifiers", []):
        if not cls["chord"]:
            cls.update(TINY_CLS)
    if tr["driver"] == "sample_chain":
        tr["batch"] = 2
        if tr.get("scg"):
            tr["scg"]["num_samples"] = 4
        tr["timestep_respacing"] = "ddim4" if tr["sampler"] == "ddim" else "4"
        cfg["t_start"] = 3
    else:
        cfg["batch_size"] = 8
        tr.update(rolls=4, roll_columns=2700, trace_steps=2, untraced_steps=2)
    return common.Cell(name, cfg, tr, limits if limits is not None else c.limits,
                       c.end_to_end, c.per_layer, c.chips)


def ctx(cell, seed=7, seconds=0.0, trace_on=False):
    return SimpleNamespace(cell=cell, seed=seed, seconds=seconds, trace=trace_on,
                           device=torch.device("cpu"), t_start=time.perf_counter(),
                           clock=time.perf_counter, log=lambda m: None,
                           read_metrics=lambda **kw: {})

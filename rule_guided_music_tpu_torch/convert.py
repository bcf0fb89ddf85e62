"""JAX parameter trees -> the port's ``state_dict``s.

The JAX package stores parameters as Flax trees; ``utils/fixtures.
flatten_tree`` writes them as flat ``{'a/b/c': array}`` npz dicts (the
committed fixtures, ``pipeline.load_checkpoint_params`` npz files). These
functions rename such a dict to the port's module names, which are the
reference's torch names, and transpose the layouts:

  * Flax Dense kernel (in, out)          -> torch Linear weight (out, in)
  * Flax Conv kernel HWIO (kh, kw, i, o) -> torch Conv2d weight (o, i, kh, kw)
  * GroupNorm scale / bias               -> weight / bias
  * Embed table                          -> Embedding weight (unchanged)

This is the inverse of ``rule_guided_music_tpu/models/torch_port.py``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_DIT_RULES = [
    (r"^x_embedder/mlp(\d)", r"x_embedder.MLP.\1"),
    (r"^t_embedder/mlp(\d)", r"t_embedder.mlp.\1"),
    (r"^blocks_(\d+)/", r"blocks.\1/"),
    (r"adaLN_modulation/", r"adaLN_modulation.1/"),
]

_VAE_RULES = [
    (r"^decoder/up_(\d+)_block_(\d+)/", r"decoder.up.\1.block.\2/"),
    (r"^decoder/up_(\d+)_upsample/", r"decoder.up.\1.upsample/"),
    (r"^decoder/mid_(block_\d|attn_\d)/", r"decoder.mid.\1/"),
]


def _strip(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop a leading ``params/`` from every key."""
    out = {}
    for key, val in flat.items():
        if key.startswith("params/"):
            key = key[len("params/"):]
        out[key] = np.asarray(val)
    return out


def _leaf(path: str, val: np.ndarray):
    """Rename the leaf and transpose kernels to torch layout."""
    module, leaf = path.rsplit("/", 1)
    module = module.replace("/", ".")
    if leaf == "kernel":
        if val.ndim == 2:
            val = val.T
        elif val.ndim == 4:
            val = np.transpose(val, (3, 2, 0, 1))
        leaf = "weight"
    elif leaf in ("scale", "embedding_table"):
        if leaf == "embedding_table":
            module = f"{module}.embedding_table"
        leaf = "weight"
    return f"{module}.{leaf}", val


def _convert(flat: Dict[str, np.ndarray], rules) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, val in flat.items():
        for pattern, repl in rules:
            path = re.sub(pattern, repl, path)
        name, val = _leaf(path, val)
        sd[name] = torch.from_numpy(np.ascontiguousarray(val, dtype=np.float32))
    return sd


def dit_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat DiTRotary params (``x_embedder/mlp0/kernel``, ...) -> the port's
    ``DiTRotary`` state_dict."""
    return _convert(_strip(flat), _DIT_RULES)


def vae_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat AutoencoderKL params -> the port's decode-only ``AutoencoderKL``
    state_dict (the encoder and ``quant_conv`` are dropped)."""
    flat = {k: v for k, v in _strip(flat).items()
            if k.startswith("decoder/") or k.startswith("post_quant_conv/")}
    return _convert(flat, _VAE_RULES)

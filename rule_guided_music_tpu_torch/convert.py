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
The 2-D DiT's tree converts by the DiT rules (``x_embedder/proj`` is a
conv; its position table is computed, not a leaf); the UNet's module names
are the JAX tree's, so :func:`unet_state_dict` only renames leaves. The
int8 trunk is made from a loaded fp32 model by ``ops.quant.quantize_``.
The distill scripts' npz files (``assets/scoring_*_ch64.npz``) hold such a
flat tree under ``params/`` beside scalar metadata (``agreement``), which
``pipeline._load_scoring_npz`` sets apart.
"""

from __future__ import annotations

import math
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

_CLS_RULES = _DIT_RULES + [
    (r"^head/norm/", r"norm/"),
    (r"^head/fc([12])/", lambda m: f"classifier_head.{2 * int(m[1]) - 2}/"),
    (r"^head_key/norm/", r"norm_key/"),
    (r"^head_key/fc([12])/", lambda m: f"classifier_head_key.{2 * int(m[1]) - 2}/"),
]

_VAE_RULES = [
    (r"^decoder/up_(\d+)_block_(\d+)/", r"decoder.up.\1.block.\2/"),
    (r"^decoder/up_(\d+)_upsample/", r"decoder.up.\1.upsample/"),
    (r"^encoder/down_(\d+)_block_(\d+)/", r"encoder.down.\1.block.\2/"),
    (r"^encoder/down_(\d+)_downsample/", r"encoder.down.\1.downsample/"),
    (r"^(decoder|encoder)/mid_(block_\d|attn_\d)/", r"\1.mid.\2/"),
]


_UNET_RULES = [(r"/embedding$", "/weight")]     # nn.Embed -> nn.Embedding


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
    if "/" not in path:                     # a bare parameter (cls_token)
        return path, val
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
    """Flat DiTRotary or 2-D DiT params (``x_embedder/mlp0/kernel``,
    ``x_embedder/proj/kernel``, ...) -> the port's ``DiTRotary`` / ``DiT``
    state_dict."""
    return _convert(_strip(flat), _DIT_RULES)


def unet_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat UNetModel (or SuperResModel, under ``unet/``) params
    (``down_0_res_0/in_norm/scale``, ``mid_attn/qkv/kernel``,
    ``label_emb/embedding``, ...) -> the port's state_dict."""
    return _convert(_strip(flat), _UNET_RULES)


def classifier_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat DiTRotaryClassifier params (``cls_token``, ``head/fc1/kernel``,
    ``head_key/norm/scale``, ...) -> the port's ``DiTRotaryClassifier``
    state_dict: ``head`` becomes ``norm`` + ``classifier_head.{0,2}``,
    ``head_key`` becomes ``norm_key`` + ``classifier_head_key.{0,2}``; the
    trunk is renamed as in :func:`dit_state_dict`."""
    return _convert(_strip(flat), _CLS_RULES)


def vae_state_dict(flat: Mapping[str, np.ndarray],
                   encoder: bool = False) -> Dict[str, torch.Tensor]:
    """Flat AutoencoderKL params -> the port's ``AutoencoderKL`` state_dict:
    the decoder and ``post_quant_conv``, and with ``encoder`` also the
    encoder and ``quant_conv`` (``encoder.down.{i}.block.{j}.norm1``,
    ``encoder.down.{i}.downsample.conv``, ``quant_conv``, ...), which a
    decode-only module leaves out."""
    parts = ("decoder/", "post_quant_conv/")
    if encoder:
        parts += ("encoder/", "quant_conv/")
    flat = {k: v for k, v in _strip(flat).items() if k.startswith(parts)}
    return _convert(flat, _VAE_RULES)


def scoring_decoder_arch(flat: Mapping[str, np.ndarray]) -> Dict:
    """``ScoringDecoder`` geometry of a flat decoder tree: each level's
    width from its first block's ``conv1``, ``ch`` their greatest common
    divisor, ``num_res_blocks`` from level 0's blocks, ``z_channels`` and
    ``out_ch`` from ``conv_in`` and ``conv_out``. The state_dict itself is
    :func:`vae_state_dict`'s."""
    widths, blocks0 = {}, 0
    for key, val in flat.items():
        m = re.search(r"decoder/up_(\d+)_block_(\d+)/conv1/bias$", key)
        if m and m[2] == "0":
            widths[int(m[1])] = val.shape[0]
        blocks0 += bool(m) and m[1] == "0"
        if key.endswith("decoder/conv_in/kernel"):
            z_channels = val.shape[2]
        if key.endswith("decoder/conv_out/bias"):
            out_ch = val.shape[0]
    widths = [widths[i] for i in range(len(widths))]
    ch = math.gcd(*widths)
    return dict(ch=ch, ch_mult=tuple(w // ch for w in widths),
                num_res_blocks=blocks0 - 1, out_ch=out_ch, z_channels=z_channels)


def feature_head_arch(flat: Mapping[str, np.ndarray]) -> Dict:
    """``RuleFeatureHead`` geometry of a flat head tree: ``ch`` and
    ``in_channels`` from ``conv0``'s kernel, ``depth`` from the count of
    ``conv{i}`` layers, the chord vocabulary from ``chord_head``."""
    convs = {}
    for key, val in flat.items():
        m = re.search(r"(?:^|/)conv(\d+)/kernel$", key)
        if m:
            convs[int(m[1])] = val.shape
        if key.endswith("chord_head/bias"):
            n_chord_tags = val.shape[0]
    return dict(ch=convs[0][3], depth=len(convs), in_channels=convs[0][2],
                n_chord_tags=n_chord_tags)


def feature_head_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat RuleFeatureHead params (``params/conv0/kernel``,
    ``params/win_fc/kernel``, ...) -> the port's ``RuleFeatureHead``
    state_dict (``conv0.weight``, ``win_fc.weight``, ...)."""
    return _convert(_strip(flat), [])

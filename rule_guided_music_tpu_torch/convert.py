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
The VAE trainer's patch-GAN keeps the JAX module names, and LPIPS takes
torchvision's VGG16 indices and taming's head names.
The 2-D DiT's tree converts by the DiT rules (``x_embedder/proj`` is a
conv; its position table is computed, not a leaf), and ``DiTClassifier``'s
by the classifier rules; the module names of the UNet and of
``EncoderUNetModel`` are the JAX tree's, so :func:`unet_state_dict` and
:func:`encoder_unet_state_dict` only rename leaves. The
int8 trunk is made from a loaded fp32 model by ``ops.quant.quantize_``.
The distill scripts' npz files (``assets/scoring_*_ch64.npz``) hold such a
flat tree under ``params/`` beside scalar metadata (``agreement``), which
``pipeline._load_scoring_npz`` sets apart; :func:`flax_params` writes a
port module back into that tree (the distill CLIs' writer), through
:func:`flax_path`'s renaming.
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

# torch layout of a Flax kernel, by its rank: torch dim j is Flax dim PERM[j]
KERNEL_PERM = {2: (1, 0), 4: (3, 2, 0, 1)}

# the inverses of the module renames above (torch name -> Flax path)
_INVERSE = {
    "dit": [
        (r"^x_embedder\.MLP\.(\d)\.", r"x_embedder/mlp\1/"),
        (r"^t_embedder\.mlp\.(\d)\.", r"t_embedder/mlp\1/"),
        (r"^blocks\.(\d+)\.", r"blocks_\1/"),
        (r"adaLN_modulation\.1\.", r"adaLN_modulation/"),
    ],
    "vae": [
        (r"^decoder\.up\.(\d+)\.block\.(\d+)\.", r"decoder/up_\1_block_\2/"),
        (r"^decoder\.up\.(\d+)\.upsample\.", r"decoder/up_\1_upsample/"),
        (r"^encoder\.down\.(\d+)\.block\.(\d+)\.", r"encoder/down_\1_block_\2/"),
        (r"^encoder\.down\.(\d+)\.downsample\.", r"encoder/down_\1_downsample/"),
        (r"^(decoder|encoder)\.mid\.(block_\d|attn_\d)\.", r"\1/mid_\2/"),
    ],
    "unet": [],
    "head": [],
}
_FORWARD = {"dit": _DIT_RULES, "vae": _VAE_RULES, "unet": _UNET_RULES, "head": []}


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
        if val.ndim in KERNEL_PERM:
            val = np.transpose(val, KERNEL_PERM[val.ndim])
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


def flax_path(name: str, shape, kind: str = "dit", embedding: bool = False):
    """The Flax path of the port's parameter ``name`` (of torch ``shape``)
    and the permutation that carries it across: torch dim j is Flax dim
    ``perm[j]``. ``kind`` is "dit", "vae", "unet" or "head" (RuleFeatureHead:
    no renames); ``embedding`` marks an
    ``nn.Embedding`` weight. The inverse of :func:`_convert`'s renaming,
    checked against it: the path converts back to ``name``."""
    module, _, leaf = name.rpartition(".")
    module += "."
    for pattern, repl in _INVERSE[kind]:
        module = re.sub(pattern, repl, module)
    module = module.replace(".", "/").rstrip("/")
    perm = tuple(range(len(shape)))
    if leaf == "weight" and embedding:
        if module.endswith("/embedding_table"):
            module, leaf = module[:-len("/embedding_table")], "embedding_table"
        else:
            leaf = "embedding"
    elif leaf == "weight" and len(shape) == 1:
        leaf = "scale"
    elif leaf == "weight" and len(shape) in KERNEL_PERM:
        leaf, perm = "kernel", KERNEL_PERM[len(shape)]
    path = f"{module}/{leaf}" if module else leaf
    back = _convert({path: np.zeros((1,) * len(shape), np.float32)}, _FORWARD[kind])
    if list(back) != [name]:
        raise ValueError(f"no Flax path converts back to {name}: {path} gives "
                         f"{list(back)}")
    return path, perm


def flax_params(module: torch.nn.Module, kind: str) -> Dict[str, np.ndarray]:
    """The module's parameters as the JAX package's flat Flax tree,
    ``{"params/<flax path>": float32 array}`` in Flax layout, the keys
    ``utils/fixtures.flatten_tree`` writes for ``{"params": tree}``: the
    layout of the distill scripts' npz files. Each path and permutation is
    :func:`flax_path`'s, so the file converts back through this module's
    loaders (``kind`` as there)."""
    modules = dict(module.named_modules())
    out = {}
    for name, p in module.named_parameters():
        path, perm = flax_path(name, tuple(p.shape), kind,
                               isinstance(modules[name.rpartition(".")[0]],
                                          torch.nn.Embedding))
        val = p.detach().float().cpu().numpy()
        out[f"params/{path}"] = np.ascontiguousarray(
            np.transpose(val, np.argsort(perm)))
    return out


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
    """Flat DiTRotaryClassifier or DiTClassifier params (``cls_token``,
    ``head/fc1/kernel``, ``head_key/norm/scale``, ``x_embedder/proj/kernel``
    ...) -> the port's ``DiTRotaryClassifier`` / ``DiTClassifier``
    state_dict: ``head`` becomes ``norm`` + ``classifier_head.{0,2}``,
    ``head_key`` becomes ``norm_key`` + ``classifier_head_key.{0,2}``; the
    trunk is renamed as in :func:`dit_state_dict` (the 2-D table is
    computed, not a leaf)."""
    return _convert(_strip(flat), _CLS_RULES)


def encoder_unet_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat EncoderUNetModel params (``down_1_downsample/in_norm/scale``,
    ``mid_attn/qkv/kernel``, ``head/kernel``, ``chord_head/kernel``,
    ``key_head/kernel`` ...) -> the port's ``EncoderUNetModel`` state_dict:
    its module names are the JAX tree's, so leaves are renamed and
    kernels transposed only."""
    return _convert(_strip(flat), _UNET_RULES)


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


# torchvision's vgg16().features index of each conv{block}_{conv} of LPIPS
_VGG_INDEX = dict(zip(
    ["1_1", "1_2", "2_1", "2_2", "3_1", "3_2", "3_3", "4_1", "4_2", "4_3",
     "5_1", "5_2", "5_3"], [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]))

_LPIPS_RULES = [
    (r"^net/conv(\d_\d)/", lambda m: f"net.{_VGG_INDEX[m[1]]}/"),
    (r"^lin(\d)/", r"lin\1.model.1/"),
]


def discriminator_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat NLayerDiscriminator params (``conv0/kernel``, ``norm1/scale``,
    ``conv_out/bias``, ...) -> the port's ``NLayerDiscriminator``
    state_dict (same module names)."""
    return _convert(_strip(flat), [])


def lpips_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat LPIPS params (``net/conv1_1/kernel``, ``lin0/kernel``, ...) ->
    the port's ``LPIPS`` state_dict in torchvision's and taming's layout
    (``net.0.weight``, ``lin0.model.1.weight``): the inverse of JAX's
    ``convert_torch_lpips``."""
    return _convert(_strip(flat), _LPIPS_RULES)


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

"""Plain PyTorch reference of the models the benchmark runs.

A frozen, independent formulation of DiTRotary (the denoiser), the
rotary DiT classifiers of classifier guidance, and the KL-VAE f8 encoder
and decoder (taming-transformers' Encoder/Decoder, GroupNorm(32, 1e-6) +
swish). Attention is an einsum with an fp32 softmax, GroupNorm + swish is
``F.group_norm`` then ``F.silu``. Parameter names are the reference
repository's torch names, so the benchmark's seeded initializer, which
works by name, gives these modules and the measured program the same
weights.

Every linear and convolution goes through :class:`Lin` / :class:`Conv`,
and attention through :func:`attention`. With ``set_fp8(model, True)``
their inputs and weights are rounded to float8 e4m3 (one scale per
tensor) before an fp32 product: the control of the correctness check, the
reference computed one precision below the served bfloat16. Nothing here
imports the measured program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor, as fp32;
    the gradient passes straight through."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


class Lin(nn.Linear):
    fp8 = False

    def forward(self, x):
        if self.fp8:
            return F.linear(fake_fp8(x), fake_fp8(self.weight), self.bias)
        return F.linear(x, self.weight, self.bias)


class Conv(nn.Conv2d):
    fp8 = False

    def forward(self, x):
        w = fake_fp8(self.weight) if self.fp8 else self.weight
        x = fake_fp8(x) if self.fp8 else x
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


class _Attn(nn.Module):
    """Carries the fp8 flag for the attention products."""
    fp8 = False


def set_fp8(model: nn.Module, on: bool) -> nn.Module:
    for m in model.modules():
        if isinstance(m, (Lin, Conv, _Attn)):
            m.fp8 = on
    return model


def attention(q, k, v, fp8=False):
    """(B, N, H, D) softmax attention, scale D^-0.5, fp32 softmax."""
    if fp8:
        q, k, v = fake_fp8(q), fake_fp8(k), fake_fp8(v)
    logits = torch.einsum("bnhd,bmhd->bhnm", q * q.shape[-1] ** -0.5, k)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v)


# ---- DiT ----------------------------------------------------------------


def rotary_table(seq_len: int, rot_dim: int, device):
    freqs = 1.0 / (10000.0 ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim))
    ang = np.repeat(np.arange(seq_len, dtype=np.float64)[:, None] * freqs[None], 2, -1)
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return f(np.cos(ang)), f(np.sin(ang))


def rotate(x, cos, sin):
    """Interleaved-pair rotary on the first cos.shape[-1] dims of (B, N, H, D)."""
    r = cos.shape[-1]
    xr, xp = x[..., :r], x[..., r:]
    pairs = xr.reshape(xr.shape[:-1] + (-1, 2))
    half = torch.stack([-pairs[..., 1], pairs[..., 0]], -1).reshape(xr.shape)
    cos, sin = cos[:, None, :].to(x.dtype), sin[:, None, :].to(x.dtype)
    return torch.cat([xr * cos + half * sin, xp], -1)


def t_embed(t, dim=256):
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32,
                                                      device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


class _Seq(nn.Sequential):
    pass


class Embed(nn.Module):
    def __init__(self, fin, hidden):
        super().__init__()
        self.MLP = _Seq(Lin(fin, 256), nn.SiLU(), Lin(256, hidden))


class TEmbed(nn.Module):
    def __init__(self, hidden):
        super().__init__()
        self.mlp = _Seq(Lin(256, hidden), nn.SiLU(), Lin(hidden, hidden))

    def forward(self, t):
        return self.mlp(t_embed(t))


class Attention(_Attn):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = Lin(dim, 3 * dim)
        self.proj = Lin(dim, dim)

    def forward(self, x, rot):
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).unbind(2)
        q, k = rotate(q, *rot), rotate(k, *rot)
        return self.proj(attention(q, k, v, self.fp8).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.fc1 = Lin(dim, 4 * dim)
        self.fc2 = Lin(4 * dim, dim)


class Block(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.attn = Attention(dim, heads)
        self.mlp = Mlp(dim)
        self.adaLN_modulation = _Seq(nn.SiLU(), Lin(dim, 6 * dim))

    def forward(self, x, c, rot):
        sm, cm, gm, sp, cp, gp = self.adaLN_modulation(c).chunk(6, -1)
        ln = lambda h: F.layer_norm(h, h.shape[-1:], eps=1e-6)
        x = x + gm[:, None] * self.attn(modulate(ln(x), sm, cm), rot)
        h = modulate(ln(x), sp, cp)
        return x + gp[:, None] * self.mlp.fc2(F.gelu(self.mlp.fc1(h), approximate="tanh"))


class Final(nn.Module):
    def __init__(self, dim, out):
        super().__init__()
        self.linear = Lin(dim, out)
        self.adaLN_modulation = _Seq(nn.SiLU(), Lin(dim, 2 * dim))


class LabelEmbed(nn.Module):
    def __init__(self, num_classes, hidden):
        super().__init__()
        self.embedding_table = nn.Embedding(num_classes + 1, hidden)


class DiTRotary(nn.Module):
    """DiTRotary at any width: ``model(x, t, y, drop)`` on (B, C, H, W)
    latents; ``drop`` (B,) bool replaces labels by the null class."""

    def __init__(self, hidden=1152, depth=28, heads=16, patch=8, in_ch=4,
                 num_classes=3, learn_sigma=False):
        super().__init__()
        self.patch, self.hidden, self.heads = patch, hidden, heads
        self.num_classes = num_classes
        self.out_ch = in_ch * (2 if learn_sigma else 1)
        self.x_embedder = Embed(in_ch * patch, hidden)
        self.t_embedder = TEmbed(hidden)
        self.y_embedder = LabelEmbed(num_classes, hidden) if num_classes else None
        self.blocks = nn.ModuleList(Block(hidden, heads) for _ in range(depth))
        self.final_layer = Final(hidden, patch * self.out_ch)

    def forward(self, x, t, y=None, drop=None):
        b, ch, h, w = x.shape
        tok = x.permute(0, 2, 3, 1).reshape(b, h * w // self.patch, self.patch * ch)
        tok = self.x_embedder.MLP(tok.to(self.x_embedder.MLP[0].weight.dtype))
        c = self.t_embedder(t)
        if self.y_embedder is not None and y is not None:
            if drop is not None:
                y = torch.where(drop, self.num_classes, y)
            c = c + self.y_embedder.embedding_table(y.long())
        rot = rotary_table(tok.shape[1], int(self.hidden // self.heads * 0.5), x.device)
        for blk in self.blocks:
            tok = blk(tok, c, rot)
        shift, scale = self.final_layer.adaLN_modulation(c).chunk(2, -1)
        out = self.final_layer.linear(
            modulate(F.layer_norm(tok, tok.shape[-1:], eps=1e-6), shift, scale))
        return out.reshape(b, -1, w, self.out_ch).permute(0, 3, 1, 2).float()


class DiTRotaryClassifier(nn.Module):
    """The rotary classifier on a CLS token (257 tokens for the latent);
    the chord variant returns (key logits, per-window chord logits)."""

    def __init__(self, hidden=384, depth=12, heads=6, patch=8, in_ch=4,
                 num_classes=9, chord=False):
        super().__init__()
        self.patch, self.hidden, self.heads, self.chord = patch, hidden, heads, chord
        self.x_embedder = Embed(in_ch * patch, hidden)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.t_embedder = TEmbed(hidden)
        self.blocks = nn.ModuleList(Block(hidden, heads) for _ in range(depth))
        self.norm = nn.LayerNorm(hidden, eps=1e-6)
        self.classifier_head = _Seq(Lin(hidden, hidden // 4), nn.SiLU(),
                                    Lin(hidden // 4, num_classes))
        if chord:
            self.norm_key = nn.LayerNorm(hidden, eps=1e-6)
            self.classifier_head_key = _Seq(Lin(hidden, hidden // 4), nn.SiLU(),
                                            Lin(hidden // 4, 25))

    def forward(self, x, t):
        b, ch, h, w = x.shape
        tok = x.permute(0, 2, 3, 1).reshape(b, h * w // self.patch, self.patch * ch)
        tok = self.x_embedder.MLP(tok.to(self.cls_token.dtype))
        tok = torch.cat([self.cls_token.expand(b, -1, -1), tok], 1)
        c = self.t_embedder(t)
        rot = rotary_table(tok.shape[1], int(self.hidden // self.heads * 0.5), x.device)
        for blk in self.blocks:
            tok = blk(tok, c, rot)
        if not self.chord:
            return self.classifier_head(self.norm(tok[:, 0])).float()
        key = self.classifier_head_key(self.norm_key(tok[:, 0]))
        win = tok[:, 1:].reshape(b, h // w, -1, self.hidden).mean(-2)
        return key.float(), self.classifier_head(self.norm(win)).float()


# ---- KL-VAE f8 ------------------------------------------------------------


class Norm(nn.Module):
    """GroupNorm(32, 1e-6) parameters; applied with swish by the caller."""

    def __init__(self, ch):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return F.silu(F.group_norm(x, 32, self.weight, self.bias, 1e-6))


class Res(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1, self.conv1 = Norm(cin), Conv(cin, cout, 3, padding=1)
        self.norm2, self.conv2 = Norm(cout), Conv(cout, cout, 3, padding=1)
        self.nin_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class AttnBlock(_Attn):
    def __init__(self, ch):
        super().__init__()
        self.norm = nn.GroupNorm(32, ch, eps=1e-6)
        self.q, self.k, self.v = Conv(ch, ch, 1), Conv(ch, ch, 1), Conv(ch, ch, 1)
        self.proj_out = Conv(ch, ch, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)
        flat = lambda m: m(hn).reshape(b, c, 1, h * w).permute(0, 3, 2, 1)
        out = attention(flat(self.q), flat(self.k), flat(self.v), self.fp8)
        return x + self.proj_out(out.permute(0, 3, 2, 1).reshape(b, c, h, w))


class Mid(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.block_1, self.attn_1, self.block_2 = Res(ch, ch), AttnBlock(ch), Res(ch, ch)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class Level(nn.Module):
    def __init__(self, blocks, sample=None, up=True):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if sample is not None:
            setattr(self, "upsample" if up else "downsample", sample)


class Up(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Down(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Decoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 2, 2, 4), num_res_blocks=2, out_ch=3, z=4):
        super().__init__()
        cin = ch * ch_mult[-1]
        self.conv_in = Conv(z, cin, 3, padding=1)
        self.mid = Mid(cin)
        levels = [None] * len(ch_mult)
        for i in reversed(range(len(ch_mult))):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(Res(cin, ch * ch_mult[i]))
                cin = ch * ch_mult[i]
            levels[i] = Level(blocks, Up(cin) if i else None)
        self.up = nn.ModuleList(levels)
        self.norm_out = Norm(cin)
        self.conv_out = Conv(cin, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for i in reversed(range(len(self.up))):
            for blk in self.up[i].block:
                h = blk(h)
            if i:
                h = self.up[i].upsample(h)
        return self.conv_out(self.norm_out(h))


class Encoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 2, 2, 4), num_res_blocks=2, in_ch=3, z=4):
        super().__init__()
        self.conv_in = Conv(in_ch, ch, 3, padding=1)
        cin, levels = ch, []
        for i, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(Res(cin, ch * mult))
                cin = ch * mult
            levels.append(Level(blocks, Down(cin) if i < len(ch_mult) - 1 else None,
                                up=False))
        self.down = nn.ModuleList(levels)
        self.mid = Mid(cin)
        self.norm_out = Norm(cin)
        self.conv_out = Conv(cin, 2 * z, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for i, level in enumerate(self.down):
            for blk in level.block:
                h = blk(h)
            if i < len(self.down) - 1:
                h = level.downsample(h)
        return self.conv_out(self.norm_out(self.mid(h)))


class KLVAE(nn.Module):
    """``decode(z)``: (N, 4, 16, 16) -> (N, 3, 128, 128); with ``encoder``,
    ``encode_moments(x)``: (N, 3, 128, 128) -> (N, 8, 16, 16)."""

    def __init__(self, ch=128, ch_mult=(1, 2, 2, 4), num_res_blocks=2,
                 encoder=False, decoder=True, z=4):
        super().__init__()
        if encoder:
            self.encoder = Encoder(ch, ch_mult, num_res_blocks, z=z)
            self.quant_conv = Conv(2 * z, 2 * z, 1)
        if decoder:
            self.decoder = Decoder(ch, ch_mult, num_res_blocks, z=z)
            self.post_quant_conv = Conv(z, z, 1)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z.float())).float()

    def encode_moments(self, x):
        return self.quant_conv(self.encoder(x.float())).float()


def build(kind: str, arch: dict, device, dtype=torch.float32) -> nn.Module:
    """A reference model from a configuration entry's ``arch``."""
    with torch.device(device):
        if kind == "dit":
            m = DiTRotary(arch["hidden_size"], arch["depth"], arch["num_heads"],
                          arch["patch_size"], arch["in_channels"],
                          arch["num_classes"], arch.get("learn_sigma", False))
        elif kind == "classifier":
            m = DiTRotaryClassifier(arch["hidden_size"], arch["depth"],
                                    arch["num_heads"], arch["patch_size"],
                                    arch["in_channels"], arch["num_classes"],
                                    arch.get("chord", False))
        elif kind == "vae":
            m = KLVAE(arch["ch"], tuple(arch["ch_mult"]), arch["num_res_blocks"],
                      encoder=arch.get("encoder", False),
                      decoder=arch.get("decoder", True), z=arch["z_channels"])
        else:
            raise ValueError(kind)
    return m.to(dtype)

"""LPIPS perceptual loss (VGG16 features + learned linear heads).

Port of ``rule_guided_music_tpu/training/perceptual.py`` (reference
taming/modules/losses/lpips.py:11), the perceptual term of the VAE's
LPIPSWithDiscriminator loss. The released piano-roll VAE trains with
perceptual_weight 0; the module exists for capability parity.

The port keeps torchvision's layout: ``net`` is ``vgg16().features`` up to
``relu5_3`` (indices 0-29, taps after relu 3, 8, 15, 22 and 29) and the
heads are taming's ``lin{i}.model.1`` 1x1 convolutions, so
:meth:`LPIPS.load_torch` loads a torchvision VGG16 features state dict and
taming's ``vgg.pth`` directly. Neither file is in the repository, and none
is fetched: without them the module keeps seeded random weights, still a
smooth feature-space distance, not the calibrated metric.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn

# VGG16 feature geometry: (convs_per_block, out_channels) per block; LPIPS
# taps the last relu of each block (relu1_2, 2_2, 3_3, 4_3, 5_3)
_VGG_BLOCKS = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]

# ImageNet normalization (lpips.ScalingLayer), inputs in [-1, 1]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Sequential):
    """torchvision's ``vgg16().features[:30]``; :meth:`taps` returns the
    five LPIPS activations (NCHW)."""

    def __init__(self):
        layers, cin = [], 3
        for bi, (n_convs, ch) in enumerate(_VGG_BLOCKS):
            for _ in range(n_convs):
                layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU()]
                cin = ch
            if bi < len(_VGG_BLOCKS) - 1:
                layers.append(nn.MaxPool2d(2, 2))
        super().__init__(*layers)

    def taps(self, x: torch.Tensor):
        out = []
        for i, layer in enumerate(self):
            x = layer(x)
            nxt = self[i + 1] if i + 1 < len(self) else None
            if isinstance(layer, nn.ReLU) and not isinstance(nxt, nn.Conv2d):
                out.append(x)
        return out


class _NetLin(nn.Module):
    """taming's NetLinLayer: (dropout, 1x1 conv without bias); the dropout
    slot is an identity, as the JAX module has none."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(channels, 1, 1, bias=False))


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt((x ** 2).sum(dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """lpips.LPIPS(net='vgg'): unit-normalized feature differences, 1x1
    heads, spatial mean, summed over the five taps. NCHW [-1, 1] inputs
    (one channel is tiled to three); returns (B,)."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for i, (_, ch) in enumerate(_VGG_BLOCKS):
            self.add_module(f"lin{i}", _NetLin(ch))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        def prep(a):
            if a.shape[1] == 1:
                a = a.repeat(1, 3, 1, 1)
            return (a - self.shift) / self.scale

        total = 0.0
        for i, (fx, fy) in enumerate(zip(self.net.taps(prep(x)),
                                         self.net.taps(prep(y)))):
            diff = (_unit_normalize(fx) - _unit_normalize(fy)) ** 2
            lin = getattr(self, f"lin{i}").model[1]
            total = total + lin(diff).mean(dim=(1, 2, 3))
        return total

    def load_torch(self, vgg_features_sd: Mapping[str, torch.Tensor],
                   lins_sd: Mapping[str, torch.Tensor]) -> "LPIPS":
        """torchvision ``vgg16().features`` keys ('0.weight', '2.bias', ...)
        and taming's ``vgg.pth`` heads ('lin0.model.1.weight' or
        'lins.0.model.1.weight')."""
        names = set(self.net.state_dict())
        self.net.load_state_dict({k: v for k, v in vgg_features_sd.items()
                                  if k in names})
        heads = {}
        for i in range(len(_VGG_BLOCKS)):
            key = f"lin{i}.model.1.weight"
            heads[key] = lins_sd[key if key in lins_sd else f"lins.{i}.model.1.weight"]
        self.load_state_dict({**{f"net.{k}": v for k, v in self.net.state_dict().items()},
                              **heads})
        return self

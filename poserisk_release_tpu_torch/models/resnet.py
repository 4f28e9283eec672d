"""ResNet-50 backbone (torchvision layout), as SPIN embeds it.

SPIN's hmr model embeds torchvision's ResNet-50 v1.5 (stride on the 3x3
bottleneck conv); contract at reference lib/core/base.py:81-84, 220. Module
names follow torchvision (conv1/bn1/layer{1..4}.{i}.conv{k}/bn{k}/
downsample.{0,1}), which are the keys of nkolot/SPIN's model_checkpoint.pt,
so a checkpoint loads with a plain load_state_dict. Inference-mode
BatchNorm (running statistics, eps 1e-5).

The JAX package's space-to-depth stem (StemConv s2d) is a TPU layout trick
with the same weights and outputs; the port runs the plain 7x7 stem.
Convolutions run through F.conv2d (cuDNN on the card), as the JAX package
left them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

BN_EPS = 1e-5


class Bottleneck(nn.Module):
    """torchvision bottleneck: 1x1 -> 3x3(stride) -> 1x1, expansion 4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: nn.Module | None = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4, eps=BN_EPS)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNet50(nn.Module):
    """Feature extractor: NCHW (B, 3, 224, 224) -> (B, 2048) pooled f32."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = self._make_layer(64, layers[0])
        self.layer2 = self._make_layer(128, layers[1], stride=2)
        self.layer3 = self._make_layer(256, layers[2], stride=2)
        self.layer4 = self._make_layer(512, layers[3], stride=2)

    def _make_layer(self, planes: int, blocks: int, stride: int = 1) -> nn.Sequential:
        downsample = nn.Sequential(
            nn.Conv2d(self.inplanes, planes * 4, 1, stride=stride, bias=False),
            nn.BatchNorm2d(planes * 4, eps=BN_EPS),
        )
        layers = [Bottleneck(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * 4
        for _ in range(1, blocks):
            layers.append(Bottleneck(self.inplanes, planes))
        return nn.Sequential(*layers)

    def backbone_modules(self):
        return (self.conv1, self.bn1, self.layer1, self.layer2, self.layer3, self.layer4)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.conv1.weight.dtype)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        # Global average pool over the final 7x7 map (torch AvgPool2d(7));
        # features return to f32 so the IEF head runs in full precision.
        return x.float().mean(dim=(2, 3))

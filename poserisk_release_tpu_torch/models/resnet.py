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

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
LAYERS = (3, 4, 6, 3)
PLANES = (64, 128, 256, 512)


def conv_bn_names(name: str):
    """(conv module, BN module) of a resnet50_walk conv name, under the
    HMR's module names ("layer1.0.conv2" -> "layer1.0.bn2"; a downsample
    is the Sequential's 0 and 1)."""
    if name.endswith("downsample"):
        return name + ".0", name + ".1"
    head, _, last = name.rpartition("conv")
    return name, head + "bn" + last


def conv_height(height: int, k: int, s: int, p: int) -> int:
    """Output rows of a conv or pool of kernel k, stride s, padding p."""
    return (height + 2 * p - k) // s + 1


def resnet50_walk(x: torch.Tensor, conv: Callable, rows=None,
                  gather: Optional[Callable] = None, width: int = 1,
                  epilogue: bool = False) -> torch.Tensor:
    """THE ResNet-50 v1.5 walk over a conv function: NCHW crops (B, 3, S, S)
    -> (B, C) pooled f32 features. The backbones that are not an nn.Module
    run through it: the tensor-parallel shard (parallel/spmd), the folded /
    int8 backbone (models/resnet_int8), and any of them, or the HMR's own
    convs, with the crop rows split over ranks (parallel/spmd.SpatialHMR).

    conv(name, x, stride, padding) -> the named conv's output with its BN
    (or folded bias) applied and no activation; names are the HMR's conv
    names ("conv1", "layer{L}.{i}.conv{1,2,3}", "layer{L}.{i}.downsample")
    and padding a (rows, columns) pair. The walk then adds a bottleneck's
    identity to its conv3 and applies the ReLUs itself. With epilogue=True
    the conv does that too: conv(name, x, stride, padding, relu=...,
    residual=...) -> the output with its bias, then `residual` (the
    identity, conv3 only; None elsewhere) added, then ReLU where `relu`
    (the stem, conv1, conv2, conv3; not a downsample): the folded backbone's
    one epilogue pass a conv (models/resnet_int8.resnet50_forward on a
    folded f32 backbone).

    gather(t): what a conv reads of a block-internal activation (the
    tensor-parallel channel gather; identity by default). width: the
    channel shards a conv's output comes in (the model axis), which sizes
    an empty output.

    rows: None, or this rank's rows of every activation (parallel/mesh.
    RowShards): x is then the whole crops, each conv and the max-pool
    read their input window (rows.take from the whole crops for the stem,
    rows.exchange, the halo exchange, after it) with the row padding
    already in it, and the pool is the sum over the rank's rows, summed
    over the ranks (rows.mean). A rank that owns no output rows of a
    layer computes none (an empty tensor of 0 rows)."""
    gather = gather or (lambda t: t)

    def run(name, t, height, k, s, p, cout, whole=False, read=None, relu=False,
            residual=None):
        """(output, output height) of one conv on t (its rank's rows, or
        the whole crops for the stem), `residual` added and ReLU'd where
        asked; read: gather(t), when known."""
        out_height = conv_height(height, k, s, p)
        if rows is None:
            src = t if whole else (read if read is not None else gather(t))
            pad = (p, p)
        else:
            win = rows.take(t, k, s, p) if whole else rows.exchange(t, height, k, s, p)
            if win.shape[2] == 0:
                wo = conv_height(t.shape[3], k, s, p)
                return win.new_zeros((win.shape[0], cout // width, 0, wo)), out_height
            src = win if whole else (read if (win is t and read is not None) else gather(win))
            pad = (0, p)
        if epilogue:
            return conv(name, src, s, pad, relu=relu, residual=residual), out_height
        out = conv(name, src, s, pad)
        if residual is not None:
            out = out + residual
        # In place on the conv's own output, as nn.ReLU(inplace=True) acts.
        return (F.relu(out, inplace=True) if relu else out), out_height

    height = x.shape[2]
    x, height = run("conv1", x, height, 7, 2, 3, 64, whole=True, relu=True)
    if rows is None:
        x = F.max_pool2d(x, 3, 2, padding=1)
    else:
        # Zero rows past the crop's edge are exact for this max-pool: its
        # input is post-ReLU (>= 0) and every window holds a real row.
        win = rows.exchange(x, height, 3, 2, 1)
        if win.shape[2]:
            x = F.max_pool2d(win, 3, 2, padding=(0, 1))
        else:
            x = win.new_zeros((*win.shape[:2], 0, conv_height(x.shape[3], 3, 2, 1)))
    def block(x, height, L, i):
        """One bottleneck: (output, output height). Its temporaries die
        with the call."""
        p, planes = f"layer{L}.{i}.", PLANES[L - 1]
        stride = 2 if (L > 1 and i == 0) else 1
        # The block input's gather serves conv1 and, where it reads the
        # same rows, the downsample.
        read = gather(x) if (x.shape[2] or rows is None) else None
        identity = x
        if i == 0:
            identity, _ = run(p + "downsample", x, height, 1, stride, 0, planes * 4, read=read)
        out, _ = run(p + "conv1", x, height, 1, 1, 0, planes, read=read, relu=True)
        del read
        out, out_height = run(p + "conv2", out, height, 3, stride, 1, planes, relu=True)
        return run(p + "conv3", out, out_height, 1, 1, 0, planes * 4, relu=True,
                   residual=identity)

    height = conv_height(height, 3, 2, 1)
    for L, n_blocks in enumerate(LAYERS, start=1):
        for i in range(n_blocks):
            x, height = block(x, height, L, i)
    if rows is None:
        return x.float().mean(dim=(2, 3))
    return rows.mean(x.float(), height * x.shape[3])


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

    def conv_bn(self, name: str, x: torch.Tensor, stride: int, padding) -> torch.Tensor:
        """One named conv and its BN on x at the given padding: the
        resnet50_walk conv of this module's weights."""
        conv_name, bn_name = conv_bn_names(name)
        y = F.conv2d(x, self.get_submodule(conv_name).weight, None, stride, padding)
        return self.get_submodule(bn_name)(y)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.conv1.weight.dtype)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        # Global average pool over the final 7x7 map (torch AvgPool2d(7));
        # features return to f32 so the IEF head runs in full precision.
        return x.float().mean(dim=(2, 3))

"""VoVNet(CP) backbone, torch port of
paddle3d_tpu/models/backbones/vovnet.py (VoVNet, VoVNetCP, OSABlock,
eSEModule, _STAGE_SPECS) — PETR's V-99-eSE image backbone.

One-Shot-Aggregation blocks: a chain of 3x3 convs whose outputs (and the
input) concatenate into a 1x1 aggregation conv, eSE channel attention and,
from a stage's second block on, an identity residual. NCHW on cuDNN, with
the JAX package's module tree (so that its dotted parameter paths name the
same submodules) and its conventions:
  * each conv pads (k - 1) // 2 a side, as the JAX package gives it
    explicitly; the stage pools are 3x3 / 2 max pools with one cell of
    -inf padding a side;
  * BatchNorm eps 1e-5 and flax momentum 0.99 (torch momentum 0.01), with
    flax's running-stat update in train mode (layer_libs.BatchNorm2d);
  * eSE's gate is hard_sigmoid, relu6(x + 3) / 6 (torch's hardsigmoid).
The JAX package's VoVNet never reads its `remat` flag (VoVNetCP sets it),
so the port keeps the flag and changes nothing by it either (a
torch.utils.checkpoint would also move the BatchNorm running stats twice a
train step). Weights: the convs uniform(±1/sqrt(fan_in)), eSE's conv
lecun-normal with a zero bias (nnx.Conv's defaults), from an explicit
torch.Generator (default seed 0). frozen_stages and norm_eval are kept
as attributes (no config sets them), as the port's ResNet keeps them.
"""
import ast
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...apis import manager
from ..layers.layer_libs import (BatchNorm2d, Sequential, default_generator,
                                 lecun_normal_, uniform_init)

__all__ = ["VoVNet", "VoVNetCP", "OSABlock", "eSEModule"]

_STAGE_SPECS = {
    # name: (stem_ch, stage_conv_ch, stage_out_ch, layers_per_block,
    #        blocks_per_stage)
    "V-19-eSE": ((64, 64, 128), (128, 160, 192, 224),
                 (256, 512, 768, 1024), 3, (1, 1, 1, 1)),
    "V-39-eSE": ((64, 64, 128), (128, 160, 192, 224),
                 (256, 512, 768, 1024), 5, (1, 1, 2, 2)),
    "V-57-eSE": ((64, 64, 128), (128, 160, 192, 224),
                 (256, 512, 768, 1024), 5, (1, 1, 4, 3)),
    "V-99-eSE": ((64, 64, 128), (128, 160, 192, 224),
                 (256, 512, 768, 1024), 5, (1, 3, 9, 3)),
}


def _conv_bn_relu(cin, cout, k, stride=1, *, generator):
    conv = nn.utils.skip_init(nn.Conv2d, cin, cout, k, stride,
                              padding=(k - 1) // 2, bias=False)
    uniform_init(conv.weight, generator)
    return Sequential(conv, BatchNorm2d(cout, eps=1e-5, momentum=0.01),
                      nn.ReLU())


class eSEModule(nn.Module):
    """Effective squeeze-excitation: x * hard_sigmoid(fc(mean over H, W))."""

    def __init__(self, channels, *, generator):
        super().__init__()
        self.fc = nn.utils.skip_init(nn.Conv2d, channels, channels, 1)
        lecun_normal_(self.fc.weight, generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x):
        gap = torch.mean(x, dim=(2, 3), keepdim=True)
        return x * F.hardsigmoid(self.fc(gap))


class OSABlock(nn.Module):
    def __init__(self, cin, conv_ch, cout, num_layers, identity, *,
                 generator):
        super().__init__()
        self.identity = identity and cin == cout
        layers = []
        c = cin
        for _ in range(num_layers):
            layers.append(_conv_bn_relu(c, conv_ch, 3, generator=generator))
            c = conv_ch
        self.layers = nn.ModuleList(layers)
        concat_ch = cin + num_layers * conv_ch
        self.concat_conv = _conv_bn_relu(concat_ch, cout, 1,
                                         generator=generator)
        self.ese = eSEModule(cout, generator=generator)

    def forward(self, x):
        identity = x
        outs = [x]
        for layer in self.layers:
            x = layer(x)
            outs.append(x)
        out = self.ese(self.concat_conv(torch.cat(outs, dim=1)))
        if self.identity:
            out = out + identity
        return out


@manager.BACKBONES.add_component
class VoVNet(nn.Module):
    def __init__(self,
                 spec_name: str = "V-99-eSE",
                 input_ch: int = 3,
                 out_features: Sequence[str] = ("stage4", "stage5"),
                 frozen_stages: int = -1,
                 remat: bool = False,
                 norm_eval: bool = False,
                 pretrained: str = None,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        if isinstance(out_features, str):
            # reference configs write the tuple as a YAML string, e.g.
            # "('stage4','stage5',)"
            out_features = ast.literal_eval(out_features)
        stem_ch, conv_ch, out_ch, n_layers, n_blocks = _STAGE_SPECS[spec_name]
        self.norm_eval = norm_eval
        self.pretrained = pretrained
        self.out_features = tuple(out_features)
        self.remat = remat
        self.frozen_stages = frozen_stages

        self.stem = nn.ModuleList([
            _conv_bn_relu(input_ch, stem_ch[0], 3, 2, generator=generator),
            _conv_bn_relu(stem_ch[0], stem_ch[1], 3, generator=generator),
            _conv_bn_relu(stem_ch[1], stem_ch[2], 3, 2, generator=generator),
        ])
        stages = []
        cin = stem_ch[2]
        self.out_channels = []
        for i in range(4):
            blocks = []
            for j in range(n_blocks[i]):
                blocks.append(OSABlock(
                    cin if j == 0 else out_ch[i], conv_ch[i], out_ch[i],
                    n_layers, identity=j > 0, generator=generator))
            stages.append(nn.ModuleList(blocks))
            cin = out_ch[i]
            self.out_channels.append(cin)
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        """x [B, C, H, W] -> tuple of the stage outputs in out_features
        (stage2 at stride 4 to stage5 at stride 32)."""
        for layer in self.stem:
            x = layer(x)
        outs = {}
        for i, stage in enumerate(self.stages):
            if i > 0:
                x = F.max_pool2d(x, 3, 2, 1)
            for blk in stage:
                x = blk(x)
            outs["stage{}".format(i + 2)] = x
        return tuple(outs[name] for name in self.out_features)


@manager.BACKBONES.add_component
def VoVNetCP(**kwargs):
    """VoVNet with remat set, as the JAX package builds it (the flag
    changes nothing there or here)."""
    kwargs.setdefault("remat", True)
    return VoVNet(**kwargs)

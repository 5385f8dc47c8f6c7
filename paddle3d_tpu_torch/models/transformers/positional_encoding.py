"""Positional encodings of the transformer heads, torch port of
paddle3d_tpu/models/transformers/positional_encoding.py
(LearnedPositionalEncoding, SinePositionalEncoding,
SinePositionalEncoding3D, LearnedPositionalEncoding3D).

Each returns the encoding of a grid, channels last: [h, w, 2F] over (row,
col), [n, h, w, 3F] over (camera, row, col). The learned ones are
nnx.Embed tables (torch nn.Embedding, normal(0, 1) rows from an explicit
torch.Generator; utils/convert.py maps nnx.Embed's `embedding` leaf); the
sine ones hold no state. No config of the repo builds one yet: they are
here for the heads that name them.
"""
import math

import torch
from torch import nn

from ...apis import manager
from ..layers.layer_libs import default_generator

__all__ = ["LearnedPositionalEncoding", "SinePositionalEncoding",
           "SinePositionalEncoding3D", "LearnedPositionalEncoding3D"]


def _embed(num, feats, generator):
    table = nn.utils.skip_init(nn.Embedding, num, feats)
    with torch.no_grad():
        table.weight.normal_(generator=generator)
    return table


def _rows(table, n):
    return table.weight[:n]


@manager.POSITIONAL_ENCODING.add_component
class LearnedPositionalEncoding(nn.Module):
    """A learned row and column embedding a cell: (col, row)."""

    def __init__(self, num_feats: int = 128, row_num_embed: int = 50,
                 col_num_embed: int = 50, generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.num_feats = num_feats
        self.row_embed = _embed(row_num_embed, num_feats, generator)
        self.col_embed = _embed(col_num_embed, num_feats, generator)

    def forward(self, h: int, w: int) -> torch.Tensor:
        """-> [h, w, 2 * num_feats]."""
        f = self.num_feats
        rows, cols = _rows(self.row_embed, h), _rows(self.col_embed, w)
        return torch.cat([cols[None].expand(h, w, f),
                          rows[:, None].expand(h, w, f)], dim=-1)


def _sine(pos: torch.Tensor, num_feats: int, temperature: float):
    """pos [...] -> [..., num_feats]: sin of the even frequencies and cos
    of the odd ones, interleaved (DETR's stack-then-flatten)."""
    dim_t = torch.arange(num_feats, dtype=torch.float32)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_feats)
    p = pos[..., None] / dim_t
    return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                       dim=-1).flatten(-2)


@manager.POSITIONAL_ENCODING.add_component
class SinePositionalEncoding:
    """DETR's sine / cosine encoding of (row, col); no state."""

    def __init__(self, num_feats: int = 128, temperature: float = 10000.,
                 normalize: bool = True, scale: float = 2 * math.pi,
                 offset: float = -0.5):
        self.num_feats = num_feats
        self.temperature = temperature
        self.normalize = normalize
        self.scale = scale
        self.offset = offset

    def _axis(self, n: int) -> torch.Tensor:
        """The 1-based positions of an axis of n cells, normalised."""
        x = torch.arange(n, dtype=torch.float32) + 1.
        if self.normalize:
            x = (x + self.offset) / n * self.scale
        return x

    def __call__(self, h: int, w: int) -> torch.Tensor:
        """-> [h, w, 2 * num_feats]: the row's encoding, then the
        column's."""
        f, t = self.num_feats, self.temperature
        py = _sine(self._axis(h), f, t)[:, None].expand(h, w, f)
        px = _sine(self._axis(w), f, t)[None].expand(h, w, f)
        return torch.cat([py, px], dim=-1)


@manager.POSITIONAL_ENCODING.add_component
class SinePositionalEncoding3D(SinePositionalEncoding):
    """The sine encoding of (camera, row, col), num_feats an axis."""

    def __call__(self, n: int, h: int, w: int) -> torch.Tensor:
        """-> [n, h, w, 3 * num_feats]."""
        f = self.num_feats
        pe2d = super().__call__(h, w)
        pz = _sine(self._axis(n), f, self.temperature)
        return torch.cat([pz[:, None, None].expand(n, h, w, f),
                          pe2d[None].expand(n, h, w, 2 * f)], dim=-1)


@manager.POSITIONAL_ENCODING.add_component
class LearnedPositionalEncoding3D(nn.Module):
    """A learned camera, row and column embedding a cell."""

    def __init__(self, num_feats: int = 128, row_num_embed: int = 50,
                 col_num_embed: int = 50, cam_num_embed: int = 6,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.num_feats = num_feats
        self.row_embed = _embed(row_num_embed, num_feats, generator)
        self.col_embed = _embed(col_num_embed, num_feats, generator)
        self.cam_embed = _embed(cam_num_embed, num_feats, generator)

    def forward(self, n: int, h: int, w: int) -> torch.Tensor:
        """-> [n, h, w, 3 * num_feats]."""
        f = self.num_feats
        cams = _rows(self.cam_embed, n)
        rows = _rows(self.row_embed, h)
        cols = _rows(self.col_embed, w)
        return torch.cat([cams[:, None, None].expand(n, h, w, f),
                          rows[None, :, None].expand(n, h, w, f),
                          cols[None, None].expand(n, h, w, f)], dim=-1)

"""Transformer building blocks, torch port of
paddle3d_tpu/models/transformers/transformer_layers.py (MultiHeadAttention,
FFN, BaseTransformerLayer, TransformerLayerSequence).

The attention follows flax's nnx.MultiHeadAttention, whose parameters the
JAX package's state carries: q / k / v projections with kernels
[in, heads, head_dim] and biases [heads, head_dim], an out projection with
kernel [heads, head_dim, out] (here nn.Linear's over the flattened heads,
utils/convert.py reshapes). Deterministic and without dropout, flax runs
jax.nn.dot_product_attention's XLA form, and so does the port: logits q·k
in the inputs' dtype times 1 / sqrt(head_dim), masked logits set to -0.7 x
finfo(dtype).max (True = may attend), the softmax always in f32 (an f64
step's logits are rounded to f32 first), then the weights in the inputs'
dtype times v. It is written as two batched matmuls and a softmax, not
nn.MultiheadAttention's fused path or F.scaled_dot_product_attention: on
the card either may pick a kernel whose rounding no parity check pins.
nnx.LayerNorm's eps is 1e-6 (torch's default 1e-5). Weights are
lecun-normal with zero biases, LayerNorm ones and zeros (flax's defaults),
from an explicit torch.Generator (default seed 0).
"""
import math
from typing import Sequence

import torch
from torch import nn

from ...apis import manager
from ..layers.layer_libs import default_generator, lecun_normal_

__all__ = ["MultiHeadAttention", "FFN", "BaseTransformerLayer",
           "TransformerLayerSequence", "HeadsLinear", "linear", "layer_norm"]


def linear(cin: int, cout: int, generator: torch.Generator) -> nn.Linear:
    """nnx.Linear's defaults: lecun-normal weight, zero bias."""
    fc = nn.utils.skip_init(nn.Linear, cin, cout)
    lecun_normal_(fc.weight, generator)
    nn.init.zeros_(fc.bias)
    return fc


def layer_norm(dims: int) -> nn.LayerNorm:
    """nnx.LayerNorm: eps 1e-6."""
    return nn.LayerNorm(dims, eps=1e-6)


class HeadsLinear(nn.Linear):
    """A projection of nnx.MultiHeadAttention: nn.Linear over the
    flattened (heads, head_dim) axis, the q / k / v projections' output
    (kernel [in, heads, head_dim], bias [heads, head_dim]) or the out
    projection's input (kernel [heads, head_dim, out]); utils/convert.py
    reshapes by this type."""


def heads_linear(cin: int, cout: int,
                 generator: torch.Generator) -> HeadsLinear:
    fc = nn.utils.skip_init(HeadsLinear, cin, cout)
    lecun_normal_(fc.weight, generator)
    nn.init.zeros_(fc.bias)
    return fc


class _Attention(nn.Module):
    """nnx.MultiHeadAttention(num_heads, in_features=qkv_features=dims),
    deterministic (no dropout)."""

    def __init__(self, dims: int, num_heads: int, generator):
        super().__init__()
        self.num_heads = num_heads
        self.query, self.key, self.value, self.out = (
            heads_linear(dims, dims, generator) for _ in range(4))

    def forward(self, q, k, v, mask=None):
        """q [B, Q, C], k and v [B, K, C]; mask [Q, K] or broadcastable to
        [B, heads, Q, K], True = may attend."""
        b, nq, _ = q.shape
        nk = k.shape[1]
        h = self.num_heads
        q = self.query(q).view(b, nq, h, -1).transpose(1, 2)
        k = self.key(k).view(b, nk, h, -1).transpose(1, 2)
        v = self.value(v).view(b, nk, h, -1).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2))     # [B, h, Q, K]
        logits = logits * torch.tensor(1.0 / math.sqrt(q.shape[-1]),
                                       dtype=logits.dtype)
        if mask is not None:
            logits = logits.masked_fill(
                ~mask, -0.7 * torch.finfo(logits.dtype).max)
        weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = torch.matmul(weights, v)                    # [B, h, Q, d]
        return self.out(out.transpose(1, 2).reshape(b, nq, -1))


@manager.ATTENTIONS.add_component
class MultiHeadAttention(nn.Module):
    """Standard MHA with optional query / key positional embeddings."""

    def __init__(self, embed_dims: int, num_heads: int,
                 generator: torch.Generator = None):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.attn = _Attention(embed_dims, num_heads,
                               default_generator(generator))

    def forward(self, query, key=None, value=None, query_pos=None,
                key_pos=None, attn_mask=None):
        """query [B, Q, C]; key / value [B, K, C]."""
        if key is None:
            key = query
        if value is None:
            value = key
        q = query + query_pos if query_pos is not None else query
        k = key + key_pos if key_pos is not None else key
        return self.attn(q, k, value, attn_mask)


class FFN(nn.Module):
    def __init__(self, embed_dims: int, feedforward_channels: int,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.fc1 = linear(embed_dims, feedforward_channels, generator)
        self.fc2 = linear(feedforward_channels, embed_dims, generator)

    def forward(self, x, identity=None):
        out = self.fc2(torch.relu(self.fc1(x)))
        return (x if identity is None else identity) + out


@manager.TRANSFORMER_ENCODER_LAYERS.add_component
@manager.TRANSFORMER_DECODER_LAYERS.add_component
class BaseTransformerLayer(nn.Module):
    """A layer of the mmcv-style operation_order, drawn from ('self_attn',
    'cross_attn', 'norm', 'ffn'); attentions are taken in order from
    `attns`. attn_masks gates the self-attention only."""

    def __init__(self, attns: Sequence, embed_dims: int,
                 feedforward_channels: int,
                 operation_order: Sequence[str] = ("self_attn", "norm",
                                                   "cross_attn", "norm",
                                                   "ffn", "norm"),
                 generator: torch.Generator = None):
        super().__init__()
        if not isinstance(attns, (list, tuple)):
            attns = [attns]
        self.attns = nn.ModuleList(attns)
        self.operation_order = tuple(operation_order)
        self.embed_dims = embed_dims
        n_norms = sum(1 for op in operation_order if op == "norm")
        self.norms = nn.ModuleList([layer_norm(embed_dims)
                                    for _ in range(n_norms)])
        self.ffn = FFN(embed_dims, feedforward_channels,
                       generator=default_generator(generator))

    def forward(self, query, key=None, value=None, query_pos=None,
                key_pos=None, attn_masks=None):
        norm_i = attn_i = 0
        for op in self.operation_order:
            if op == "self_attn":
                query = query + self.attns[attn_i](
                    query, query, query, query_pos=query_pos,
                    key_pos=query_pos, attn_mask=attn_masks)
                attn_i += 1
            elif op == "cross_attn":
                query = query + self.attns[attn_i](
                    query, key, value, query_pos=query_pos, key_pos=key_pos)
                attn_i += 1
            elif op == "norm":
                query = self.norms[norm_i](query)
                norm_i += 1
            elif op == "ffn":
                query = self.ffn(query)
            else:
                raise ValueError("unknown op {}".format(op))
        return query


@manager.TRANSFORMER_ENCODERS.add_component
@manager.TRANSFORMER_DECODERS.add_component
class TransformerLayerSequence(nn.Module):
    """A stack of layers; with return_intermediate, every layer's output
    (through post_norm, if set: the stack itself goes on un-normed) stacked
    as [L, ...]."""

    def __init__(self, layers: Sequence, return_intermediate: bool = False,
                 post_norm: bool = False, embed_dims: int = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.return_intermediate = return_intermediate
        self.post_norm = layer_norm(embed_dims) if post_norm else None

    def forward(self, query, **kwargs):
        intermediate = []
        for layer in self.layers:
            query = layer(query, **kwargs)
            if self.return_intermediate:
                intermediate.append(query if self.post_norm is None
                                    else self.post_norm(query))
        if self.return_intermediate:
            return torch.stack(intermediate)
        if self.post_norm is not None:
            query = self.post_norm(query)
        return query

"""PAConv point-cloud classifier, torch port of
paddle3d_tpu/models/classification/paconv.py (assign_score_withk,
ScoreNet, PAConv).

The JAX package assembles each (point, neighbour) feature as
    sum_m scores[n, k, m] * ((F[idx[n, k]] - F[n]) @ W_m)
in that order: the difference transformed by each of the M weight banks,
[N, K, M, Cout] materialised, then weighted by the scores
(`assign_score_withk_plain` here). The function is linear in the
features, so the port transforms each point once, P_m = F @ W_m ([N, M,
Cout]), and weights the transformed rows gathered at the neighbours minus
those at the centre (`assign_score_withk`): K Cin / (Cin + 2 K) times
fewer products (15 at the configs' last layer), and [N, K, Cout] is all it keeps, forward and backward
(`_ScoredGather` gathers in bounded chunks and gathers again in the
backward).
The sums run in another order than the JAX one; tests hold the two forms
to each other and to the JAX function.

Batched: [B, N, 3] clouds, the neighbours from the port's stable-tie
`knn_query` (self included, as `lax.top_k` gives them per sample).
No hand-written kernel is on this path: the JAX package's is an einsum
chain, not Pallas.
"""
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...apis import manager
from ...ops.pointnet2 import first_argmax, grouping_operation, knn_query
from ...sample import Sample
from ..base.base_model import Base3DModel
from ..layers.layer_libs import Sequential, default_generator
from ..transformers.transformer_layers import linear

__all__ = ["PAConv", "ScoreNet", "assign_score_withk",
           "assign_score_withk_plain"]


def _flat_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[B, N, K] per-cloud indices -> [B * N * K] rows of a [B * N, ...]
    table."""
    base = torch.arange(idx.shape[0], device=idx.device) * n
    return (idx.long() + base[:, None, None]).reshape(-1)


#: elements of one chunk's gathered [rows, M, C] block (256 MB in f32)
_CHUNK_ELEMS = 1 << 26


class _ScoredGather(torch.autograd.Function):
    """out[b, n, k] = sum_m scores[b, n, k, m] * trans[b, idx[b, n, k], m]
    for scores [B, N, K, M], trans [B, N, M, C], idx [B, N, K]: each
    (point, neighbour) row's M x C block gathered from the [B * N, M * C]
    table and weighted by a [1, M] x [M, C] product, in chunks of rows, so
    that no [B, N, K, M, C] tensor is kept; the backward gathers again for
    the scores' gradient and adds the scores' outer products with the
    cotangent into the table's rows (index_add_)."""

    @staticmethod
    def forward(ctx, scores, trans, idx):
        b, n, k, m = scores.shape
        c = trans.shape[-1]
        rows = _flat_rows(idx, n)
        table = trans.reshape(b * n, m * c)
        s = scores.reshape(b * n * k, 1, m)
        out = torch.empty((b * n * k, c), dtype=trans.dtype,
                          device=trans.device)
        step = max(_CHUNK_ELEMS // (m * c), 1)
        for lo in range(0, rows.numel(), step):
            hi = lo + step
            block = table.index_select(0, rows[lo:hi]).view(-1, m, c)
            out[lo:hi] = torch.bmm(s[lo:hi], block).squeeze(1)
        ctx.save_for_backward(scores, trans, rows)
        return out.view(b, n, k, c)

    @staticmethod
    def backward(ctx, grad):
        scores, trans, rows = ctx.saved_tensors
        b, n, k, m = scores.shape
        c = trans.shape[-1]
        g = grad.reshape(b * n * k, c)
        table = trans.reshape(b * n, m * c)
        s = scores.reshape(b * n * k, 1, m)
        d_scores = torch.empty((b * n * k, m), dtype=g.dtype,
                               device=g.device) \
            if ctx.needs_input_grad[0] else None
        d_table = torch.zeros((b * n, m * c), dtype=g.dtype,
                              device=g.device) \
            if ctx.needs_input_grad[1] else None
        step = max(_CHUNK_ELEMS // (m * c), 1)
        for lo in range(0, rows.numel(), step):
            hi = lo + step
            if d_scores is not None:
                block = table.index_select(0, rows[lo:hi]).view(-1, m, c)
                d_scores[lo:hi] = torch.bmm(block, g[lo:hi, :, None])[..., 0]
            if d_table is not None:
                d_table.index_add_(0, rows[lo:hi], (
                    s[lo:hi].transpose(1, 2) * g[lo:hi, None, :]).reshape(
                        -1, m * c))
        return (None if d_scores is None else d_scores.view(b, n, k, m),
                None if d_table is None else d_table.view(b, n, m, c), None)


def assign_score_withk(scores: torch.Tensor, point_feats: torch.Tensor,
                       center_feats: torch.Tensor, knn_idx: torch.Tensor,
                       weight_bank: torch.Tensor) -> torch.Tensor:
    """The JAX package's assign_score_withk, batched, in the transformed
    order. scores [B, N, K, M], point_feats / center_feats [B, N, Cin],
    knn_idx [B, N, K], weight_bank [M, Cin, Cout] -> [B, N, K, Cout]."""
    trans = torch.einsum("bnc,mcd->bnmd", point_feats, weight_bank)
    centre = trans if center_feats is point_feats else torch.einsum(
        "bnc,mcd->bnmd", center_feats, weight_bank)
    return (_ScoredGather.apply(scores, trans, knn_idx) -
            torch.einsum("bnkm,bnmd->bnkd", scores, centre))


def assign_score_withk_plain(scores: torch.Tensor, point_feats: torch.Tensor,
                             center_feats: torch.Tensor,
                             knn_idx: torch.Tensor,
                             weight_bank: torch.Tensor) -> torch.Tensor:
    """The same function in the JAX package's order (the neighbour minus
    the centre, transformed by every bank, then weighted): [B, N, K, M,
    Cout] materialised. The yardstick of assign_score_withk."""
    nbr = grouping_operation(point_feats, knn_idx)
    rel = nbr - center_feats[:, :, None, :]
    trans = torch.einsum("bnkc,mcd->bnkmd", rel, weight_bank)
    return torch.einsum("bnkm,bnkmd->bnkd", scores, trans)


class ScoreNet(nn.Module):
    """The MLP 7 -> hidden -> num_kernels (relu between, softmax over the
    kernels) on (xyz_rel, xyz_centre, distance)."""

    def __init__(self, num_kernels: int, hidden: Sequence[int] = (16, 16),
                 *, generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        dims = [7] + list(hidden) + [num_kernels]
        self.layers = nn.ModuleList([
            linear(dims[i], dims[i + 1], generator)
            for i in range(len(dims) - 1)])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return torch.softmax(x, dim=-1)


@manager.MODELS.add_component
class PAConv(Base3DModel):
    """Batch: `data` [B, N, 3] clouds (+ `labels` [B] to train).
    test_forward -> `logits` [B, num_classes], `pred` [B] (ties to the
    lowest class, as jnp.argmax). No BatchNorm: train and eval mode compute
    the same."""

    modality = "lidar"

    def __init__(self, num_classes: int = 40, k: int = 20,
                 num_kernels: int = 8,
                 channels: Sequence[int] = (64, 64, 128, 256),
                 label_smoothing: float = 0.2, pretrained: str = None,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.k = k
        self.num_classes = num_classes
        self.label_smoothing = label_smoothing
        self.pretrained = pretrained

        cin = 3
        self.score_nets = nn.ModuleList()
        self.weight_banks = nn.ParameterList()
        self.bns = nn.ModuleList()
        for cout in channels:
            self.score_nets.append(ScoreNet(num_kernels,
                                            generator=generator))
            bank = torch.randn((num_kernels, cin, cout),
                               generator=generator) / np.sqrt(cin)
            self.weight_banks.append(nn.Parameter(bank))
            # LayerNorm (nnx's eps 1e-6) in place of BatchNorm, as the
            # JAX package has it
            self.bns.append(nn.LayerNorm(cout, eps=1e-6))
            cin = cout
        self.classifier = Sequential(
            linear(sum(channels), 256, generator), nn.ReLU(),
            linear(256, num_classes, generator))

    def neighbours(self, points: torch.Tensor):
        """[B, N, 3] -> (knn idx [B, N, k] int32, ScoreNet's input [B, N,
        k, 7]: the neighbour's offset, the centre, the distance)."""
        b, n, _ = points.shape
        mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
        idx, _ = knn_query(self.k, points, points, mask)
        rel = grouping_operation(points, idx) - points[:, :, None, :]
        # the knn's squared distance, in the points' dtype: (dx² + dy²) + dz²
        d2 = (rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]) + \
            rel[..., 2] * rel[..., 2]
        score_in = torch.cat([
            rel, points[:, :, None, :].expand_as(rel),
            torch.sqrt(torch.clamp(d2, min=0.))[..., None]], dim=-1)
        return idx, score_in

    def features(self, points: torch.Tensor) -> torch.Tensor:
        """[B, N, 3] -> [B, sum(channels)] global features."""
        idx, score_in = self.neighbours(points)
        feats = points
        pooled = []
        for score_net, bank, bn in zip(self.score_nets, self.weight_banks,
                                       self.bns):
            scores = score_net(score_in)                   # [B, N, K, M]
            out = assign_score_withk(scores, feats, feats, idx,
                                     bank)                 # [B, N, K, C]
            out = torch.relu(bn(out.amax(dim=2)))   # max over neighbours
            feats = out
            pooled.append(out.amax(dim=1))
        return torch.cat(pooled, dim=-1)

    def train_forward(self, batch) -> dict:
        logits = self.classifier(self.features(batch["data"]))
        labels = batch["labels"].long()
        eps = self.label_smoothing
        onehot = F.one_hot(labels, self.num_classes).to(logits.dtype)
        smooth = onehot * (1 - eps) + (1 - onehot) * eps / (
            self.num_classes - 1)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.mean(torch.sum(smooth * logp, dim=-1))
        acc = torch.mean((first_argmax(logits) == labels).to(logits.dtype))
        return {"loss": loss, "acc": acc}

    def test_forward(self, batch) -> dict:
        logits = self.classifier(self.features(batch["data"]))
        return {"logits": logits, "pred": first_argmax(logits)}

    @staticmethod
    def postprocess_to_samples(outputs: dict, metas: list) -> list:
        """One lidar Sample a cloud: `labels` its predicted class, the
        meta's keys but `path` in its meta."""
        preds = np.asarray(torch.as_tensor(outputs["pred"]).cpu())
        out = []
        for i, meta in enumerate(metas):
            s = Sample(path=meta.get("path"), modality="lidar")
            s.labels = preds[i]
            s.meta.update({k: v for k, v in meta.items() if k != "path"})
            out.append(s)
        return out

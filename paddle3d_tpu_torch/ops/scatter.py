"""Scatter ops, torch port of paddle3d_tpu/ops/scatter.py: the pillar ->
BEV canvas placement (pillar_scatter) and the frustum -> BEV pool of the
camera models (bev_pool, bev_pool_sorted).

pillar_scatter and bev_pool_sorted reduce through
ops/sorted_scatter.sorted_segment_sum: on a CUDA tensor the hand-written
row-major segment sum, K7 for a dense scan and K2 for a sparse one (the JAX
package's density rule, `sorted_scatter.kernel_for`), with the sorted table
gather K5 as its VJP; on a CPU tensor their plain versions. bev_pool is the
plain scatter-add form, which has no kernel in the JAX package either.
"""
import torch

from . import sorted_scatter

__all__ = ["pillar_scatter", "bev_pool", "bev_pool_sorted", "sort_payloads",
           "rebuild_rows"]

SENT = 2**31 - 1        # the key of a dropped row: past every cell


def pillar_scatter(voxel_features: torch.Tensor, coords: torch.Tensor,
                   voxel_mask: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """Per-pillar features onto a dense BEV canvas.

    voxel_features [B, V, C]; coords [B, V, 3] int (z, y, x), sorted by
    y * nx + x among the valid voxels, which come first (the voxelizer's
    order); voxel_mask [B, V]. -> canvas [B, ny, nx, C] (NHWC, as in the
    JAX package)."""
    b, _, c = voxel_features.shape
    keys = torch.where(
        voxel_mask, coords[..., 1].to(torch.int32) * nx +
        coords[..., 2].to(torch.int32), SENT).to(torch.int32).contiguous()
    canvas = sorted_scatter.sorted_segment_sum(
        keys, voxel_features.contiguous(), ny * nx)
    return canvas.reshape(b, ny, nx, c)


def bev_pool(feats: torch.Tensor, ranks: torch.Tensor, valid: torch.Tensor,
             num_cells: int) -> torch.Tensor:
    """Sum the rows sharing a BEV cell rank (the bev_pool_v2 primitive,
    reference: paddle3d/ops/bev_pool_v2/bev_pool_cuda.cu:18).

    feats [N, C]; ranks [N] int; valid [N] bool. -> pooled [num_cells, C].
    A row that is not valid, or whose rank lies outside [0, num_cells),
    lands in a spill row that is sliced away. Autograd gives the backward
    (index_add_'s is a gather)."""
    c = feats.shape[1]
    inside = valid & (ranks >= 0) & (ranks < num_cells)
    idx = torch.where(inside, ranks, num_cells).long()
    out = feats.new_zeros((num_cells + 1, c))
    return out.index_add(0, idx, feats)[:num_cells]


def sort_payloads(pix: torch.Tensor, depth_w: torch.Tensor,
                  ranks: torch.Tensor, valid: torch.Tensor, dtype):
    """The first half of bev_pool_sorted: each batch row's scalar payloads
    by a stable sort of its keys (invalid rows keyed past every cell).

    pix [B, R] int; depth_w [B, R] float; ranks [B, R] int; valid [B, R]
    bool. -> (keys [B, R] int32 sorted, pixels [B, R] int64, depth weights
    [B, R] in dtype)."""
    key = torch.where(valid, ranks.to(torch.int32), SENT).to(torch.int32)
    keys, order = torch.sort(key, dim=-1, stable=True)
    spix = torch.gather(pix.long(), 1, order)
    # the weights travel as f32, as in the JAX package's sort (an f64 model
    # gets them rounded to f32 there too)
    sdep = torch.gather(depth_w.to(torch.float32), 1, order).to(dtype)
    return keys.contiguous(), spix, sdep


def rebuild_rows(feat_table: torch.Tensor, spix: torch.Tensor,
                 sdep: torch.Tensor) -> torch.Tensor:
    """The second half of bev_pool_sorted: the sorted rows
    feat_table[b, spix] * sdep, [B, R, C]."""
    c = feat_table.shape[-1]
    return torch.gather(feat_table, 1, spix[..., None].expand(-1, -1, c)) \
        * sdep[..., None]


def bev_pool_sorted(feat_table: torch.Tensor, pix: torch.Tensor,
                    depth_w: torch.Tensor, ranks: torch.Tensor,
                    valid: torch.Tensor, num_cells: int) -> torch.Tensor:
    """bev_pool in factored form: out[b, cell] = Σ depth_w · feat_table[b,
    pix] over the rows of that cell.

    Only the scalar payloads are sorted (rank, pixel, depth weight), each
    batch row by a stable sort of its keys (sort_payloads), so that the
    kernel and plain paths see one row order; the rows are rebuilt from the
    small per-pixel table by a gather (rebuild_rows) and reduced by the
    sorted segment sum (K7 or K2 forward, K5 backward on the card). The JAX
    package's sort is unstable: there the rows of a cell may be summed in
    another order.

    feat_table [B, Npix, C]; pix [B, R] int row index into Npix; depth_w
    [B, R] float; ranks [B, R] int cell ids; valid [B, R] bool.
    -> pooled [B, num_cells, C] in feat_table's dtype, differentiable in
    feat_table and depth_w."""
    keys, spix, sdep = sort_payloads(pix, depth_w, ranks, valid,
                                     feat_table.dtype)
    return sorted_scatter.sorted_segment_sum(
        keys, rebuild_rows(feat_table, spix, sdep), num_cells)

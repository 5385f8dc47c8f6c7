"""On-device CenterPoint target generation, torch port of
paddle3d_tpu/models/detection/centerpoint/centerpoint_target.py.

Gaussian heatmaps, centre indices, masks, labels and regression targets
from padded gt arrays, at fixed shapes and on the gt's device, with the
batch written out as a leading dimension (the JAX package vmaps a
per-scan function). Per task: each scan's member boxes move, in a stable
order, into the first of max_objs slots; the gaussians splat onto the
[B, H, W, C] heatmap by an elementwise max, _CHUNK objects at a time.
"""
from typing import Sequence

import numpy as np
import torch

__all__ = ["CenterPointTargetGenerator", "gaussian_radius"]

_CHUNK = 32


def gaussian_radius(height, width, min_overlap=0.5):
    """CornerNet radius rule, elementwise."""
    a1 = 1.
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1**2 - 4 * a1 * c1, min=0.))) / 2

    a2 = 4.
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2**2 - 4 * a2 * c2, min=0.))) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3**2 - 4 * a3 * c3, min=0.))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


class CenterPointTargetGenerator:
    def __init__(self,
                 tasks: Sequence[dict],
                 down_ratio: int,
                 point_cloud_range: Sequence[float],
                 voxel_size: Sequence[float],
                 gaussian_overlap: float = 0.1,
                 max_objs: int = 500,
                 min_radius: int = 2,
                 with_velocity: bool = False,
                 num_all_classes: int = None):
        self.tasks = tasks
        self.down_ratio = down_ratio
        self.gaussian_overlap = gaussian_overlap
        self.max_objs = max_objs
        self.min_radius = min_radius
        self.with_velocity = with_velocity
        self.vx, self.vy = float(voxel_size[0]), float(voxel_size[1])
        self.x_min, self.y_min = float(point_cloud_range[0]), float(
            point_cloud_range[1])
        gx = int(round((point_cloud_range[3] - point_cloud_range[0]) /
                       self.vx))
        gy = int(round((point_cloud_range[4] - point_cloud_range[1]) /
                       self.vy))
        self.fm_w = gx // down_ratio
        self.fm_h = gy // down_ratio

        # static per-task class maps: global label -> local channel (or -1)
        all_names = [n for t in tasks for n in t["class_names"]]
        if num_all_classes is None:
            num_all_classes = len(all_names)
        self.task_maps = []
        offset = 0
        for t in tasks:
            m = np.full(num_all_classes + 1, -1, np.int64)   # +1 pad slot
            for local, _ in enumerate(t["class_names"]):
                m[offset + local] = local
            self.task_maps.append(torch.from_numpy(m))
            offset += len(t["class_names"])

    @torch.no_grad()
    def __call__(self, gt_boxes: torch.Tensor, gt_labels: torch.Tensor):
        """gt_boxes [B, G, 7 (+2 velocity columns 7:9)], bottom z; gt_labels
        [B, G], -1 padded. Returns per task (heatmap [B, H, W, C],
        target_bbox [B, M, D], center_idx [B, M] int64, mask [B, M] bool,
        label [B, M] int64)."""
        return [self._task(gt_boxes, gt_labels,
                           cls_map.to(gt_labels.device),
                           len(task["class_names"]))
                for task, cls_map in zip(self.tasks, self.task_maps)]

    def _task(self, boxes, labels, cls_map, num_cls):
        b, g = labels.shape
        m = self.max_objs
        dev = boxes.device
        safe = torch.where(labels >= 0, labels.long(), cls_map.shape[0] - 1)
        local_cls = cls_map[safe]                         # [B, G], -1 if not
        member = local_cls >= 0

        # compact member boxes into the first slots (stable)
        order = torch.argsort((~member).to(torch.int32), dim=1, stable=True)
        take = order[:, :m] if g >= m else torch.cat(
            [order, order.new_zeros((b, m - g))], dim=1)
        slot_valid = torch.arange(m, device=dev)[None] < member.sum(
            dim=1, keepdim=True)
        sb = torch.gather(boxes, 1, take[..., None].expand(
            -1, -1, boxes.shape[-1]))                     # [B, M, 7+]
        scls = torch.gather(local_cls, 1, take)

        # feature-map geometry
        w_fm = sb[..., 3] / self.vx / self.down_ratio
        l_fm = sb[..., 4] / self.vy / self.down_ratio
        cx = (sb[..., 0] - self.x_min) / self.vx / self.down_ratio
        cy = (sb[..., 1] - self.y_min) / self.vy / self.down_ratio
        cx_int = torch.floor(cx).to(torch.int32)
        cy_int = torch.floor(cy).to(torch.int32)
        in_bounds = ((cx_int >= 0) & (cx_int < self.fm_w) & (cy_int >= 0)
                     & (cy_int < self.fm_h))
        valid = slot_valid & in_bounds & (w_fm > 0) & (l_fm > 0)

        radius = gaussian_radius(l_fm, w_fm, self.gaussian_overlap)
        radius = torch.clamp(torch.floor(radius).to(torch.int32),
                             min=self.min_radius)

        heatmap = self._splat(cx_int, cy_int, radius, scls, valid, num_cls)

        # regression targets (gt layout x, y, z bottom, w, l, h, yaw, vx, vy)
        z_center = sb[..., 2] + sb[..., 5] / 2
        angle = sb[..., 6]
        parts = [(cx - cx_int)[..., None], (cy - cy_int)[..., None],
                 z_center[..., None], torch.log(torch.clamp(sb[..., 3:6],
                                                            min=1e-4))]
        if self.with_velocity:
            parts.append(sb[..., 7:9])
        parts.extend([torch.sin(angle)[..., None],
                      torch.cos(angle)[..., None]])
        target_bbox = torch.where(valid[..., None], torch.cat(parts, dim=-1),
                                  0.)
        center_idx = torch.where(valid, cy_int * self.fm_w + cx_int,
                                 0).long()
        label = torch.where(valid, scls, 0)
        return heatmap, target_bbox, center_idx, valid, label

    def _splat(self, cx_int, cy_int, radius, cls, valid, num_cls):
        """Max-accumulate the objects' gaussians onto [B, H, W, C]."""
        b, m = cx_int.shape
        dev = cx_int.device
        ys = torch.arange(self.fm_h, dtype=torch.float32, device=dev)[:, None]
        xs = torch.arange(self.fm_w, dtype=torch.float32, device=dev)[None]
        hm = torch.zeros((b, self.fm_h, self.fm_w, num_cls),
                         dtype=torch.float32, device=dev)
        onehot = torch.nn.functional.one_hot(
            cls.clamp(min=0).long(), num_cls).to(torch.float32) * (
                cls >= 0)[..., None]
        for lo in range(0, m, _CHUNK):
            sl = slice(lo, lo + _CHUNK)
            ccx = cx_int[:, sl, None, None].to(torch.float32)
            ccy = cy_int[:, sl, None, None].to(torch.float32)
            cr = radius[:, sl, None, None]
            dx = xs - ccx                                   # [B, K, 1, W]
            dy = ys - ccy                                   # [B, K, H, 1]
            sigma = (2 * cr.to(torch.float32) + 1) / 6.
            gauss = torch.exp(-(dx**2 + dy**2) / (2 * sigma**2))
            window = ((torch.abs(dx) <= cr) & (torch.abs(dy) <= cr) &
                      valid[:, sl, None, None])
            gauss = torch.where(window, gauss, 0.)          # [B, K, H, W]
            per_cls = torch.amax(gauss[..., None] *
                                 onehot[:, sl, None, None, :], dim=1)
            hm = torch.maximum(hm, per_cls)
        return hm

"""Apollo 3D-lane dataset and F-score metric, a copy of
paddle3d_tpu/datasets/apollo/apollo_lane.py (reference:
paddle3d/datasets/apollo/apollo_lane_det.py:37 ApolloOffsetDataset and
apollo_lane_metric.py: the same jsonl labels; the reference's min-cost-flow
lane matching is a greedy chamfer match at the same 1.5 m threshold).

Label file: one json a line with
    raw_file: the image path under the root
    laneLines: [K, 3] (x, y, z) lane polylines in ego space, a list
    cam_intrinsics [3, 3] / cam_extrinsics [4, 4] (optional)
Targets are BEV-LaneDet grids: confidence / lateral offset / height /
instance id over a (bev_h x bev_w) grid over x in [3, 103] m and y in
[-10, 10] m by default. The image is read by the port's decoders
(utils/image.read_image, JPEG or PNG by signature) and resized with
Pillow's default BICUBIC (utils/image.resize), in place of Pillow.
"""
import json
import os
from typing import List

import numpy as np

from ...apis import manager
from ...sample import Sample
from ...utils.image import BICUBIC, read_image, resize
from ..base import BaseDataset, MetricABC

__all__ = ["ApolloLaneDataset", "ApolloLaneMetric"]


@manager.DATASETS.add_component
class ApolloLaneDataset(BaseDataset):
    def __init__(self, dataset_root: str, anno_file: str,
                 mode: str = "train", image_size=(576, 1024),
                 x_range=(3.0, 103.0), y_range=(-10.0, 10.0),
                 bev_size=(100, 25), max_lanes: int = 8):
        self.dataset_root = dataset_root
        self.mode = mode
        self.image_size = tuple(image_size)
        self.x_range = x_range
        self.y_range = y_range
        self.bev_h, self.bev_w = bev_size
        self.max_lanes = max_lanes
        with open(os.path.join(dataset_root, anno_file)) as f:
            self.annos = [json.loads(l) for l in f if l.strip()]

    def __len__(self):
        return len(self.annos)

    def lane_points(self, index: int) -> List[np.ndarray]:
        return [np.asarray(l, np.float32).reshape(-1, 3)
                for l in self.annos[index]["laneLines"]]

    def __getitem__(self, index: int) -> Sample:
        anno = self.annos[index]
        sample = Sample(
            path=os.path.join(self.dataset_root, anno["raw_file"]),
            modality="image")
        sample.meta.id = index
        h, w = self.image_size
        sample.data = resize(read_image(sample.path), (w, h),
                             BICUBIC).astype(np.float32)

        # BEV grid targets
        hb, wb = self.bev_h, self.bev_w
        conf = np.zeros((hb, wb), np.float32)
        offset = np.zeros((hb, wb), np.float32)
        height = np.zeros((hb, wb), np.float32)
        inst = np.zeros((hb, wb), np.int32)
        dx = (self.x_range[1] - self.x_range[0]) / hb
        dy = (self.y_range[1] - self.y_range[0]) / wb
        for li, lane in enumerate(self.lane_points(index)[:self.max_lanes]):
            for p in lane:
                r = int((p[0] - self.x_range[0]) / dx)
                c = (p[1] - self.y_range[0]) / dy
                ci = int(c)
                if 0 <= r < hb and 0 <= ci < wb:
                    conf[r, ci] = 1.0
                    offset[r, ci] = c - ci
                    height[r, ci] = p[2]
                    inst[r, ci] = li + 1
        sample.lane_conf = conf
        sample.lane_offset = offset
        sample.lane_height = height
        sample.lane_instance = inst
        # identity image->BEV grid placeholder; a virtual-camera homography
        # can be precomputed per-camera and stored in the anno
        gy, gx = np.meshgrid(np.linspace(0, 1, hb), np.linspace(0, 1, wb),
                             indexing="ij")
        sample.bev_grid = np.stack([gx, 1 - gy], axis=-1).astype(np.float32)
        return sample

    def collate_fn(self, samples: List[Sample]):
        batch = {
            "data": np.stack([s.data for s in samples]),
            "bev_grid": np.stack([s.bev_grid for s in samples]),
            "lane_conf": np.stack([s.lane_conf for s in samples]),
            "lane_offset": np.stack([s.lane_offset for s in samples]),
            "lane_height": np.stack([s.lane_height for s in samples]),
            "lane_instance": np.stack([s.lane_instance for s in samples]),
        }
        metas = [{"path": s.path, "id": s.meta.get("id")} for s in samples]
        return batch, metas

    @property
    def metric(self) -> "ApolloLaneMetric":
        return ApolloLaneMetric(self)


class ApolloLaneMetric(MetricABC):
    """Lane F-score: predicted lane polylines (decoded from the BEV grids)
    match gt lanes when >=75% of sampled points are within 1.5 m."""

    def __init__(self, dataset, dist_thresh: float = 1.5,
                 match_ratio: float = 0.75):
        self.dataset = dataset
        self.dist_thresh = dist_thresh
        self.match_ratio = match_ratio
        self._tp = 0
        self._n_pred = 0
        self._n_gt = 0

    def _decode_lanes(self, pred: Sample) -> List[np.ndarray]:
        """Group confident cells into lanes via embedding proximity."""
        ds = self.dataset
        conf = pred.lane_conf > 0.5
        if not conf.any():
            return []
        emb = pred.lane_embed
        ys, xs = np.nonzero(conf)
        feats = emb[ys, xs]
        lanes, centers = [], []
        for y, x, f in zip(ys, xs, feats):
            for li, c in enumerate(centers):
                if np.linalg.norm(f - c) < 1.5:
                    lanes[li].append((y, x))
                    centers[li] = centers[li] * 0.9 + f * 0.1
                    break
            else:
                lanes.append([(y, x)])
                centers.append(f.copy())
        dx = (ds.x_range[1] - ds.x_range[0]) / ds.bev_h
        dy = (ds.y_range[1] - ds.y_range[0]) / ds.bev_w
        out = []
        for cells in lanes:
            pts = np.array([
                [ds.x_range[0] + (y + 0.5) * dx,
                 ds.y_range[0] + (x + pred.lane_offset[y, x]) * dy,
                 pred.lane_height[y, x]] for y, x in cells
            ], np.float32)
            out.append(pts)
        return out

    def update(self, predictions: List[Sample], ground_truths=None):
        for pred in predictions:
            gt_lanes = self.dataset.lane_points(pred.meta.get("id"))
            pred_lanes = self._decode_lanes(pred)
            self._n_gt += len(gt_lanes)
            self._n_pred += len(pred_lanes)
            taken = set()
            for pl in pred_lanes:
                best, best_score = None, 0.
                for gi, gl in enumerate(gt_lanes):
                    if gi in taken or len(gl) == 0:
                        continue
                    d = np.linalg.norm(
                        pl[:, None, :2] - gl[None, :, :2], axis=-1)
                    ratio = float((d.min(axis=1) <
                                   self.dist_thresh).mean())
                    if ratio > best_score:
                        best, best_score = gi, ratio
                if best is not None and best_score >= self.match_ratio:
                    taken.add(best)
                    self._tp += 1

    def compute(self, verbose: bool = False) -> dict:
        precision = self._tp / max(self._n_pred, 1)
        recall = self._tp / max(self._n_gt, 1)
        f = 2 * precision * recall / max(precision + recall, 1e-9)
        return {"F-score": f, "precision": precision, "recall": recall}

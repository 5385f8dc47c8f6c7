"""Waymo Open Dataset point-cloud detection, a copy of
paddle3d_tpu/datasets/waymo/waymo_det.py (reference:
paddle3d/datasets/waymo/waymo_det.py / waymo_pointcloud_det.py:31).

Raw Waymo ships as TFRecord protos that need the waymo-open-dataset and
TensorFlow stack (the reference has the same external dependency for
tools/create_waymo_infos.py). This loader reads the CONVERTED form that
tool produces: per-frame .npy (or .bin) point clouds and an info pkl with
lidar-frame boxes. The metric is a clean-room L1 / L2 AP in the Waymo style
(difficulty by points in the box, BEV-IoU matching); the official metric
needs the TF evaluator, which the reference also shells out to
(waymo_metric.py:20-30).

Expected layout:
    {root}/{mode}_infos.pkl  — list of dicts:
        lidar_file (relative .npy or .bin [N, >=4]),
        boxes [G, 7] (x, y, z_bottom, w, l, h, yaw),
        labels [G] (0 Vehicle / 1 Pedestrian / 2 Cyclist),
        num_points_in_gt [G], frame_id
    {root}/points/...

One repair: the JAX dataset sets `sample.data` itself, so the LoadPointCloud
that starts iassd_waymo.yml's pipelines raises "sample.data already set"
(and its np.fromfile would misread a .npy). Here a pipeline that starts
with LoadPointCloud reads the points (the port's LoadPointCloud reads .npy
too); without one the dataset loads them, as the JAX one does. As
KittiPCDataset, `ds[i]` is `ds.get(i)` under `transforms.sample_rng(0, 0,
i)`; the DataLoader hands each sample the generator of its seed, epoch and
index.
"""
import os
import pickle
from typing import List

import numpy as np

from ...apis import manager
from ...geometries import BBoxes3D, CoordMode
from ...geometries.bbox import rotated_iou_2d
from ...sample import Sample
from ...transforms.base import sample_rng
from ..base import BaseDataset, MetricABC

__all__ = ["WaymoPCDataset", "WaymoMetric"]

CLASS_NAMES = ["Vehicle", "Pedestrian", "Cyclist"]
IOU_THRESH = {"Vehicle": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}


@manager.DATASETS.add_component
class WaymoPCDataset(BaseDataset):
    max_points = 180000
    max_gt_boxes = 256
    point_dim = 4

    def __init__(self, dataset_root: str, mode: str = "train",
                 class_names: List[str] = None, transforms=None):
        self.dataset_root = dataset_root
        self.mode = mode
        self.class_names = class_names or CLASS_NAMES
        if isinstance(transforms, list):
            from ...transforms import Compose
            transforms = Compose(transforms)
        self.transforms = transforms
        with open(os.path.join(dataset_root,
                               "{}_infos.pkl".format(mode)), "rb") as f:
            self.infos = pickle.load(f)

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index: int) -> Sample:
        return self.get(index)

    def _loads_points(self) -> bool:
        """Whether the pipeline starts with a LoadPointCloud."""
        from ...transforms import LoadPointCloud
        ts = getattr(self.transforms, "transforms", None) or []
        return bool(ts) and isinstance(ts[0], LoadPointCloud)

    def get(self, index: int, rng: np.random.RandomState = None) -> Sample:
        info = self.infos[index]
        path = os.path.join(self.dataset_root, info["lidar_file"])
        sample = Sample(path=path, modality="lidar")
        sample.meta.id = info.get("frame_id", index)
        sample.rng = sample_rng(0, 0, index) if rng is None else rng
        if not self._loads_points():
            sample.data = (np.load(path).astype(np.float32)
                           if path.endswith(".npy") else
                           np.fromfile(path, np.float32).reshape(
                               -1, self.point_dim))
        if not self.is_test_mode:
            boxes = np.asarray(info["boxes"], np.float32).reshape(-1, 7)
            labels = np.asarray(info["labels"], np.int32)
            keep = np.isin(
                [self.class_names[l] if l < len(self.class_names) else ""
                 for l in labels], self.class_names)
            sample.bboxes_3d = BBoxes3D(
                boxes[keep], coordmode=CoordMode.NuScenesLidar,
                origin=[.5, .5, 0.])
            sample.labels = labels[keep]
            sample.num_points_in_gt = np.asarray(
                info.get("num_points_in_gt",
                         np.full(len(labels), 6)))[keep]
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample

    @property
    def metric(self) -> "WaymoMetric":
        return WaymoMetric(self)


class WaymoMetric(MetricABC):
    """L1 (>5 pts) / L2 (all) AP per class with BEV rotated-IoU matching —
    the Waymo protocol's difficulty split, 100-point interpolated AP."""

    def __init__(self, dataset):
        self.dataset = dataset
        self._preds = {}

    def update(self, predictions: List[Sample], ground_truths=None):
        for p in predictions:
            self._preds[p.meta.get("id")] = p

    def compute(self, verbose: bool = False) -> dict:
        results = {}
        for ci, cls_name in enumerate(self.dataset.class_names):
            for level in ("L1", "L2"):
                tps, hs, scores, n_gt = [], [], [], 0
                for idx in range(len(self.dataset)):
                    info = self.dataset.infos[idx]
                    gt_boxes = np.asarray(info["boxes"],
                                          np.float32).reshape(-1, 7)
                    gt_labels = np.asarray(info["labels"], np.int32)
                    npts = np.asarray(
                        info.get("num_points_in_gt",
                                 np.full(len(gt_labels), 6)))
                    sel = gt_labels == ci
                    if level == "L1":
                        sel = sel & (npts > 5)
                    gt = gt_boxes[sel]
                    n_gt += len(gt)
                    pred = self._preds.get(info.get("frame_id", idx))
                    if pred is None or pred.bboxes_3d is None or \
                            len(pred.bboxes_3d) == 0:
                        continue
                    pb = np.asarray(pred.bboxes_3d)
                    pl = np.asarray(pred.labels)
                    pc = np.asarray(pred.confidences)
                    m = pl == ci
                    pb, pc = pb[m], pc[m]
                    if len(pb) == 0:
                        continue
                    order = np.argsort(-pc)
                    pb, pc = pb[order], pc[order]
                    if len(gt):
                        iou = rotated_iou_2d(pb[:, [0, 1, 3, 4, 6]],
                                             gt[:, [0, 1, 3, 4, 6]])
                    taken = set()
                    for di in range(len(pb)):
                        hit = 0
                        h = 0.0
                        if len(gt):
                            j = int(np.argmax(
                                np.where([g in taken for g in
                                          range(len(gt))], -1, iou[di])))
                            if iou[di, j] >= IOU_THRESH[cls_name] and \
                                    j not in taken:
                                taken.add(j)
                                hit = 1
                                # heading accuracy (official APH weight):
                                # 1 - min(|dyaw|, 2pi-|dyaw|)/pi
                                dy = abs(float(pb[di, 6] - gt[j, 6]))
                                dy = min(dy % (2 * np.pi),
                                         2 * np.pi - dy % (2 * np.pi))
                                h = max(0.0, 1.0 - dy / np.pi)
                        tps.append(hit)
                        hs.append(h)
                        scores.append(pc[di])
                if n_gt == 0:
                    continue
                order = np.argsort(-np.asarray(scores)) if scores else []

                def interp_ap(weights):
                    tp = (np.cumsum(np.asarray(weights, float)[order])
                          if len(order) else np.zeros(1))
                    fp_denom = np.arange(1, len(tp) + 1)
                    recall = tp / n_gt
                    precision = tp / np.maximum(fp_denom, 1e-9)
                    rec_i = np.linspace(0, 1, 101)
                    prec_i = np.interp(rec_i, recall, precision, right=0)
                    for t in range(len(prec_i)):
                        prec_i[t] = prec_i[t:].max()
                    return float(prec_i.mean() * 100)

                results["{} {} AP".format(cls_name, level)] = \
                    interp_ap(tps)
                # APH: every TP weighted by its heading accuracy in both
                # the precision and recall numerators (Waymo protocol)
                results["{} {} APH".format(cls_name, level)] = \
                    interp_ap(hs)
        if verbose:
            from ...utils.logger import logger
            for k in sorted(results):
                logger.info("{}: {:.2f}".format(k, results[k]))
        return results

"""KITTI metric, a copy of paddle3d_tpu/datasets/kitti/kitti_metric.py
(reference: paddle3d/datasets/kitti/kitti_metric.py:30).

Collects prediction Samples (lidar-frame boxes), converts them back to the
camera frame via each image's calibration, and runs the AP evaluator.
"""
from typing import Dict, List

import numpy as np

from ...sample import Sample
from ..base import MetricABC
from . import eval as kitti_eval_lib
from . import kitti_utils

__all__ = ["KittiMetric"]


class KittiMetric(MetricABC):
    def __init__(self, groundtruths: List[dict], classmap: Dict[int, str],
                 calibs: List[kitti_utils.Calibration], ids: List[str],
                 metrics=("bev", "3d"), compute_aos: bool = False):
        self.gt_annos = groundtruths
        self.classmap = classmap
        self.calibs = calibs
        self.ids = list(ids)
        self.id_to_index = {i: n for n, i in enumerate(self.ids)}
        self.metric_ids = [
            {"bbox": 0, "bev": 1, "3d": 2}[m] for m in metrics
        ]
        # AOS rides on the bbox matching (reference kitti_metric.py:303)
        self.compute_aos = compute_aos and 0 in self.metric_ids
        self.predictions: Dict[int, dict] = {}

    def _pred_sample_to_anno(self, pred: Sample, index: int) -> dict:
        calib = self.calibs[index]
        if pred.bboxes_3d is None or len(pred.bboxes_3d) == 0:
            return {
                "name": np.array([]),
                "truncated": np.zeros(0, np.float32),
                "occluded": np.zeros(0, np.float32),
                "alpha": np.zeros(0, np.float32),
                "bbox": np.zeros((0, 4), np.float32),
                "dimensions": np.zeros((0, 3), np.float32),
                "location": np.zeros((0, 3), np.float32),
                "rotation_y": np.zeros(0, np.float32),
                "score": np.zeros(0, np.float32),
            }
        boxes = np.asarray(pred.bboxes_3d)
        if getattr(pred, "frame", "lidar") == "camera":
            # mono models predict directly in the rectified camera frame:
            # (x, y_bottom, z, h, w, l, ry)
            cam = {
                "location": boxes[:, 0:3].astype(np.float32),
                "dimensions": boxes[:, 3:6].astype(np.float32),
                "rotation_y": boxes[:, 6].astype(np.float32),
                "bbox": np.asarray(
                    getattr(pred, "bboxes_2d", np.zeros(
                        (len(boxes), 4)))).astype(np.float32),
            }
        else:
            cam = kitti_utils.lidar_boxes_to_camera_anno(boxes, calib)
        names = np.array(
            [self.classmap[int(l)] for l in np.asarray(pred.labels)])
        return {
            "name": names,
            "truncated": np.zeros(len(names), np.float32),
            "occluded": np.zeros(len(names), np.float32),
            "alpha": np.asarray(
                getattr(pred, "alpha", np.zeros(len(names)))).astype(
                    np.float32),
            "bbox": cam["bbox"],
            "dimensions": cam["dimensions"],
            "location": cam["location"],
            "rotation_y": cam["rotation_y"],
            "score": np.asarray(pred.confidences).astype(np.float32),
        }

    def update(self, predictions: List[Sample], ground_truths=None):
        for pred in predictions:
            idx = self.id_to_index[pred.meta.id]
            self.predictions[idx] = self._pred_sample_to_anno(pred, idx)

    def compute(self, verbose: bool = False) -> dict:
        dt_annos = []
        for i in range(len(self.gt_annos)):
            dt_annos.append(
                self.predictions.get(i) or self._pred_sample_to_anno(
                    Sample(path=None, modality="lidar"), i))
        classes = list(self.classmap.values())
        raw = kitti_eval_lib.kitti_eval(
            self.gt_annos, dt_annos, classes, metrics=self.metric_ids,
            compute_aos=self.compute_aos)
        out = {}
        for cls_name, per_metric in raw.items():
            for mname, per_diff in per_metric.items():
                for dname, (ap11, ap40) in per_diff.items():
                    out["{} {} {} AP_R11".format(cls_name, mname,
                                                 dname)] = ap11
                    out["{} {} {} AP_R40".format(cls_name, mname,
                                                 dname)] = ap40
        if verbose:
            from ...utils.logger import logger
            for k in sorted(out):
                logger.info("{}: {:.2f}".format(k, out[k]))
        return out

"""nuScenes detection metric, a copy of
paddle3d_tpu/datasets/nuscenes/nuscenes_metric.py: a clean-room
implementation of the official protocol (the reference calls nuscenes-devkit,
paddle3d/datasets/nuscenes/nuscenes_metric.py:38; the devkit is not a
dependency, so the published algorithm is implemented directly):

  * per class, per center-distance threshold d in {0.5, 1, 2, 4} m: greedy
    score-ordered matching in the BEV plane, AP = normalized area of the
    (precision, recall) curve above (0.1, 0.1);
  * TP errors at d = 2 m: ATE (center distance), ASE (1 - aligned 3D IoU),
    AOE (yaw diff, period 2pi; pi for barriers), AVE (velocity L2),
    AAE (1 - attribute accuracy); each is the devkit's recall-averaged
    cumulative mean over [min_recall, max_recall], not a plain mean;
  * devkit exclusions: traffic_cone has no AOE/AVE/AAE, barrier no AVE/AAE;
  * predicted attributes follow the reference's velocity rule when the model
    does not emit them (reference: nuscenes_metric.py:242-261);
  * NDS = (5 * mAP + sum_tp (1 - min(1, err))) / 10.

Evaluation happens in the lidar frame (predictions and gt share it), which
is distance-preserving vs. the devkit's global frame.
"""
from typing import Dict, List

import numpy as np

from ...sample import Sample
from ..base import MetricABC

__all__ = ["NuScenesMetric"]

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1

CLASS_RANGES = {
    "car": 50, "truck": 50, "bus": 50, "trailer": 50,
    "construction_vehicle": 50, "pedestrian": 40, "motorcycle": 40,
    "bicycle": 40, "traffic_cone": 30, "barrier": 30,
}
# devkit: metrics that are undefined for a class are skipped entirely
TP_METRICS = ("trans", "scale", "orient", "vel", "attr")
CLASS_TP_SKIP = {
    "traffic_cone": ("orient", "vel", "attr"),
    "barrier": ("vel", "attr"),
}
PERIOD_PI = ("barrier",)

DEFAULT_ATTRIBUTE = {
    "car": "vehicle.parked", "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked", "truck": "vehicle.parked",
    "bus": "vehicle.moving", "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider", "barrier": "", "traffic_cone": "",
}


def default_attribute(name: str, velocity) -> str:
    """Velocity-based attribute rule (reference: nuscenes_metric.py:242)."""
    if np.hypot(velocity[0], velocity[1]) > 0.2:
        if name in ("car", "construction_vehicle", "bus", "truck",
                    "trailer"):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
        return DEFAULT_ATTRIBUTE.get(name, "")
    if name == "pedestrian":
        return "pedestrian.standing"
    if name == "bus":
        return "vehicle.stopped"
    return DEFAULT_ATTRIBUTE.get(name, "")


def _aligned_iou_3d(dims_a, dims_b):
    """1 - IoU of axis-aligned, center-aligned boxes (ASE)."""
    inter = np.prod(np.minimum(dims_a, dims_b))
    union = np.prod(dims_a) + np.prod(dims_b) - inter
    return 1.0 - inter / max(union, 1e-9)


def _yaw_diff(a, b, period=2 * np.pi):
    d = abs(a - b) % period
    return min(d, period - d)


def _cummean(x: np.ndarray) -> np.ndarray:
    """devkit cummean: nan-aware cumulative mean (all-nan -> ones)."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    sums = np.nancumsum(x.astype(float))
    counts = np.cumsum(~np.isnan(x))
    return np.divide(sums, counts, out=np.zeros_like(sums),
                     where=counts != 0)


class NuScenesMetric(MetricABC):
    def __init__(self, dataset, class_names: List[str] = None):
        self.dataset = dataset
        self.class_names = class_names or dataset.class_names
        self._preds: Dict[str, dict] = {}

    def update(self, predictions: List[Sample], ground_truths=None):
        for pred in predictions:
            token = pred.meta.get("id")
            boxes = (np.asarray(pred.bboxes_3d)
                     if pred.bboxes_3d is not None else np.zeros((0, 7)))
            vel = getattr(pred.bboxes_3d, "velocities", None) \
                if pred.bboxes_3d is not None else None
            self._preds[token] = {
                "boxes": boxes.reshape(-1, boxes.shape[-1] if len(boxes)
                                       else 7),
                "vel": (np.asarray(vel) if vel is not None else
                        np.zeros((len(boxes), 2))),
                "labels": np.asarray(pred.labels).astype(int),
                "scores": np.asarray(pred.confidences),
                "attrs": getattr(pred, "pred_attrs", None),
            }

    def _gather(self):
        """-> per-class lists of gt (sample, box, attr) and
        dt (sample, box, vel, score, attr)."""
        gts, dts = {}, {}
        for c in self.class_names:
            gts[c] = []
            dts[c] = []
        for si, token in enumerate(self.dataset.sample_tokens):
            boxes, labels, names, num_pts, attrs = \
                self.dataset.annotations(token)
            for b, l, nm, npt, at in zip(boxes, labels, names, num_pts,
                                         attrs):
                rng = CLASS_RANGES.get(nm, 50)
                if np.hypot(b[0], b[1]) > rng or npt == 0:
                    continue
                gts[nm].append((si, b, at))
            pred = self._preds.get(token)
            if pred is None:
                continue
            pattrs = pred["attrs"]
            for k, (b, v, l, s) in enumerate(zip(
                    pred["boxes"], pred["vel"], pred["labels"],
                    pred["scores"])):
                nm = self.class_names[l]
                if np.hypot(b[0], b[1]) > CLASS_RANGES.get(nm, 50):
                    continue
                at = (pattrs[k] if pattrs is not None
                      else default_attribute(nm, v))
                dts[nm].append((si, b, v, s, at))
        return gts, dts

    def _eval_class(self, gt_list, dt_list, cls_name, dist_th):
        """-> (ap, tp_errors dict) for one (class, threshold).

        TP errors use the devkit recipe: cumulative means of per-match
        errors, interpolated onto the 101-point recall grid via confidence,
        then averaged over [min_recall, max_recall]."""
        npos = len(gt_list)
        if npos == 0:
            return np.nan, None
        dt_sorted = sorted(dt_list, key=lambda x: -x[3])
        taken = set()
        tp, fp, conf = [], [], []
        match_err = {k: [] for k in TP_METRICS}
        match_conf = []
        period = np.pi if cls_name in PERIOD_PI else 2 * np.pi
        for si, box, vel, score, attr in dt_sorted:
            best, best_d = None, dist_th
            for gi, (gsi, gbox, gattr) in enumerate(gt_list):
                if gsi != si or gi in taken:
                    continue
                d = np.hypot(box[0] - gbox[0], box[1] - gbox[1])
                if d < best_d:
                    best, best_d = gi, d
            if best is not None:
                taken.add(best)
                tp.append(1)
                fp.append(0)
                gbox, gattr = gt_list[best][1], gt_list[best][2]
                match_err["trans"].append(best_d)
                match_err["scale"].append(
                    _aligned_iou_3d(box[3:6], gbox[3:6]))
                match_err["orient"].append(
                    _yaw_diff(box[6], gbox[6], period))
                gvel = gbox[7:9] if len(gbox) > 7 else np.zeros(2)
                match_err["vel"].append(
                    float(np.linalg.norm(vel[:2] - gvel)))
                # devkit attr_acc: nan when the GT has no attribute
                match_err["attr"].append(
                    np.nan if gattr == "" else float(gattr != attr))
                match_conf.append(score)
            else:
                tp.append(0)
                fp.append(1)
            conf.append(score)
        if not any(tp):
            return 0.0, None
        tp = np.cumsum(tp).astype(float)
        fp = np.cumsum(fp).astype(float)
        conf = np.asarray(conf, float)
        recall = tp / npos
        precision = tp / (tp + fp)
        # 101-point interpolated AP above (0.1, 0.1)
        rec_interp = np.linspace(0, 1, 101)
        prec_at = np.interp(rec_interp, recall, precision, right=0)
        conf_at = np.interp(rec_interp, recall, conf, right=0)
        ap = float(np.maximum(prec_at[rec_interp >= MIN_RECALL]
                              - MIN_PRECISION, 0).mean()
                   / (1 - MIN_PRECISION))

        match_conf = np.asarray(match_conf, float)
        errors = {}
        first_ind = round(100 * MIN_RECALL) + 1
        last_ind = int(np.searchsorted(rec_interp, recall[-1], "right")) - 1
        for k in TP_METRICS:
            if last_ind < first_ind:
                errors[k] = 1.0
                continue
            cm = _cummean(np.asarray(match_err[k], float))
            # interpolate cummean curve onto the recall grid via confidence
            # (devkit accumulate(): conf is descending, np.interp wants
            # ascending x)
            curve = np.interp(conf_at[::-1], match_conf[::-1],
                              cm[::-1])[::-1]
            errors[k] = float(np.mean(curve[first_ind:last_ind + 1]))
        return ap, errors

    def compute(self, verbose: bool = False) -> dict:
        gts, dts = self._gather()
        aps = []
        tp_errors = {k: [] for k in TP_METRICS}
        per_class = {}
        for cls_name in self.class_names:
            cls_aps = []
            for dist_th in DIST_THRESHOLDS:
                ap, errs = self._eval_class(gts[cls_name], dts[cls_name],
                                            cls_name, dist_th)
                if not np.isnan(ap):
                    cls_aps.append(ap)
                if dist_th == TP_THRESHOLD:
                    skip = CLASS_TP_SKIP.get(cls_name, ())
                    for k in TP_METRICS:
                        if k in skip:
                            continue
                        # devkit: no GT for the class -> metric undefined
                        # (skipped); matched errors default to 1.0 inside
                        # _eval_class when recall never reaches min_recall
                        if errs is not None:
                            tp_errors[k].append(errs[k])
                        elif len(gts[cls_name]) > 0:
                            tp_errors[k].append(1.0)
            if cls_aps:
                per_class[cls_name] = float(np.mean(cls_aps))
                aps.append(per_class[cls_name])
        mean_ap = float(np.mean(aps)) if aps else 0.0
        tp_scores = []
        names = {"trans": "mATE", "scale": "mASE", "orient": "mAOE",
                 "vel": "mAVE", "attr": "mAAE"}
        out = {"mAP": mean_ap}
        for k in TP_METRICS:
            vals = tp_errors[k]
            err = float(np.mean(vals)) if vals else 1.0
            out[names[k]] = err
            tp_scores.append(max(0.0, 1.0 - err))
        out["NDS"] = float((5 * mean_ap + sum(tp_scores)) / 10.0)
        out.update({"AP_{}".format(k): v for k, v in per_class.items()})
        if verbose:
            from ...utils.logger import logger
            for k in sorted(out):
                logger.info("{}: {:.4f}".format(k, out[k]))
        return out

"""KITTI detection AP evaluator, a copy of paddle3d_tpu/datasets/kitti/eval.py.

A clean-room numpy implementation of the
official devkit protocol (the reference vendors a numba version at
paddle3d/thirdparty/kitti_object_eval_python/eval.py; this is an independent
numpy implementation of the same published algorithm: difficulty filtering,
per-gt greedy max-score matching, 41-point recall-sampled thresholds,
R11/R40 interpolated AP over bbox / BEV / 3D IoU).

All geometry is evaluated in the rectified camera frame, matching the
official devkit (BEV = x-z plane, y down).
"""
from typing import Dict, List, Sequence

import numpy as np

from ...geometries.bbox import rotated_iou_2d

N_SAMPLE_PTS = 41

# official difficulty gates
MIN_HEIGHT = (40.0, 25.0, 25.0)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)

# class -> (bbox, bev, 3d) min IoU
DEFAULT_OVERLAPS = {
    "Car": (0.7, 0.7, 0.7),
    "Van": (0.7, 0.7, 0.7),
    "Truck": (0.7, 0.7, 0.7),
    "Pedestrian": (0.5, 0.5, 0.5),
    "Person_sitting": (0.5, 0.5, 0.5),
    "Cyclist": (0.5, 0.5, 0.5),
    "Tram": (0.7, 0.7, 0.7),
}

# class that also matches (ignored, not FP) when evaluating key class
NEIGHBOR_CLASSES = {
    "Car": ("Van",),
    "Pedestrian": ("Person_sitting",),
}

METRIC_BBOX, METRIC_BEV, METRIC_3D = 0, 1, 2


def image_box_overlap(a: np.ndarray, b: np.ndarray,
                      criterion: int = -1) -> np.ndarray:
    """[N,4] x [M,4] 2D IoU (x1,y1,x2,y2)."""
    n, m = a.shape[0], b.shape[0]
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    if criterion == 0:
        denom = np.broadcast_to(area_a, inter.shape)
    elif criterion == 1:
        denom = np.broadcast_to(area_b, inter.shape)
    else:
        denom = area_a + area_b - inter
    return (inter / np.maximum(denom, 1e-9)).astype(np.float32)


def _camera_bev_boxes(anno: dict) -> np.ndarray:
    """camera-frame rows -> [N,5] (x, z, l, w, ry) BEV boxes."""
    loc = anno["location"]
    dims = anno["dimensions"]  # (h, w, l)
    if len(loc) == 0:
        return np.zeros((0, 5), np.float32)
    return np.stack(
        [loc[:, 0], loc[:, 2], dims[:, 2], dims[:, 1], anno["rotation_y"]],
        axis=1).astype(np.float32)


def _overlap_matrix(gt: dict, dt: dict, metric: int) -> np.ndarray:
    if metric == METRIC_BBOX:
        return image_box_overlap(gt["bbox"], dt["bbox"])
    bev = rotated_iou_2d(_camera_bev_boxes(gt), _camera_bev_boxes(dt))
    if metric == METRIC_BEV:
        return bev
    # 3D: bev intersection area x y-extent overlap / volume union
    n, m = bev.shape
    if n == 0 or m == 0:
        return bev
    g_loc, g_dim = gt["location"], gt["dimensions"]
    d_loc, d_dim = dt["location"], dt["dimensions"]
    # y is down; a box spans [y - h, y]
    g_top, g_bot = g_loc[:, 1] - g_dim[:, 0], g_loc[:, 1]
    d_top, d_bot = d_loc[:, 1] - d_dim[:, 0], d_loc[:, 1]
    h_overlap = np.clip(
        np.minimum(g_bot[:, None], d_bot[None, :]) -
        np.maximum(g_top[:, None], d_top[None, :]), 0, None)
    # recover bev intersection area from the IoU
    g_area = (g_dim[:, 1] * g_dim[:, 2])[:, None]
    d_area = (d_dim[:, 1] * d_dim[:, 2])[None, :]
    inter_bev = bev * (g_area + d_area) / (1.0 + bev)
    inter = inter_bev * h_overlap
    vol_g = (g_dim.prod(axis=1))[:, None]
    vol_d = (d_dim.prod(axis=1))[None, :]
    return (inter / np.maximum(vol_g + vol_d - inter, 1e-9)).astype(
        np.float32)


def clean_data(gt: dict, dt: dict, cls_name: str, difficulty: int):
    """Official filtering: per gt 0=valid 1=ignored -1=skip; same for dets."""
    ignored_gt, dc_bboxes = [], []
    neighbors = NEIGHBOR_CLASSES.get(cls_name, ())
    num_valid_gt = 0
    for i in range(len(gt["name"])):
        name = gt["name"][i]
        height = gt["bbox"][i, 3] - gt["bbox"][i, 1]
        if name == cls_name:
            valid_class = 1
        elif name in neighbors:
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt["occluded"][i] > MAX_OCCLUSION[difficulty]
                  or gt["truncated"][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (valid_class == 1 and ignore):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if name == "DontCare":
            dc_bboxes.append(gt["bbox"][i])

    ignored_dt = []
    for j in range(len(dt["name"])):
        if dt["name"][j] == cls_name:
            height = dt["bbox"][j, 3] - dt["bbox"][j, 1]
            ignored_dt.append(1 if height < MIN_HEIGHT[difficulty] else 0)
        else:
            ignored_dt.append(-1)
    return (np.array(ignored_gt, np.int32), np.array(ignored_dt, np.int32),
            np.array(dc_bboxes, np.float32).reshape(-1, 4), num_valid_gt)


def compute_statistics(overlaps, gt, dt, ignored_gt, ignored_dt, dc_bboxes,
                       metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """One image's (tp, fp, fn, aos-similarity, matched-det-scores) at a
    score threshold.

    Mirrors the published devkit logic: per valid gt choose, among
    unassigned compatible dets, the max-score det (threshold stage) or
    prefer valid over ignored dets by max overlap (fp stage). With
    compute_aos, accumulates Σ (1+cos(Δalpha))/2 over TPs (AOS numerator;
    devkit orientation similarity).
    """
    det_size = len(dt["name"])
    gt_size = len(gt["name"])
    dt_scores = dt["score"]
    assigned = np.zeros(det_size, bool)
    ignored_threshold = np.zeros(det_size, bool)
    if compute_fp:
        ignored_threshold = dt_scores < thresh
    tp = fp = fn = 0
    thresholds = []
    deltas = []

    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = -np.inf
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_dt[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[i, j]
            score = dt_scores[j]
            if not compute_fp:
                if overlap > min_overlap and score > valid_detection:
                    det_idx = j
                    valid_detection = score
            else:
                if (overlap > min_overlap and
                        (overlap > max_overlap or assigned_ignored_det) and
                        ignored_dt[j] == 0):
                    max_overlap = overlap
                    det_idx = j
                    valid_detection = 1
                    assigned_ignored_det = False
                elif (overlap > min_overlap and valid_detection == -np.inf
                      and ignored_dt[j] == 1):
                    det_idx = j
                    valid_detection = 1
                    assigned_ignored_det = True

        if valid_detection == -np.inf and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != -np.inf and (ignored_gt[i] == 1
                                             or ignored_dt[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != -np.inf:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                deltas.append(gt["alpha"][i] - dt["alpha"][det_idx])
            assigned[det_idx] = True

    if compute_fp:
        for j in range(det_size):
            if not (assigned[j] or ignored_dt[j] == -1 or ignored_dt[j] == 1
                    or ignored_threshold[j]):
                fp += 1
        # dets overlapping DontCare regions are not FPs (bbox metric)
        nstuff = 0
        if metric == METRIC_BBOX and len(dc_bboxes) > 0:
            overlaps_dt_dc = image_box_overlap(dt["bbox"], dc_bboxes,
                                               criterion=0)
            for j in range(det_size):
                if (assigned[j] or ignored_dt[j] != 0
                        or ignored_threshold[j]):
                    continue
                if overlaps_dt_dc[j].max(initial=0.0) > min_overlap:
                    nstuff += 1
                    assigned[j] = True
        fp -= nstuff
    similarity = -1.0
    if compute_fp and compute_aos:
        # devkit: FP slots contribute 0 similarity; -1 marks "no tp+fp"
        if tp > 0 or fp > 0:
            similarity = float(
                np.sum((1.0 + np.cos(np.array(deltas))) / 2.0))
    return tp, fp, fn, similarity, thresholds


def _sample_thresholds(scores: np.ndarray, num_gt: int) -> np.ndarray:
    """41 recall-spaced score thresholds (official get_thresholds)."""
    scores = np.sort(scores)[::-1]
    thresholds = []
    current_recall = 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1.0 / (N_SAMPLE_PTS - 1.0)
    return np.array(thresholds)


def eval_class(gt_annos: List[dict], dt_annos: List[dict], cls_name: str,
               difficulty: int, metric: int, min_overlap: float,
               compute_aos: bool = False):
    """-> (precision[N_SAMPLE_PTS], recall[N_SAMPLE_PTS], aos[N_SAMPLE_PTS]).

    aos is all-zero unless compute_aos (devkit: orientation similarity
    normalized by tp+fp, only meaningful for the bbox metric)."""
    assert len(gt_annos) == len(dt_annos)
    per_img = []
    total_valid_gt = 0
    all_thresholds = []
    for gt, dt in zip(gt_annos, dt_annos):
        ignored_gt, ignored_dt, dc, num_valid = clean_data(
            gt, dt, cls_name, difficulty)
        overlaps = _overlap_matrix(gt, dt, metric)
        per_img.append((overlaps, ignored_gt, ignored_dt, dc))
        total_valid_gt += num_valid
        _, _, _, _, th = compute_statistics(
            overlaps, gt, dt, ignored_gt, ignored_dt, dc, metric,
            min_overlap, compute_fp=False)
        all_thresholds.extend(th)

    precision = np.zeros(N_SAMPLE_PTS)
    recall = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS)
    if total_valid_gt == 0 or len(all_thresholds) == 0:
        return precision, recall, aos

    thresholds = _sample_thresholds(
        np.array(all_thresholds), total_valid_gt)
    pr = np.zeros((len(thresholds), 4))
    for (gt, dt), (overlaps, ignored_gt, ignored_dt, dc) in zip(
            zip(gt_annos, dt_annos), per_img):
        for t, thresh in enumerate(thresholds):
            tp, fp, fn, sim, _ = compute_statistics(
                overlaps, gt, dt, ignored_gt, ignored_dt, dc, metric,
                min_overlap, thresh=thresh, compute_fp=True,
                compute_aos=compute_aos)
            pr[t, 0] += tp
            pr[t, 1] += fp
            pr[t, 2] += fn
            if sim != -1:
                pr[t, 3] += sim

    for t in range(len(thresholds)):
        precision[t] = pr[t, 0] / max(pr[t, 0] + pr[t, 1], 1e-9)
        recall[t] = pr[t, 0] / max(pr[t, 0] + pr[t, 2], 1e-9)
        aos[t] = pr[t, 3] / max(pr[t, 0] + pr[t, 1], 1e-9)
    # right-max interpolation
    for t in range(len(thresholds)):
        precision[t] = precision[t:].max()
        recall[t] = recall[t:].max()
        aos[t] = aos[t:].max()
    return precision, recall, aos


def ap_r11(precision: np.ndarray) -> float:
    return float(precision[0::4].mean() * 100)


def ap_r40(precision: np.ndarray) -> float:
    return float(precision[1:].mean() * 100)


def kitti_eval(gt_annos: List[dict], dt_annos: List[dict],
               classes: Sequence[str],
               metrics: Sequence[int] = (METRIC_BBOX, METRIC_BEV, METRIC_3D),
               overlaps: Dict[str, Sequence[float]] = None,
               compute_aos: bool = False) -> dict:
    """-> {cls: {metric_name: {"easy"/"moderate"/"hard": (AP11, AP40)}}}.

    With compute_aos, adds an "aos" metric group (orientation similarity
    over the bbox matching; reference kitti_metric.py:303)."""
    overlaps = overlaps or DEFAULT_OVERLAPS
    metric_names = {METRIC_BBOX: "bbox", METRIC_BEV: "bev", METRIC_3D: "3d"}
    diff_names = ["easy", "moderate", "hard"]
    results = {}
    for cls_name in classes:
        results[cls_name] = {}
        for metric in metrics:
            mname = metric_names[metric]
            results[cls_name][mname] = {}
            want_aos = compute_aos and metric == METRIC_BBOX
            if want_aos:
                results[cls_name]["aos"] = {}
            min_overlap = overlaps[cls_name][metric]
            for d, dname in enumerate(diff_names):
                prec, _, aos = eval_class(gt_annos, dt_annos, cls_name, d,
                                          metric, min_overlap,
                                          compute_aos=want_aos)
                results[cls_name][mname][dname] = (ap_r11(prec),
                                                   ap_r40(prec))
                if want_aos:
                    results[cls_name]["aos"][dname] = (ap_r11(aos),
                                                       ap_r40(aos))
    return results

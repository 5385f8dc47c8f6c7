"""SemanticKITTI segmentation dataset and mIoU metric, a copy of
paddle3d_tpu/datasets/semantic_kitti/semantic_kitti.py (LEARNING_MAP,
CONTENT, the remap LUT, SemanticKITTIDataset, SemanticKittiMetric).

Layout: {root}/sequences/{seq}/velodyne/*.bin and labels/*.label (uint32:
the low 16 bits are the semantic label). Labels are remapped through the
standard learning map to the 20-class space (0 = ignore).
"""
import os
from typing import Dict, List

import numpy as np

from ...apis import manager
from ...sample import Sample
from ...transforms.base import Compose
from ..base import BaseDataset, MetricABC

__all__ = ["SemanticKITTIDataset", "SemanticKittiMetric", "LEARNING_MAP",
           "CONTENT"]

TRAIN_SEQUENCES = ["00", "01", "02", "03", "04", "05", "06", "07", "09",
                   "10"]
VAL_SEQUENCES = ["08"]

# raw label -> train id (0 unlabeled/ignore), standard semantic-kitti map
LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}


def _build_lut():
    lut = np.zeros(max(LEARNING_MAP) + 1, np.int32)
    for k, v in LEARNING_MAP.items():
        lut[k] = v
    return lut


# published per-raw-label point-count ratios over the train split (the
# semantic-kitti-api config's `content` table); used for inverse-frequency
# loss weighting (SSGLossComputation)
CONTENT = {
    0: 0.018889854628292943, 1: 0.0002937197336781505,
    10: 0.040818519255974316, 11: 0.00016609538710764618,
    13: 2.7879693665067774e-05, 15: 0.00039838616015114444,
    16: 0.0, 18: 0.0020633612104619787, 20: 0.0016218197275284021,
    30: 0.00017698551338515307, 31: 1.1065903904919655e-08,
    32: 5.532951952459828e-09, 40: 0.1987493871255525,
    44: 0.014717169549888214, 48: 0.14392298360372,
    49: 0.0039048553037472045, 50: 0.1326861944777486,
    51: 0.0723592229456223, 52: 0.002395131480328884,
    60: 4.7084144280367186e-05, 70: 0.26681502148037506,
    71: 0.006035012012626033, 72: 0.07814222006271769,
    80: 0.002855498193863172, 81: 0.0006155958086189918,
    99: 0.009923127583046915, 252: 0.001789309418528068,
    253: 0.00012709999297008662, 254: 0.00016059776092534436,
    255: 3.745553104802113e-05, 256: 0.0, 257: 0.00011351574470342043,
    258: 0.00010157861367183268, 259: 4.3840131989471124e-05,
}


@manager.DATASETS.add_component
class SemanticKITTIDataset(BaseDataset):
    NUM_CLASSES = 20

    @staticmethod
    def build_remap_lut():
        """raw-label -> train-id lookup table (array indexed by raw id)."""
        return _build_lut()

    def __init__(self, dataset_root: str, mode: str = "train",
                 transforms=None, sequences: List[str] = None):
        self.dataset_root = dataset_root
        self.mode = mode
        if isinstance(transforms, list):
            transforms = Compose(transforms)
        self.transforms = transforms
        seqs = sequences or (TRAIN_SEQUENCES if mode == "train" else
                             VAL_SEQUENCES)
        self.files = []
        for seq in seqs:
            vdir = os.path.join(dataset_root, "sequences", seq, "velodyne")
            if not os.path.isdir(vdir):
                continue
            for f in sorted(os.listdir(vdir)):
                if f.endswith(".bin"):
                    self.files.append((seq, f[:-4]))
        self._lut = _build_lut()

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int) -> Sample:
        seq, frame = self.files[index]
        base = os.path.join(self.dataset_root, "sequences", seq)
        sample = Sample(
            path=os.path.join(base, "velodyne", frame + ".bin"),
            modality="lidar")
        sample.meta.id = "{}_{}".format(seq, frame)
        label_path = os.path.join(base, "labels", frame + ".label")
        if os.path.exists(label_path):
            raw = np.fromfile(label_path, np.uint32) & 0xFFFF
            raw = np.clip(raw, 0, len(self._lut) - 1)
            sample.labels = self._lut[raw]
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample

    def collate_fn(self, samples: List[Sample]):
        batch = {
            "data": np.stack([np.asarray(s.data, np.float32)
                              for s in samples]),
            "proj_mask": np.stack([s.proj_mask for s in samples]),
        }
        if getattr(samples[0], "proj_labels", None) is not None:
            batch["proj_labels"] = np.stack(
                [s.proj_labels for s in samples])
        metas = [{"path": s.path, "id": s.meta.get("id"),
                  "proj_x": s.proj_x, "proj_y": s.proj_y,
                  "point_labels": getattr(s, "labels", None)}
                 for s in samples]
        return batch, metas

    @property
    def metric(self) -> "SemanticKittiMetric":
        return SemanticKittiMetric(self.NUM_CLASSES)


class SemanticKittiMetric(MetricABC):
    """Range-view and point mIoU (predictions unprojected via proj_x/y)."""

    def __init__(self, num_classes: int, ignore: int = 0):
        self.num_classes = num_classes
        self.ignore = ignore
        self.conf = np.zeros((num_classes, num_classes), np.int64)

    def update(self, predictions: List[Sample], ground_truths=None):
        for pred in predictions:
            meta = pred.meta
            gt = meta.get("point_labels")
            if gt is None:
                continue
            px, py = meta.get("proj_x"), meta.get("proj_y")
            point_pred = np.asarray(pred.labels)[py, px]
            keep = gt != self.ignore
            np.add.at(self.conf, (gt[keep], point_pred[keep]), 1)

    def compute(self, verbose: bool = False) -> Dict[str, float]:
        tp = np.diag(self.conf).astype(np.float64)
        fp = self.conf.sum(0) - tp
        fn = self.conf.sum(1) - tp
        iou = tp / (tp + fp + fn + 1e-15)
        # official protocol: mean over ALL include (non-ignore) classes,
        # absent classes contributing 0 (reference:
        # thirdparty/semantic_kitti_api/auxiliary/np_ioueval.py:56 getIoU)
        include = np.arange(self.num_classes) != self.ignore
        miou = float(iou[include].mean())
        acc = float(tp.sum() / max(self.conf.sum(), 1))
        return {"mIoU": miou, "acc": acc}

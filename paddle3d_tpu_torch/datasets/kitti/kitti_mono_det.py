"""KITTI monocular dataset, a copy of
paddle3d_tpu/datasets/kitti/kitti_mono_det.py (reference:
paddle3d/datasets/kitti/kitti_mono_det.py:26).

Samples carry the image (decoded by utils/png.py, byte for byte Pillow's
`convert("RGB")`) plus CAMERA-frame 3D boxes (x, y_bottom, z, h, w, l, ry),
the native frame for mono heads, the 2-D boxes, labels and difficulties.
`ds[i]` is `ds.get(i)`: its random transforms (Gt2SmokeTarget's flip) draw
from `transforms.sample_rng(0, 0, i)`; the DataLoader hands each sample the
generator of its seed, epoch and index.
"""
import numpy as np

from ...apis import manager
from ...sample import Sample
from ...transforms.base import sample_rng
from ...utils.png import read_png
from .kitti_det import KittiDetDataset
from .kitti_metric import KittiMetric

__all__ = ["KittiMonoDataset"]


@manager.DATASETS.add_component
class KittiMonoDataset(KittiDetDataset):
    max_gt_boxes = 50

    def __getitem__(self, index: int) -> Sample:
        return self.get(index)

    def get(self, index: int, rng: np.random.RandomState = None) -> Sample:
        idx = self.ids[index]
        sample = Sample(path=self.image_path(idx), modality="image")
        sample.meta.id = idx
        sample.rng = sample_rng(0, 0, index) if rng is None else rng
        calib = self.load_calib(idx)
        sample.calibs = calib.as_matrices()
        sample.meta.camera_intrinsic = calib.P2[:3, :3]

        sample.data = read_png(self.image_path(idx))
        sample.meta.image_shape = sample.data.shape[:2]

        if not self.is_test_mode:
            anno = self.load_anno(idx)
            keep = np.isin(anno["name"], self.class_names)
            loc = anno["location"][keep]
            dim = anno["dimensions"][keep]  # (h, w, l)
            ry = anno["rotation_y"][keep]
            sample.bboxes_3d = np.concatenate(
                [loc, dim, ry[:, None]], axis=1).astype(np.float32)
            sample.bboxes_2d = anno["bbox"][keep]
            sample.labels = np.array(
                [self.class_names.index(n) for n in anno["name"][keep]],
                np.int32)
            sample.difficulties = anno["difficulty"][keep]

        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample

    def collate_fn(self, samples):
        batch = {
            "data": np.stack([np.asarray(s.data, np.float32)
                              for s in samples]),
        }
        if getattr(samples[0], "target", None) is not None:
            tkeys = samples[0].target.keys()
            batch["target"] = {
                k: np.stack([s.target[k] for s in samples]) for k in tkeys
            }
        metas = [{"path": s.path, "id": s.meta.get("id")} for s in samples]
        return batch, metas

    @property
    def metric(self) -> KittiMetric:
        gts = [self.load_anno(i) for i in self.ids]
        calibs = [self.load_calib(i) for i in self.ids]
        return KittiMetric(
            groundtruths=gts, classmap=dict(enumerate(self.class_names)),
            calibs=calibs, ids=self.ids, metrics=("bbox", "bev", "3d"),
            compute_aos=True)

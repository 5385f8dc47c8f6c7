"""nuScenes point-cloud detection datasets, a copy of
paddle3d_tpu/datasets/nuscenes/nuscenes_det.py (reference:
paddle3d/datasets/nuscenes/nuscenes_det.py and
nuscenes_pointcloud_det.py:33 — the same table schema, with no
nuscenes-devkit / pyquaternion dependency).

Reads the official v1.0 relational tables ({root}/{version}/*.json),
resolves poses, hands LoadPointCloud the LIDAR_TOP sweep chain
(`sweep.meta.ref_from_curr`, `time_lag`), and emits lidar-frame Samples
with bottom-z boxes and velocities. As KittiPCDataset, `ds[i]` is
`ds.get(i)`: its random transforms draw from `transforms.sample_rng(0, 0,
i)`, and the DataLoader hands each sample the generator of its seed, epoch
and index.
"""
import json
import os
from typing import Dict, List

import numpy as np

from ...apis import manager
from ...geometries import BBoxes3D, CoordMode
from ...sample import Sample
from ...transforms.base import sample_rng
from ...utils.transform3d import (invert_transform, make_transform,
                                  quat_inverse, quat_multiply, quat_yaw)
from ..base import BaseDataset
from .nuscenes_metric import NuScenesMetric

__all__ = ["NuscenesDetDataset", "NuscenesPCDataset"]

# official detection-class mapping (devkit detection config)
CLASS_MAP = {
    "vehicle.car": "car",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
}

DETECTION_CLASSES = [
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone"
]

MINI_TRAIN = ["scene-0061", "scene-0553", "scene-0655", "scene-0757",
              "scene-0796", "scene-1077", "scene-1094", "scene-1100"]
MINI_VAL = ["scene-0103", "scene-0916"]

DEFAULT_ATTRIBUTES = {
    "car": "vehicle.parked", "truck": "vehicle.parked",
    "bus": "vehicle.stopped", "trailer": "vehicle.parked",
    "construction_vehicle": "vehicle.parked",
    "motorcycle": "cycle.without_rider", "bicycle": "cycle.without_rider",
    "pedestrian": "pedestrian.standing", "barrier": "", "traffic_cone": "",
}


class NuscenesDetDataset(BaseDataset):
    def __init__(self,
                 dataset_root: str,
                 version: str = "v1.0-mini",
                 mode: str = "train",
                 class_names: List[str] = None,
                 transforms=None,
                 max_sweeps: int = 10):
        self.dataset_root = dataset_root
        self.version = version
        self.mode = mode
        self.class_names = class_names or DETECTION_CLASSES
        self.max_sweeps = max_sweeps
        if isinstance(transforms, list):
            from ...transforms import Compose
            transforms = Compose(transforms)
        self.transforms = transforms

        self._load_tables()
        self._build_index()

    # --------------------------------------------------------------- tables
    def _table(self, name: str) -> List[dict]:
        path = os.path.join(self.dataset_root, self.version,
                            "{}.json".format(name))
        with open(path) as f:
            return json.load(f)

    def _load_tables(self):
        self.scene = {s["token"]: s for s in self._table("scene")}
        self.sample = {s["token"]: s for s in self._table("sample")}
        self.sample_data = {s["token"]: s for s in self._table("sample_data")}
        self.ego_pose = {s["token"]: s for s in self._table("ego_pose")}
        self.calibrated_sensor = {
            s["token"]: s for s in self._table("calibrated_sensor")
        }
        self.sensor = {s["token"]: s for s in self._table("sensor")}
        self.category = {s["token"]: s for s in self._table("category")}
        self.attribute = {s["token"]: s for s in self._table("attribute")}
        self.instance = {s["token"]: s for s in self._table("instance")}
        anns = self._table("sample_annotation")
        self.sample_annotation = {s["token"]: s for s in anns}
        self._anns_by_sample: Dict[str, List[dict]] = {}
        for a in anns:
            self._anns_by_sample.setdefault(a["sample_token"], []).append(a)

    def _split_scenes(self) -> List[str]:
        split_file = os.path.join(self.dataset_root, "splits",
                                  "{}.txt".format(self.mode))
        if os.path.exists(split_file):
            with open(split_file) as f:
                names = {l.strip() for l in f if l.strip()}
        elif self.version == "v1.0-mini":
            names = set(MINI_TRAIN if self.mode == "train" else MINI_VAL)
        else:
            names = {s["name"] for s in self.scene.values()}
        return [t for t, s in self.scene.items() if s["name"] in names]

    def _build_index(self):
        scene_tokens = set(self._split_scenes())
        self.sample_tokens = []
        for scene_token in scene_tokens:
            tok = self.scene[scene_token]["first_sample_token"]
            while tok:
                self.sample_tokens.append(tok)
                tok = self.sample[tok]["next"]

    def __len__(self):
        return len(self.sample_tokens)

    def frame_labels(self, index: int):
        """Annotation-only class ids (for class-balanced resampling, the
        JAX package's CBGS wrapper, not ported)."""
        _, labels, *_ = self.annotations(self.sample_tokens[index])
        return labels

    # ----------------------------------------------------------------- poses
    def _sd_transforms(self, sd: dict):
        cs = self.calibrated_sensor[sd["calibrated_sensor_token"]]
        ep = self.ego_pose[sd["ego_pose_token"]]
        car_from_sensor = make_transform(cs["translation"], cs["rotation"])
        global_from_car = make_transform(ep["translation"], ep["rotation"])
        return global_from_car @ car_from_sensor  # global <- sensor

    def lidar_sd(self, sample_token: str) -> dict:
        return self.sample_data[self.sample[sample_token]["data"]["LIDAR_TOP"]]

    def annotations(self, sample_token: str):
        """GT boxes in the LIDAR_TOP frame: [N, 9]
        (x, y, z_bottom, w, l, h, yaw, vx, vy) + labels + names + counts."""
        sd = self.lidar_sd(sample_token)
        lidar_from_global = invert_transform(self._sd_transforms(sd))
        cs = self.calibrated_sensor[sd["calibrated_sensor_token"]]
        ep = self.ego_pose[sd["ego_pose_token"]]

        boxes, labels, names, num_pts, attrs = [], [], [], [], []
        for ann in self._anns_by_sample.get(sample_token, []):
            cat = self.instance[ann["instance_token"]]["category_token"] \
                if "category_token" not in ann else ann["category_token"]
            cat_name = self.category[cat]["name"]
            det_name = CLASS_MAP.get(cat_name)
            if det_name is None or det_name not in self.class_names:
                continue
            center_g = np.asarray(ann["translation"], np.float64)
            q_g = np.asarray(ann["rotation"], np.float64)
            w, l, h = ann["size"]  # nuScenes size = (w, l, h)
            # global -> lidar
            center_l = (lidar_from_global[:3, :3] @ center_g +
                        lidar_from_global[:3, 3])
            q_l = quat_multiply(
                quat_multiply(quat_inverse(cs["rotation"]),
                              quat_inverse(ep["rotation"])), q_g)
            yaw = quat_yaw(q_l)
            vel = self._box_velocity(ann)
            vel_l = lidar_from_global[:3, :3] @ np.array(
                [vel[0], vel[1], 0.0])
            boxes.append([
                center_l[0], center_l[1], center_l[2] - h / 2, w, l, h, yaw,
                vel_l[0], vel_l[1]
            ])
            labels.append(self.class_names.index(det_name))
            names.append(det_name)
            num_pts.append(ann.get("num_lidar_pts", 1))
            if ann.get("attribute_tokens"):
                attrs.append(
                    self.attribute[ann["attribute_tokens"][0]]["name"])
            else:
                attrs.append("")
        return (np.asarray(boxes, np.float32).reshape(-1, 9),
                np.asarray(labels, np.int32), names,
                np.asarray(num_pts, np.int64), attrs)

    def _box_velocity(self, ann: dict, dt_max: float = 1.5):
        """Finite-difference velocity from neighbouring annotations."""
        cur = ann
        prev = self.sample_annotation.get(ann["prev"]) if ann["prev"] else None
        nxt = self.sample_annotation.get(ann["next"]) if ann["next"] else None
        first = prev or cur
        last = nxt or cur
        if first is last:
            return np.zeros(2)
        p0 = np.asarray(first["translation"][:2])
        p1 = np.asarray(last["translation"][:2])
        t0 = self.sample[first["sample_token"]]["timestamp"] / 1e6
        t1 = self.sample[last["sample_token"]]["timestamp"] / 1e6
        if t1 - t0 > dt_max * 2 or t1 - t0 <= 0:
            return np.zeros(2)
        return (p1 - p0) / (t1 - t0)


@manager.DATASETS.add_component
class NuscenesPCDataset(NuscenesDetDataset):
    max_points = 300000
    max_gt_boxes = 128
    point_dim = 5  # x, y, z, intensity, time_lag

    def __getitem__(self, index: int) -> Sample:
        return self.get(index)

    def get(self, index: int, rng: np.random.RandomState = None) -> Sample:
        token = self.sample_tokens[index]
        sd = self.lidar_sd(token)
        sample = Sample(
            path=os.path.join(self.dataset_root, sd["filename"]),
            modality="lidar")
        sample.meta.id = token
        sample.rng = sample_rng(0, 0, index) if rng is None else rng

        if not self.is_test_mode:
            boxes, labels, names, num_pts, attrs = self.annotations(token)
            sample.bboxes_3d = BBoxes3D(
                boxes[:, :7], coordmode=CoordMode.NuScenesLidar,
                origin=[.5, .5, 0.], rot_axis=2,
                velocities=boxes[:, 7:9])
            sample.labels = labels
            sample.attrs = attrs

        # sweep references for LoadPointCloud
        ref_from_global = invert_transform(self._sd_transforms(sd))
        t_ref = sd["timestamp"] / 1e6
        sweeps = []
        prev = sd["prev"]
        while prev and len(sweeps) < self.max_sweeps:
            swd = self.sample_data[prev]
            sweep = Sample(
                path=os.path.join(self.dataset_root, swd["filename"]),
                modality="lidar")
            sweep.meta.ref_from_curr = (
                ref_from_global @ self._sd_transforms(swd))[:3, :]
            sweep.meta.time_lag = t_ref - swd["timestamp"] / 1e6
            sweeps.append(sweep)
            prev = swd["prev"]
        sample.sweeps = sweeps

        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample

    def collate_fn(self, samples: List[Sample]):
        from ..base import collate_lidar
        batch, metas = collate_lidar(samples, self.max_points,
                                     self.max_gt_boxes, self.point_dim)
        # velocities ride along as extra gt columns
        b = len(samples)
        vel = np.zeros((b, self.max_gt_boxes, 2), np.float32)
        for i, s in enumerate(samples):
            if s.bboxes_3d is not None and \
                    getattr(s.bboxes_3d, "velocities", None) is not None:
                g = min(len(s.bboxes_3d), self.max_gt_boxes)
                vel[i, :g] = np.asarray(s.bboxes_3d.velocities)[:g]
        batch["gt_boxes"] = np.concatenate([batch["gt_boxes"], vel], axis=-1)
        return batch, metas

    @property
    def metric(self) -> NuScenesMetric:
        return NuScenesMetric(self)

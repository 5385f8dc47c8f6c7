"""Build the GT-paste database that SamplingDatabase reads, the port of
tools/create_det_gt_database.py (reference: paddle3d/datasets/
generate_gt_database.py:204):

    python -m paddle3d_tpu_torch.tools.create_det_gt_database \
        --config configs/pv_rcnn/pv_rcnn_005voxel_kitti.yml

It crops each ground-truth object's points from the config's train
dataset (geometries.points_in_rbbox_bev, each box tested on the points
within reach of its BEV footprint: `crop_mask`), stores them relative to
the box centre as float32 .bin files, and pickles {class name: [entries]}.
An entry holds what the JAX tool writes (lidar_file, lidar_dim, box3d: the
box's first 7 columns, num_points_in_box, difficulty, points_relative)
and, where the sample's boxes carry velocities, `velocity` [vx, vy], a key
the JAX transform ignores.

Two differences from the JAX tool, whose database no config of the repo
can read as written:

  * the dataset is built with its loading transforms only: those before
    the SamplingDatabase entry of the train pipeline (the whole pipeline
    where there is none). The JAX tool builds the whole pipeline, whose
    SamplingDatabase opens the pickle the tool is to write, and would crop
    flipped, rotated, scaled and filtered scenes;
  * by default the pickle goes to the config's own `database_anno_path`,
    the bins to a `bins/` beside it, and each `lidar_file` is written
    relative to the config's `database_root`, so that the config resolves
    the database as written. `--save_dir` keeps the JAX layout:
    {save_dir}/bins/*.bin, {save_dir}/anno_info_{mode}.pkl, lidar_file
    relative to save_dir.
"""
import argparse
import os
import pickle

import numpy as np

__all__ = ["main", "parse_args", "loading_config", "crop_mask"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="GT-paste database")
    parser.add_argument("--config", dest="cfg", required=True)
    parser.add_argument("--save_dir", default=None,
                        help="the JAX tool's layout under this directory "
                             "(default: the config's SamplingDatabase "
                             "paths)")
    parser.add_argument("--mode", default="train",
                        help="names the pickle under --save_dir")
    return parser.parse_args(argv)


def loading_config(dic: dict):
    """-> (the train dataset's config with the transforms before its
    SamplingDatabase entry, that entry or None)."""
    ds = dict(dic["train_dataset"])
    transforms = list(ds.get("transforms") or [])
    types = [t.get("type") for t in transforms]
    entry = None
    if "SamplingDatabase" in types:
        at = types.index("SamplingDatabase")
        entry, transforms = transforms[at], transforms[:at]
    ds["transforms"] = transforms
    return ds, entry


def crop_mask(points: np.ndarray, boxes: np.ndarray, origin) -> np.ndarray:
    """points_in_rbbox_bev(points, boxes, origin) [N, M], each box tested
    only on the points within 1 cm of the circle around its BEV corners:
    the same answers (a point of the box lies in that circle), without the
    [N, M, 6, 3] temporaries of a full test (5 s a 10-sweep nuScenes
    sample on one CPU core)."""
    from paddle3d_tpu_torch.geometries import BBoxes3D, points_in_rbbox_bev
    corners = BBoxes3D(boxes, origin=list(origin)).corners_2d
    centre = corners.mean(axis=1)
    reach = np.linalg.norm(corners - centre[:, None], axis=-1).max(1) + 0.01
    mask = np.zeros((len(points), len(boxes)), bool)
    for j in range(len(boxes)):
        near = np.nonzero(np.hypot(points[:, 0] - centre[j, 0],
                                   points[:, 1] - centre[j, 1]) <= reach[j])[0]
        mask[near, j] = points_in_rbbox_bev(points[near], boxes[j:j + 1],
                                            origin=origin)[:, 0]
    return mask


def main(args):
    from paddle3d_tpu_torch.apis import Config
    from paddle3d_tpu_torch.utils.logger import logger

    dic = Config(path=args.cfg, device="cpu").dic
    ds_cfg, entry = loading_config(dic)
    if args.save_dir is not None:
        root = args.save_dir
        bin_dir = os.path.join(args.save_dir, "bins")
        anno_path = os.path.join(args.save_dir,
                                 "anno_info_{}.pkl".format(args.mode))
    elif entry is not None:
        root = entry["database_root"]
        anno_path = entry["database_anno_path"]
        bin_dir = os.path.join(os.path.dirname(anno_path), "bins")
    else:
        raise ValueError("{} has no SamplingDatabase in its train pipeline: "
                         "give --save_dir".format(args.cfg))
    dataset = Config(dic={"train_dataset": ds_cfg},
                     device="cpu").train_dataset
    os.makedirs(bin_dir, exist_ok=True)

    database = {}
    for i in range(len(dataset)):
        sample = dataset[i]
        if sample.bboxes_3d is None or len(sample.bboxes_3d) == 0:
            continue
        points = np.asarray(sample.data)
        boxes = np.asarray(sample.bboxes_3d)
        vel = sample.bboxes_3d.velocities
        labels = np.asarray(sample.labels)
        diffs = getattr(sample, "difficulties", None)
        in_box = crop_mask(points, boxes, sample.bboxes_3d.origin)
        for j, (box, label) in enumerate(zip(boxes, labels)):
            obj_pts = points[in_box[:, j]]
            if len(obj_pts) == 0:
                continue
            rel = obj_pts.copy()
            rel[:, :3] -= box[:3]
            cls_name = dataset.class_names[int(label)]
            path = os.path.join(bin_dir, "{}_{}_{}.bin".format(
                str(sample.meta.get("id")).replace("/", "_"), j, cls_name))
            rel.astype(np.float32).tofile(path)
            anno = {
                "lidar_file": os.path.relpath(path, root),
                "lidar_dim": rel.shape[1],
                "box3d": box[:7].tolist(),
                "num_points_in_box": int(len(obj_pts)),
                "difficulty": int(diffs[j]) if diffs is not None else 0,
                "points_relative": True,
            }
            if vel is not None:
                anno["velocity"] = np.asarray(vel, np.float32)[j].tolist()
            database.setdefault(cls_name, []).append(anno)
        if (i + 1) % 100 == 0:
            logger.info("processed {}/{}".format(i + 1, len(dataset)))

    os.makedirs(os.path.dirname(anno_path) or ".", exist_ok=True)
    with open(anno_path, "wb") as f:
        pickle.dump(database, f)
    logger.info("Wrote {} classes, {} objects -> {}".format(
        len(database), sum(len(v) for v in database.values()), anno_path))
    return anno_path


if __name__ == "__main__":
    main(parse_args())

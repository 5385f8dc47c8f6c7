#!/usr/bin/env python3
"""Smoke run of the PyTorch port (paddle3d_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

drives the port's main path, PointPillars-KITTI inference
(configs/pointpillars/pointpillars_xyres16_kitti_car.yml, full width, seeded
random weights, eval BatchNorm) on 8 scans of 20,000 clustered points, in
phases; any failing phase exits non-zero and prints no result:

  1. the card's name and power limit; build the CUDA kernels from
     paddle3d_tpu_torch/csrc/ with nvcc (first use builds them);
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, with the stated tolerance; kernel and plain times;
  3. the model's test_forward through the kernels (launch counters must
     move), then again with the plain versions swapped in: the outputs must
     agree; the tiny config's canvas on the card against the CPU path;
  4. 20 timed iterations of each path (scans/s) and a profile of the
     kernel path, with cuDNN autotuning on as a server would run.

The last two lines are the kernels' JSON record and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
f32 throughout, with TF32 off for convolutions and matmuls; deterministic
cuDNN for the comparisons.
"""
import json
import os
import subprocess
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
KITTI = os.path.join(REPO, "configs", "pointpillars",
                     "pointpillars_xyres16_kitti_car.yml")
TINY = os.path.join(REPO, "configs", "pointpillars",
                    "pointpillars_synthetic_tiny.yml")
BATCH, POINTS, SEED, ITERS = 8, 20000, 0, 20

# kernel -> (source, replaced TPU kernel, tolerance against the plain
# version). Both are the plain versions' arithmetic: K1 in the same order
# (bit-equal by design), K2 sums one non-zero row per canvas cell.
KERNELS = {
    "fused_pfn_rows": ("paddle3d_tpu_torch/csrc/fused_pfn.cu",
                       "paddle3d_tpu/ops/pallas/fused_pfn.py:133", 1e-5),
    "sorted_segment_sum": ("paddle3d_tpu_torch/csrc/sorted_scatter.cu",
                           "paddle3d_tpu/ops/pallas/sorted_scatter.py:54",
                           1e-5),
}


class PhaseError(RuntimeError):
    pass


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def cuda_ms(fn, iters):
    """Mean device time of fn() over iters launches (CUDA events, after a
    warm-up launch)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plain_split(keys, rows, num_cells):
    from paddle3d_tpu_torch.ops.sorted_scatter import sorted_segment_sum_plain
    out = sorted_segment_sum_plain(keys, rows, num_cells)
    return out[..., :-1], out[..., -1:]


def plain_path():
    """The model with both kernels swapped for their plain versions."""
    from paddle3d_tpu_torch.ops import fused_pfn, pillar_ops
    return mock.patch.multiple(
        pillar_ops, fused_pfn_rows=fused_pfn.fused_pfn_rows_plain,
        sorted_segment_sum_split=plain_split)


def make_points(device):
    import numpy as np
    import torch

    import bench
    _, n, (lo, hi), _ = bench.MODELS["pointpillars"]
    pts = bench.make_scans(np.random.default_rng(SEED), BATCH, n, lo, hi,
                           "clustered")
    check(pts.shape == (BATCH, POINTS, 4), "unexpected scan shape")
    return torch.from_numpy(pts).to(device)


def phase_build():
    from paddle3d_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    log("phase 1: kernels built in {:.1f} s into {}".format(
        time.perf_counter() - t0, os.path.relpath(_build.BUILD_DIR, REPO)))
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())


def phase_kernels(model, points):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from paddle3d_tpu_torch.ops import fused_pfn, pillar_ops, sorted_scatter
    vox, pfn, mid = model.voxelizer, model.pillar_encoder, \
        model.middle_encoder
    keys, pts_t = pillar_ops.sort_points_by_cell(points, vox.voxel_size,
                                                 vox.point_cloud_range)
    w1t, b1, _, _ = pillar_ops.pfn_folded_weights(pfn)
    kw = dict(n_layers=1, P=pfn.max_num_points_in_voxel,
              maxV=vox.max_num_voxels_for(False), nx=mid.nx, vx=pfn.vx,
              vy=pfn.vy, x_off=pfn.x_offset, y_off=pfn.y_offset,
              with_distance=pfn.with_distance, occupancy=True)
    check(tuple(w1t.shape) == (64, 9) and kw["P"] == 32 and
          kw["maxV"] == 40000, "not the KITTI PFN shapes")
    cells = mid.ny * mid.nx
    check(cells == 214272, "not the KITTI grid")

    rows_t = fused_pfn.fused_pfn_rows(keys, pts_t, w1t, b1, **kw)
    ref_t = fused_pfn.fused_pfn_rows_plain(keys, pts_t, w1t, b1, **kw)
    rows = rows_t.transpose(1, 2).contiguous()
    table, occ = sorted_scatter.sorted_segment_sum_split(keys, rows, cells)
    ref_table, ref_occ = plain_split(keys, rows, cells)
    torch.cuda.synchronize()
    check(tuple(rows.shape) == (BATCH, POINTS, 65), "K1 output shape")
    errs = {
        "fused_pfn_rows": (rows_t - ref_t).abs().max().item(),
        "sorted_segment_sum": max((table - ref_table).abs().max().item(),
                                  (occ - ref_occ).abs().max().item()),
    }
    times = {
        "fused_pfn_rows": (
            cuda_ms(lambda: fused_pfn.fused_pfn_rows(keys, pts_t, w1t, b1,
                                                     **kw), 50),
            cuda_ms(lambda: fused_pfn.fused_pfn_rows_plain(keys, pts_t, w1t,
                                                           b1, **kw), 10)),
        "sorted_segment_sum": (
            cuda_ms(lambda: sorted_scatter.sorted_segment_sum_split(
                keys, rows, cells), 50),
            cuda_ms(lambda: plain_split(keys, rows, cells), 10)),
    }
    log("phase 2: kernels vs plain at B={} N={} C_in=4 C_dec=9 u1=64 P=32 "
        "maxV=40000 cells={} C=65 (split), pillars emitted per scan {}"
        .format(BATCH, POINTS, cells,
                rows_t[:, -1].sum(dim=1).int().tolist()))
    for name, (_, _, tol) in KERNELS.items():
        ms, plain_ms = times[name]
        log("  {}: max_abs_err {:.3e} (tolerance {:.0e}), {:.4f} ms vs "
            "plain {:.4f} ms".format(name, errs[name], tol, ms, plain_ms))
        check(errs[name] <= tol, "{} disagrees with its plain version"
              .format(name))
    return errs, times


def check_outputs(out):
    import torch
    boxes, scores, labels = (out["box3d_lidar"], out["scores"],
                             out["label_preds"])
    check(tuple(boxes.shape) == (BATCH, 300, 7), "box3d_lidar shape")
    check(tuple(scores.shape) == (BATCH, 300) and
          tuple(labels.shape) == (BATCH, 300), "scores/labels shape")
    check(bool(torch.isfinite(boxes).all() & torch.isfinite(scores).all()),
          "non-finite outputs")
    kept = scores >= 0
    check(bool((scores[kept] >= 0.05).all() & (scores[~kept] == -1).all()),
          "scores outside the threshold / padding convention")
    check(bool((labels[kept] == 0).all() & (labels[~kept] == -1).all()),
          "labels outside the one-class / padding convention")
    check(bool(kept.any(dim=1).all()), "a scan kept no box")
    return kept.sum(dim=1).tolist()


def phase_model(model, points):
    import torch

    from paddle3d_tpu_torch.ops import _build
    _build.reset_launches()
    out = model.test_forward({"data": points})
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    kept = check_outputs(out)
    log("phase 3: test_forward through the kernels: launches {}, kept "
        "boxes per scan {}".format(launches, kept))
    check(all(launches[name] > 0 for name in KERNELS),
          "the main path missed a kernel: {}".format(launches))
    with plain_path():
        ref = model.test_forward({"data": points})
    torch.cuda.synchronize()
    check(torch.equal(out["label_preds"], ref["label_preds"]),
          "labels differ from the plain path")
    s_err = (out["scores"] - ref["scores"]).abs().max().item()
    b_err = (out["box3d_lidar"] - ref["box3d_lidar"]).abs().max().item()
    log("  vs the plain path on the card: labels equal, scores max_abs_err "
        "{:.3e} (tolerance 1e-5), boxes {:.3e} (tolerance 1e-4)".format(
            s_err, b_err))
    check(s_err <= 1e-5 and b_err <= 1e-4, "outputs differ from plain path")
    return launches


def phase_tiny_canvas():
    """A small input against the CPU path: the tiny config's canvas and
    occupancy, kernels on the card vs plain versions on the CPU."""
    import numpy as np
    import torch

    from paddle3d_tpu_torch.apis import Config
    from paddle3d_tpu_torch.ops.pillar_ops import fused_pillar_canvas
    model = Config(path=TINY).model.eval()
    rng = np.random.default_rng(SEED)
    pts = torch.from_numpy(rng.uniform([0, -16, -2, 0], [32, 16, 2, 1],
                                       (2, 1024, 4)).astype(np.float32))
    mods = (model.voxelizer, model.pillar_encoder, model.middle_encoder)
    ref_canvas, ref_occ = fused_pillar_canvas(*mods, pts, with_occupancy=True)
    model.cuda()
    canvas, occ = fused_pillar_canvas(*mods, pts.cuda(), with_occupancy=True)
    err = (canvas.cpu() - ref_canvas).abs().max().item()
    log("  tiny config canvas, card kernels vs CPU plain: max_abs_err {:.3e} "
        "(tolerance 1e-5), occupancy equal: {}".format(
            err, torch.equal(occ.cpu(), ref_occ)))
    check(err <= 1e-5 and torch.equal(occ.cpu(), ref_occ),
          "tiny canvas differs from the CPU path")


def timed_scans_per_s(model, points, iters):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        model.test_forward({"data": points})
    torch.cuda.synchronize()
    return BATCH * iters / (time.perf_counter() - t0)


def phase_timing(model, points):
    import torch
    # timing runs as a server would: cuDNN free to pick (and autotune) its
    # fastest algorithms for the fixed shapes; TF32 stays off
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    for _ in range(3):                      # warm-up, both paths
        model.test_forward({"data": points})
        with plain_path():
            model.test_forward({"data": points})
    rates = {"kernels": [], "plain": []}
    half = ITERS // 2
    for order in (("kernels", "plain"), ("plain", "kernels")):
        for path in order:
            if path == "plain":
                with plain_path():
                    rates[path].append(timed_scans_per_s(model, points,
                                                         half))
            else:
                rates[path].append(timed_scans_per_s(model, points, half))
    rate = {k: BATCH * ITERS / sum(BATCH * half / r for r in v)
            for k, v in rates.items()}
    log("phase 4: {} iterations of batch {} (kernel/plain/plain/kernel "
        "halves, cudnn.benchmark on): kernel path {:.2f} scans/s, plain "
        "path {:.2f} scans/s; halves {}".format(
            ITERS, BATCH, rate["kernels"], rate["plain"],
            {k: [round(x, 2) for x in v] for k, v in rates.items()}))
    torch.cuda.reset_peak_memory_stats()
    model.test_forward({"data": points})
    log("  peak device memory of one forward: {:.1f} MiB".format(
        torch.cuda.max_memory_allocated() / 2**20))
    profile(model, points)
    return rate


def profile(model, points):
    """Device time by kernel over 3 iterations of the kernel path."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            model.test_forward({"data": points})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    # device-side events only: a CPU op's own device time repeats the time
    # of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / 3
    if not events:
        log("  profile: no device time in the trace (not measured)")
        return
    log("  profile per iteration: wall {:.3f} ms, device busy {:.3f} ms "
        "(idle share {:.3f}); top device ops:".format(
            wall_ms, dev_ms, 1 - dev_ms / wall_ms))
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:12]:
        log("    {:9.3f} ms  x{:<5d} {}".format(
            e.self_device_time_total / 1e3 / 3, e.count // 3, e.key[:90]))


def main():
    try:
        import torch
    except ImportError:
        sys.exit("chip_smoke: torch is not installed")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "false)")
    sys.path.insert(0, REPO)
    try:
        import bench  # noqa: F401  (make_scans: numpy only)
        from paddle3d_tpu_torch.apis import Config
    except ImportError as e:
        sys.exit("chip_smoke: the port is not beside this script: {}"
                 .format(e))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log("card: {}".format(card))
    # f32 comparisons: no TF32 in convolutions or matmuls; deterministic
    # cuDNN so that the kernel and plain paths see the same conv arithmetic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        phase_build()
        device = torch.device("cuda")
        model = Config(path=KITTI, device=device).model.eval()
        points = make_points(device)
        errs, times = phase_kernels(model, points)
        launches = phase_model(model, points)
        phase_tiny_canvas()
        phase_timing(model, points)
    except PhaseError as e:
        sys.exit("chip_smoke: FAILED: {}".format(e))
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, tpu, _) in KERNELS.items()]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

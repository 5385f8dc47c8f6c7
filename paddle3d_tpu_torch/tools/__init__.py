"""Command-line entry points of the port: `python -m
paddle3d_tpu_torch.tools.train`, `.evaluate` and
`.create_det_gt_database`."""

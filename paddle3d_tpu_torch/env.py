"""Environment info and home dirs, torch port of paddle3d_tpu/env.py: the
diagnostics name torch, CUDA and the card in place of jax. Nothing is
created at import; `_ensure_dirs` makes the home dirs on demand.
"""
import os
import platform
import sys

__all__ = ["HOME", "PRETRAINED_HOME", "TMP_HOME", "get_env_info", "nranks",
           "local_rank"]

HOME = os.path.expanduser("~/.paddle3d_tpu_torch")
PRETRAINED_HOME = os.path.join(HOME, "pretrained")
TMP_HOME = os.path.join(HOME, "tmp")


def _ensure_dirs():
    for d in (HOME, PRETRAINED_HOME, TMP_HOME):
        os.makedirs(d, exist_ok=True)


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def nranks() -> int:
    """torch.distributed's world size, 1 without a process group."""
    dist = _dist()
    return dist.get_world_size() if dist else 1


def local_rank() -> int:
    """torch.distributed's rank, 0 without a process group."""
    dist = _dist()
    return dist.get_rank() if dist else 0


def get_env_info() -> dict:
    """Python, platform, torch, its CUDA, the cards and the process
    group's size."""
    import torch
    info = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "devices": [torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())],
        "process_count": nranks(),
    }
    if torch.cuda.is_available():
        info["cudnn"] = torch.backends.cudnn.version()
    return info

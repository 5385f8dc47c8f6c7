"""Host C++ libraries of the port's readers: built with g++ on first use
and loaded through ctypes, whose calls release the GIL, so that a loader's
threads run them in parallel.

`host_library(source, stem)` builds csrc/host/<source> into
build/host/lib<stem>_<hash>.so, the hash taken over the source and the
flags, so that an edited source builds anew and a stale library is never
loaded. The build runs in a private directory and is renamed into place,
so that a concurrent build never loads a half-written library; a lock
keeps one build a library in a process. A failed build raises: there is
no fallback.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["host_library", "library_path", "HOST_SRC", "BUILD_DIR",
           "CXX_FLAGS"]

_PKG = Path(__file__).resolve().parents[1]
HOST_SRC = _PKG / "csrc" / "host"
BUILD_DIR = _PKG.parent / "build" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded = {}


def library_path(source: Path, stem: str) -> Path:
    """Where the library of `source` lives once built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / "lib{}_{}.so".format(stem, h.hexdigest()[:16])


def _build(source: Path, path: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        tmp = work / path.name
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: {} is host C++ built on first "
                               "use (set CXX)".format(source.name))
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("building {} failed:\n{}".format(
                source.name, res.stdout + res.stderr))
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def host_library(source: str, stem: str) -> ctypes.CDLL:
    """The library of csrc/host/<source>, built on first use and loaded
    once a process."""
    lib = _loaded.get(stem)
    if lib is not None:
        return lib
    with _lock:
        if stem not in _loaded:
            src = HOST_SRC / source
            path = library_path(src, stem)
            if not path.exists():
                _build(src, path)
            _loaded[stem] = ctypes.CDLL(str(path))
    return _loaded[stem]

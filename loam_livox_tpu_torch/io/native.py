"""The native I/O library (``native/native_io.cpp``): a PCD decoder and a
threaded prefetch queue over PCD files with the reference's drop-oldest
backpressure (``mapping/maximum_mapping_buffer``,
``laser_mapping.hpp:1697-1707``), the counterpart of
``loam_livox_tpu/io/native.py``.

The source is the JAX package's, read as it is.  At first use it is
compiled with ``g++`` into ``loam_livox_tpu_torch/_build/`` (git-ignored),
named by a hash of the source, the interpreter's extension suffix and
numpy's version, under a file lock so that concurrent processes (test
workers) build it once; it is never built into ``native/``.  A failed
build raises.

`plain_decode_pcd_file` and `PlainFrameQueue` are the plain Python
versions of the two, with the same semantics; the tests hold the native
ones against them.
"""
from __future__ import annotations

import glob
import hashlib
import importlib.util
import os
import queue
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .serialization import load_pcd

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG.parent / "native" / "native_io.cpp"
BUILD = PKG / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-Wall", "-shared", "-fPIC"]

_module = None


def library_path() -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    stamp = f"{suffix} numpy {np.__version__}".encode()
    digest = hashlib.sha256(SOURCE.read_bytes() + stamp).hexdigest()[:12]
    return BUILD / f"_native_io-{digest}{suffix}"


def build() -> Path:
    """Compile the library unless it is built; returns its path.  Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    import fcntl

    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(exist_ok=True)
    with open(BUILD / "native_io.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():            # built by another process meanwhile
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, f"-I{sysconfig.get_paths()['include']}",
               f"-I{np.get_include()}", "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


def load():
    """The native module, built if needed."""
    global _module
    if _module is None:
        spec = importlib.util.spec_from_file_location("_native_io", build())
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _module = mod
    return _module


def decode_pcd_file(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(xyz (N, 3) float32, intensity (N,) or None) of a PCD file."""
    return load().decode_pcd_file(path)


def decode_pcd(data: bytes) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    return load().decode_pcd(data)


def make_frame_queue(files: List[str], capacity: int = 64):
    """Threaded prefetch queue over PCD files: ``next_frame()`` gives the
    next decoded frame (None when exhausted), ``dropped()`` the frames
    dropped past ``capacity`` (the oldest first)."""
    return load().FrameQueue(list(files), capacity)


def pcd_dir_stream(directory: str, capacity: int = 64):
    """Generator over a directory of frame-ordered .pcd files."""
    q = make_frame_queue(sorted(glob.glob(os.path.join(directory, "*.pcd"))), capacity)
    while True:
        item = q.next_frame()
        if item is None:
            return
        yield item


# ---- the plain versions ----------------------------------------------------

def plain_decode_pcd_file(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    return load_pcd(path)


class PlainFrameQueue:
    """The queue in Python: one thread decodes the files in order and,
    past ``capacity`` undelivered frames, drops the oldest."""

    def __init__(self, files: List[str], capacity: int = 64):
        self._q: queue.Queue = queue.Queue()
        self._capacity = capacity
        self._dropped = 0
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._t = threading.Thread(target=self._run, args=(list(files),), daemon=True)
        self._t.start()

    def _run(self, files):
        for f in files:
            item = plain_decode_pcd_file(f)
            with self._lock:
                if self._q.qsize() >= self._capacity:
                    try:
                        self._q.get_nowait()
                        self._dropped += 1
                    except queue.Empty:
                        pass
                self._q.put(item)
        self._done.set()

    def next_frame(self):
        while True:
            try:
                return self._q.get(timeout=0.05)
            except queue.Empty:
                if self._done.is_set() and self._q.empty():
                    return None

    def dropped(self) -> int:
        return self._dropped

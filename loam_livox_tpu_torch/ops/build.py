"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  It is compiled at
first use with ``nvcc`` for ``sm_90a`` into a shared library under
``loam_livox_tpu_torch/_build/`` (named by a hash of the source, so an
edited source rebuilds) and loaded with ``ctypes``.  Nothing here runs
at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


class RunCounter:
    """A kernel's runs, counted on the card by the kernel itself: its
    launch takes the address of a device int64 that one thread of each
    run increments, so a launch recorded into a CUDA graph counts at
    every replay and never at its capture.  One counter a device."""

    def __init__(self):
        self._on: dict = {}

    def address(self, device) -> int:
        """The counter's address on ``device`` (made zero at its first
        use, which must not fall under a graph capture)."""
        import torch

        t = self._on.get(device)
        if t is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a kernel's first launch on a device is under graph "
                                   "capture: launch it once before capturing")
            t = self._on[device] = torch.zeros((), dtype=torch.int64, device=device)
        return t.data_ptr()

    def read(self) -> int:
        """Runs since the last `reset`, on every device (a host read)."""
        return sum(int(t) for t in self._on.values())

    def reset(self) -> None:
        for t in self._on.values():
            t.zero_()
#: the compiler's report (ptxas registers / spills) of each build, kept
#: beside the library
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def compile_all(names) -> None:
    """Compile every named source that is not built yet, one ``nvcc``
    process per source, all started together."""
    BUILD.mkdir(exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            build_logs[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        compile_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib

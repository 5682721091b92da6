"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``pairnet_torch/csrc/<name>.cu`` has a plain C interface. ``nvcc``
compiles it for Hopper into ``pairnet_torch/_build/<name>-<hash>.so``, where
the hash covers the source and the flags, so an edited source rebuilds and
an unchanged one is reused. There is no fallback: a missing ``nvcc`` or a
failed build raises :class:`BuildError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("deform_attn_exact", "deform_attn_quant", "deform_attn_bwd", "masked_attn", "hungarian",
           "nms")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class BuildError(RuntimeError):
    """The CUDA toolchain is missing or a kernel source did not compile."""


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default /usr/local/cuda)."""
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise BuildError(
        "nvcc not found (not on PATH, not under CUDA_HOME="
        f"{home!r}): the port's CUDA kernels cannot be built"
    )


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that has no up-to-date library, all at
    once (one ``nvcc`` process each), and return the library paths."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        errors = []
        for n, (tmp, p) in procs.items():
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"--- {n}.cu (nvcc exit {p.returncode}) ---\n{log}")
            else:
                os.replace(tmp, todo[n])
        if errors:
            raise BuildError("CUDA build failed:\n" + "\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            path = build((name,))[name]
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (cudaGetLastError)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")


def host_shapes(spatial_shapes):
    """(h, w) pairs as a host int array for the C launchers."""
    flat = [int(v) for hw in spatial_shapes for v in hw]
    return (ctypes.c_int * len(flat))(*flat)

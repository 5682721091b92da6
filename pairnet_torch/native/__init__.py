"""ctypes bindings of the native (C++/OpenMP) host data-path kernels.

``preprocess.cc`` is the port's copy of ``pairnet_tpu/native/preprocess.cc``.
It is built with ``g++`` at first use into
``pairnet_torch/_build/preprocess-<hash>.so`` (the hash covers the source
and the flags). :func:`available` says whether it built; :func:`build_error`
says why not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "preprocess.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lib = None
_error: str | None = None
_tried = False
_lock = threading.Lock()


def _load():
    global _lib, _error, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        h = hashlib.sha256(SRC.read_bytes())
        h.update(" ".join(FLAGS).encode())
        target = BUILD_DIR / f"preprocess-{h.hexdigest()[:16]}.so"
        try:
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, target)
            lib = ctypes.CDLL(str(target))
        except (OSError, subprocess.CalledProcessError) as e:
            _error = f"{e}: {getattr(e, 'stderr', '') or ''}".strip()
            return None
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.resize_bilinear_u8.argtypes = [P, I, I, I, P, I, I]
        lib.normalize_pad_f32.argtypes = [P, I, I, P, P, P, I, I]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the native library did not build (None if it did or was not tried)."""
    _load()
    return _error


def resize_bilinear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """uint8 (H, W, C) -> (dh, dw, C), bilinear with half-pixel centres."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    sh, sw, c = img.shape
    out = np.empty((dh, dw, c), np.uint8)
    lib.resize_bilinear_u8(img.ctypes.data, sh, sw, c, out.ctypes.data, dh, dw)
    return out


def normalize_pad(img: np.ndarray, mean: np.ndarray, std: np.ndarray,
                  ph: int, pw: int) -> np.ndarray:
    """uint8 (h, w, 3) -> f32 (ph, pw, 3): (img - mean) / std, zero padded."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((ph, pw, 3), np.float32)
    lib.normalize_pad_f32(img.ctypes.data, h, w, mean.ctypes.data, std.ctypes.data,
                          out.ctypes.data, ph, pw)
    return out

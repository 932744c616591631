"""
Build and load the package's host-side native code (C++ compiled by ``g++``,
loaded with :mod:`ctypes`; no Python headers, the C interface takes ints and
raw pointers).

The shared object lands under ``build/feinsum_tpu_torch/native/`` at the root
of the checkout, beside the CUDA kernels' library, named by a hash of the
source, so an edited source rebuilds.  It is written under a temporary name
and renamed into place, so concurrent builds never leave a torn library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "feinsum_tpu_torch" / "native"


def build_and_load(source_name: str) -> ctypes.CDLL:
    """Compile ``native/<source_name>`` into a shared object named by the
    source's hash (unless it exists) and load it."""
    src = _HERE / source_name
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so_path = BUILD_DIR / f"{src.stem}-{tag}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", str(src),
               "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so_path)
        finally:
            if tmp.exists():
                tmp.unlink()
    return ctypes.CDLL(str(so_path))


def load_canon():
    """The canonical-labeling core, or ``None`` when it cannot be built
    (no ``g++``); callers then use the pure-Python
    :func:`~feinsum_tpu_torch.native.canon_py.canonical_labeling_py`,
    which computes the same labeling."""
    try:
        lib = build_and_load("canon.cpp")
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.fe_canonical_labeling.restype = ctypes.c_int
    lib.fe_canonical_labeling.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    return lib

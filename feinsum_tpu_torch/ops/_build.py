"""
Build and load the package's CUDA kernels.

The sources under ``feinsum_tpu_torch/csrc/`` have a plain C interface; at
first use each is compiled by its own ``nvcc`` process for ``sm_90a``, all
started together, and the objects are linked into one shared library that
is loaded with :mod:`ctypes` (no PyTorch headers, so the build takes
seconds).  The library lands under ``build/feinsum_tpu_torch/`` at the root
of the checkout, named by a hash of the sources and the flags, so an edited
source rebuilds and an unchanged one is reused.  It is written under a
temporary name and renamed into place, so a concurrent or interrupted
build never leaves a torn library behind.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "feinsum_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# (name, restype, argtypes) of every C entry point in csrc/
_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_I64P = ctypes.POINTER(ctypes.c_int64)
_IP = ctypes.POINTER(ctypes.c_int)
_I, _I64 = ctypes.c_int, ctypes.c_int64
_SIGNATURES = (
    ("dg_rows_f32", _I, (_I, _PP, _I64P, _I, _I, _I, _I, _I64, _I, _I, _P)),
    ("dg_rows_f32_smem_bytes", ctypes.c_size_t, (_I, _I, _I, _I)),
    ("dg_rows_f32_max_rows", _I, ()),
    ("ew_product_f32", _I, (_I, _I, _PP, _PP, _I64, _I64, _P)),
    ("ew_product_f32_max_rows", _I, ()),
    ("ew_product_f32_max_ops", _I, ()),
    ("dd_rows", _I, (_I, _PP, _I64P, _I, _I, _I, _I, _I64, _I, _I, _P)),
    ("dd_rows_smem_bytes", ctypes.c_size_t, (_I, _I, _I, _I)),
    ("dd_rows_max_rows", _I, ()),
    ("tc_grid_f32", _I, (_P, _P, _P, _P, _I, _I, _I, _I64, _I, _I, _P)),
    ("tc_grid_f32_tile_rows", _I, (_I,)),
    ("tc_grid_f32_tile_cols", _I, (_I,)),
    ("row_reduce_f32", _I, (_I, _PP, _I64P, _I, _I64, _I, _P)),
    ("row_reduce_f32_max_rows", _I, ()),
    ("row_reduce_f32_max_j", _I, ()),
    ("row_reduce_f32_staged", _I, (_I, _I64, _I64)),
    ("long_reduce_f32", _I, (_I, _PP, _I64P, _IP, _I, _I, _I, _I, _I64, _I,
                             _I, _I, _P, _P)),
    ("long_reduce_f32_max_rows", _I, ()),
    ("dg_rows_3xtf32", _I, (_I, _PP, _I64P, _I, _I, _I, _I, _I64, _I, _I,
                            _P)),
    ("dg_rows_3xtf32_smem_bytes", ctypes.c_size_t, (_I, _I, _I, _I, _I)),
    ("dg_rows_3xtf32_max_rows", _I, ()),
    ("tc_grid_3xtf32", _I, (_P, _P, _P, _P, _I, _I, _I, _I64, _I, _I, _P)),
    ("tc_grid_3xtf32_tile_rows", _I, (_I,)),
    ("tc_grid_3xtf32_tile_cols", _I, (_I,)),
    ("lane_pack_dg_f32", _I, (_I, _PP, _I64P, _I64P, _IP, _I, _I, _I, _I,
                              _I64, _I, _I, _I, _I, _P)),
    ("lane_pack_dg_3xtf32", _I, (_I, _PP, _I64P, _I64P, _IP, _I, _I, _I, _I,
                                 _I64, _I, _I, _I, _I, _P)),
    ("lane_pack_dg_smem_bytes", ctypes.c_size_t, (_I, _I)),
    ("lane_pack_dg_max_rows", _I, ()),
    ("step_block_f32", _I, (_I, _I, _PP, _I64P, _I, _IP, _I64P, _IP, _I64P,
                            _P, _I64, _I, _I, _I64, _I, _I, _P, _P)),
    ("step_block_f32_max_rows", _I, ()),
    ("tc_steps_f32", _I, (_I, _PP, _P, _I, _IP, _IP, _I, _I64P, _P, _I64,
                          _I, _I, _P)),
    ("probe_stream_f32", _I, (_I, _PP, _I64P, _P, _I64P, _I64P,
                              ctypes.c_float, _I, _I, _I64, _P)),
    ("probe_apply_f32", _I, (_I, _PP, _PP, _PP, _PP, _P, _I, _I, _I, _I64P,
                             _I, _I64, _I, _I, _I, _P)),
    ("probe_apply_3xtf32", _I, (_I, _PP, _PP, _PP, _PP, _P, _I, _I, _I,
                                _I64P, _I, _I64, _I, _I, _I, _P)),
    ("probe_apply_max_rows", _I, ()),
    ("probe_apply_max_s", _I, ()),
    ("probe_apply_max_dim", _I, ()),
)

# what the last build printed (nvcc's -Xptxas -v register and shared-memory
# report) and how long it took; empty when the library came from the cache
build_info = {"seconds": 0.0, "log": "", "path": ""}


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, else from ``PATH``; raises
    ``RuntimeError`` if there is none."""
    if os.environ.get("CUDA_HOME"):
        cand = os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the"
        " feinsum_tpu_torch CUDA kernels cannot be built")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libfeinsum_kernels_{_digest()}.so"


def _run_all(cmds: list) -> list:
    """Run the commands concurrently; their (stdout + stderr) texts.  Raises
    if any fails."""
    procs = []
    logs, failed = [], []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=600)
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def _compile(target: Path) -> None:
    nvcc = find_nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmpdir:
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in _sources()]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                         for src, obj in zip(_sources(), objs)])
        tmp = os.path.join(tmpdir, target.name)
        logs += _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, target)
    build_info.update(seconds=time.perf_counter() - t0, log="".join(logs),
                      path=str(target))


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed.  A failed build
    raises; nothing falls back."""
    target = library_path()
    if not target.exists():
        _compile(target)
    lib = ctypes.CDLL(str(target))
    for name, restype, argtypes in _SIGNATURES:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib

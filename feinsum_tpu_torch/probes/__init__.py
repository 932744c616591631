"""
The TPU probes as Hopper probes.

Each module asks on the card the question its TPU script under ``scripts/``
asked on a v5e, named after the script without its ``tpu_`` prefix, and
runs from the root of a checkout as ``python -m
feinsum_tpu_torch.probes.<name>`` (``--cpu``: the small CPU mode, every
case checked against its plain version, nothing timed):

* ``layout_probe``: the copy in four storages, the transposing copy
  (E, 35) -> (35, E) (what ``apply._RETILE_GBPS`` prices), the matvec
  element-major and dof-major;
* ``fold_probe`` - ``fold_probe5``: the fold-8 storage (nd, 8, E / 8), a view
  of dof-major (nd, E), against dof-major: copies, the matvec under the
  folded mappings I (a block takes elements from each of the 8 runs) and III
  (from one run), the kron matvec ``(D kron I_8) @ u`` and the div ``Σ_s J_s
  (D_s @ u)``, in f32 and at the port's ``bf16_3x`` (3xTF32);
* ``kron_probe``: the kron matvec with and without ``jac[f, c]``, the
  two-stream copy ``j,ej->ej`` on the port's own route and a profile of
  ``xre,ei->xei``;
* ``lane_reshape_probe``: the lane-pack "taxes": B - A (a reshape and
  broadcast on a streamed block) and C - D (the same on a dot's result).

A module builds nothing at import.  Its cases are functions of ``device``
and ``seed``; inputs are drawn from ``np.random.default_rng(seed)`` (the
scripts' spot checks use seed 0) through a ``torch.Generator`` on the
device.  The kernels are ``ops/probe_kernels.py``'s ``probe_stream_f32``
and ``probe_apply_f32`` / ``probe_apply_3xtf32``.  :func:`run_case` checks
a case against its plain version (f32: 2e-5 of max|plain|; 3x:
:func:`split_tolerance` of the sum of the terms' magnitudes) and, on the
card, times the kernel, the plain version and one PyTorch call of the same
function (``measure.timeit_cuda``, in turns), beside the roofline bound
of the same work at the data-sheet peaks.  This replaces the scripts'
in-graph ``fori_loop`` differencing, a TPU-relay device.

The TPU's block sizes (``blk``, ``blkC``) become the kernels' elements
per thread block (``block_elems``); each sweep starts with the kernel's
own default.  The scripts' VMEM limit and ``dimension_semantics`` have no
Hopper meaning and are dropped.  TPU precisions map onto the port's two
routes: ``HIGHEST`` and the default are f32; ``X3``, ``bfloat16_3x`` and
the manual bf16 split are all ``bf16_3x``, three TF32 tensor-core passes
(each line names the TPU label beside the route).
"""

from __future__ import annotations

import math
import statistics
import sys
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..cl_utils import default_device
from ..ops.probe_kernels import (
    ApplyRow, probe_apply_3x_plain, probe_apply_3xtf32, probe_apply_f32,
    probe_apply_plain, probe_stream_f32, probe_stream_plain)

E_FULL = 1 << 20       # the scripts' long axis
E_CPU = 1 << 12        # the CPU mode's
F = 8                  # the fold: (nd, E) stored as (nd, F, E / F)
RTOL = 2e-5            # f32: the oracle's rule, of max|plain|
# a 3x kernel against its plain version, over the sum of the terms'
# magnitudes (chip_smoke.py's rule): the same split summed in another
# order, both in float32, growing as sqrt(K / 64) past K = 64
RTOL_3X = 1e-6
# the data-sheet peaks of the roofline bound (NVIDIA H100 SXM at 700 W)
PEAK_BYTES_PER_MS = 3.35e9
PEAK_F32_OPS_PER_MS = 67e9
PEAK_TF32_OPS_PER_MS = 495e9


def split_tolerance(K: int) -> float:
    return RTOL_3X * max(1.0, math.sqrt(K / 64))


class ProbeFailure(RuntimeError):
    pass


def draw(rng: np.random.Generator, shape: tuple,
         device: torch.device) -> torch.Tensor:
    """A standard-normal float32 tensor on *device*, from a
    ``torch.Generator`` there seeded by *rng*."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 62)))
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def fold(t: torch.Tensor, f: int = F) -> torch.Tensor:
    """The folded storage (nd, f, E / f) of a dof-major (nd, E) tensor: a
    view of the same bytes (e = s * (E / f) + c)."""
    nd, E = t.shape
    if E % f:
        raise ValueError(f"E = {E} is not a multiple of the fold {f}")
    return t.view(nd, f, E // f)


def kron_eye(D: torch.Tensor, f: int = F) -> torch.Tensor:
    """``kron(D, I_f)``: ``[(i, s), (j, t)] = D[i, j] * (s == t)``."""
    eye = torch.eye(f, dtype=D.dtype, device=D.device)
    return torch.einsum("ij,st->isjt", D, eye).reshape(D.shape[0] * f,
                                                       D.shape[1] * f)


def bound_ms(nbytes: float, flops: float = 0.0,
             precision: str = "f32") -> tuple:
    """``(bytes ms, operations ms)``: *nbytes* over the peak memory rate,
    *flops* over the peak rate of the route (f32 on the CUDA cores; ``3x``:
    three TF32 tensor-core passes); the bound is the larger."""
    t_ops = (3 * flops / PEAK_TF32_OPS_PER_MS if precision == "3x"
             else flops / PEAK_F32_OPS_PER_MS)
    return nbytes / PEAK_BYTES_PER_MS, t_ops


def _as_list(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _abs(arrays: dict) -> dict:
    return {k: v.abs() for k, v in arrays.items()}


@dataclass
class Result:
    """A case's check and times (ms; None where not measured)."""

    label: str
    kernel: str
    max_abs_err: float
    rel_err: float
    over_terms: Optional[float]
    bytes_ms: float
    ops_ms: float
    ms: Optional[float] = None
    plain_ms: Optional[float] = None
    library_ms: Optional[float] = None
    gbps: Optional[float] = None
    # the kernel's and the library call's time as CUDA graphs (no host
    # time), where the case asks for it
    graph_ms: Optional[float] = None
    graph_library_ms: Optional[float] = None

    @property
    def bound(self) -> float:
        return max(self.bytes_ms, self.ops_ms)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_ms >= self.ops_ms else "operations"


@dataclass
class Case:
    """One probe case: the kernel's call, its plain version and one PyTorch
    call of the same function (``library``; None where there is none), each
    a function of ``arrays``; the TPU script's byte count (``gbytes``, for
    its effective GB/s), the bytes and flops of the bound; for a 3x case the
    contracted length and the sum of the terms' magnitudes (``terms``)."""

    label: str
    kernel: str
    fn: Callable[[dict], Any]
    plain: Callable[[dict], Any]
    library: Optional[Callable[[dict], Any]]
    arrays: dict
    gbytes: float
    nbytes: float
    flops: float = 0.0
    precision: str = "f32"
    K: int = 0
    terms: Optional[Callable[[dict], Any]] = None
    # the TPU probes' kernel it stands for (PERF.md's table): "P-copy",
    # "P-mv", "P-kron", "P-div", "P-lane", or "transpose" and "route"
    family: str = "P-mv"
    # also time the kernel and the library call as CUDA graphs
    graph: bool = False

    def run(self, *, time: bool = True) -> Result:
        return run_case(self.label, self.fn, self.plain, self.library,
                        self.arrays, kernel=self.kernel, gbytes=self.gbytes,
                        nbytes=self.nbytes, flops=self.flops,
                        precision=self.precision, K=self.K,
                        terms=self.terms, time=time, graph=self.graph)


def graph_ms(fn, arrays: dict) -> float:
    """Median milliseconds of ``fn(arrays)`` replayed as a CUDA graph: the
    device's time for the call without the host's (the kernel wrappers
    spend 0.06-0.12 ms of host time per call, more than the device time of
    a small stream).  As ``measure.timeit_cuda``: warm-up calls first,
    ``TIMED_REPS`` replays each between its own CUDA events, the L2 cache
    overwritten before each when the data fit in it."""
    from ..measure import L2_BYTES, TIMED_REPS, WARMUP_REPS, \
        _working_set_bytes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP_REPS):
            outs = fn(arrays)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn(arrays)
    scratch = (torch.empty(2 * L2_BYTES, dtype=torch.uint8,
                           device=outs[0].device)
               if _working_set_bytes(arrays, outs) < L2_BYTES else None)
    pairs = []
    for _ in range(TIMED_REPS):
        if scratch is not None:
            scratch.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _timed(routes: dict, arrays: dict) -> dict:
    """ms of each route, timed in turns (each, then each again in reverse
    order): the mean of its two medians, and the two."""
    from ..measure import timeit_cuda
    order = list(routes)
    runs = {k: [] for k in order}
    for k in order + order[::-1]:
        runs[k].append(timeit_cuda(routes[k], arrays))
    return runs


def run_case(label: str, fn, plain, library, arrays: dict, *, kernel: str,
             gbytes: float, nbytes: float, flops: float = 0.0,
             precision: str = "f32", K: int = 0, terms=None,
             time: bool = True, graph: bool = False) -> Result:
    """Check ``fn(arrays)`` against ``plain(arrays)`` (f32: within
    ``RTOL`` of max|plain|; 3x: within :func:`split_tolerance` of
    ``terms(arrays)``) and, on the card when *time*, time the kernel, the
    plain version and the library call in turns (with *graph*, the kernel
    and the library call also as CUDA graphs, :func:`graph_ms`); print one
    line.  Raises :class:`ProbeFailure` when the check fails."""
    got = [g.double() for g in _as_list(fn(arrays))]
    want = [w.double() for w in _as_list(plain(arrays))]
    if len(got) != len(want):
        raise ProbeFailure(f"{label}: {len(got)} outputs, the plain version"
                           f" {len(want)}")
    abs_err, scale = 0.0, 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise ProbeFailure(f"{label}: shape {tuple(g.shape)}, the plain"
                               f" version's {tuple(w.shape)}")
        if not bool(g.isfinite().all()):
            raise ProbeFailure(f"{label}: non-finite output")
        abs_err = max(abs_err, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    rel = abs_err / (scale or 1.0)
    over = None
    if precision == "3x":
        over = max(float(((g - w).abs() / t.double().clamp_min(1e-300))
                         .max())
                   for g, w, t in zip(got, want, _as_list(terms(arrays))))
        ok, rule = over <= split_tolerance(K), (
            f"{over:.2e} of the terms' magnitudes (tolerance"
            f" {split_tolerance(K):.2e})")
    else:
        ok, rule = rel <= RTOL, f"tolerance {RTOL}"
    del got, want
    t_bytes, t_ops = bound_ms(nbytes, flops, precision)
    res = Result(label, kernel, abs_err, rel, over, t_bytes, t_ops)
    check = (f"max|kernel-plain| {abs_err:.3e} = {rel:.2e} of max|plain|,"
             f" {rule}")
    if not ok:
        raise ProbeFailure(f"{label}: {kernel} disagrees with its plain"
                           f" version: {check}")
    device = next(iter(arrays.values())).device
    if not time or device.type != "cuda":
        print(f"[probe] {label} ({kernel}): {check} ok (not timed)",
              flush=True)
        return res
    routes = {"kernel": fn, "plain": plain}
    if library is not None:
        routes["library"] = library
    # timeit_cuda takes a list of outputs
    runs = _timed({k: (lambda a, f=f: _as_list(f(a)))
                   for k, f in routes.items()}, arrays)
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    res.ms, res.plain_ms = ms["kernel"], ms["plain"]
    res.library_ms = ms.get("library")
    res.gbps = gbytes / (res.ms * 1e-3)
    lib = (f"{res.library_ms:.4f} ms" if res.library_ms is not None
           else "none")
    graphs = ""
    if graph:
        res.graph_ms = graph_ms(lambda a: _as_list(fn(a)), arrays)
        graphs = f", as a CUDA graph {res.graph_ms:.4f} ms"
        if library is not None:
            res.graph_library_ms = graph_ms(lambda a: _as_list(library(a)),
                                            arrays)
            graphs += f" (library {res.graph_library_ms:.4f} ms)"
    print(f"[probe] {label} ({kernel}): {res.ms:.4f} ms, {res.gbps:.1f}"
          f" GB/s by the script's bytes, bound {res.bound:.4f} ms"
          f" ({res.bound_by}), plain {res.plain_ms:.4f} ms, library {lib}"
          f"{graphs}; {check} ok", flush=True)
    return res


def tensor_bytes(arrays: dict) -> float:
    """The bytes of the stored inputs, each read once."""
    return float(sum(t.numel() * t.element_size() for t in arrays.values()))


def stream_case(label: str, ops_of: Callable[[dict], list], arrays: dict, *,
                gbytes: float, alpha: float = 1.0, block_elems: int = 0,
                library=None, family: str = "P-copy") -> Case:
    """A case of ``probe_stream_f32`` on ``ops_of(arrays)``; its bound is
    the inputs' bytes and the output's."""
    ops = ops_of(arrays)
    out_bytes = 4.0 * ops[0].numel()
    return Case(
        label=label, kernel="probe_stream_f32",
        fn=lambda a: probe_stream_f32(ops_of(a), alpha=alpha,
                                      block_elems=block_elems),
        plain=lambda a: probe_stream_plain(ops_of(a), alpha=alpha),
        library=library, arrays=arrays, gbytes=gbytes,
        nbytes=tensor_bytes(arrays) + out_bytes, family=family)


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def apply_case(label: str, rows_of: Callable[[dict], list], arrays: dict, *,
               gbytes: float, precision: str = "f32", runs: int = 1,
               block_elems: int = 0, out_elem_major: bool = False,
               library=None, family: str = "P-mv") -> Case:
    """A case of ``probe_apply_f32`` (*precision* ``"f32"``) or
    ``probe_apply_3xtf32`` (``"3x"``) on ``rows_of(arrays)`` and
    ``arrays["R"]``.  Its bound: the inputs' bytes and the outputs', and
    2 b S I K E flops (3x: at I and K padded to the m16n8k8 tile's 8)."""
    rows = rows_of(arrays)
    S, I, K = arrays["R"].shape
    E = rows[0].u.shape[1]
    b = len(rows)
    split = precision == "3x"
    kern = probe_apply_3xtf32 if split else probe_apply_f32
    plain = probe_apply_3x_plain if split else probe_apply_plain
    flops = 2.0 * b * S * (_pad(I, 8) * _pad(K, 8) if split else I * K) * E

    def terms(a):
        m = _abs(a)
        return probe_apply_plain(rows_of(m), m["R"],
                                 out_elem_major=out_elem_major)
    return Case(
        label=label, kernel=kern.__name__,
        fn=lambda a: kern(rows_of(a), a["R"], runs=runs,
                          block_elems=block_elems,
                          out_elem_major=out_elem_major),
        plain=lambda a: plain(rows_of(a), a["R"],
                              out_elem_major=out_elem_major),
        library=library, arrays=arrays, gbytes=gbytes,
        nbytes=tensor_bytes(arrays) + 4.0 * b * I * E, flops=flops,
        precision=precision, K=S * K, terms=terms if split else None,
        family=family)


def oracle_error(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Print and return max|got - want| / max|want| against a float64
    reference (the scripts' "rel err" lines)."""
    g, w = got.double(), want.double()
    err = float((g - w).abs().max() / w.abs().max())
    print(f"[oracle] {label}: max|got - float64| / max|float64|"
          f" {err:.2e}", flush=True)
    return err


def cli(cases_of: Callable, name: str, summary: Optional[Callable] = None
        ) -> None:
    """A module's ``main``: on the card (the default) print the card line,
    then run and time every case of ``cases_of(device, seed=0, cpu=...)``
    (a :class:`Case`, or a function of no arguments that runs a check of
    its own); with ``--cpu`` run every case at the small CPU size and check
    it only.  *summary* takes the results."""
    cpu = "--cpu" in sys.argv[1:]
    if cpu:
        device = torch.device("cpu")
    else:
        device = default_device(caller=name)
        from ..tools import card_line
        print(card_line(), flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda};"
              f" {torch.cuda.get_device_name(device)}", flush=True)
    results = []
    for item in cases_of(device, seed=0, cpu=cpu):
        res = item.run(time=not cpu) if isinstance(item, Case) else item()
        if isinstance(res, Result):
            results.append(res)
    if summary is not None:
        summary(results)
    print(f"[probe] {name}: {len(results)} cases done", flush=True)


__all__ = ["ApplyRow", "Case", "E_CPU", "E_FULL", "F", "ProbeFailure",
           "Result", "apply_case", "bound_ms", "cli", "default_device",
           "draw", "fold", "graph_ms", "kron_eye", "oracle_error",
           "run_case", "split_tolerance", "stream_case", "tensor_bytes"]

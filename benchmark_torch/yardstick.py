"""The yardstick: operations and bytes of an einsum and of a whole time
step, counted from shapes; the least time at a device's peaks; the busy
time and idle gaps of a set of device intervals, and which device
operations are PyTorch's own.

Operations follow the optimal contraction path, found here by trying every
pairwise order (the configurations' einsums have at most four operands).
A step of the path over the letters ``dom`` costs ``|dom|`` multiplies,
plus ``|dom|`` adds where it contracts a letter.  Bytes count each logical
operand read once and each output written once, whatever a kernel reads
again.  This module imports nothing of the program: later changes to the
program cannot move it.
"""

from __future__ import annotations

import functools
import json
import math
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def dim(size, cfg: dict, n_elements: int) -> int:
    """A shape entry: an integer, ``"E"`` (the elements) or the name of a
    width in *cfg*."""
    if size == "E":
        return n_elements
    if isinstance(size, str):
        return int(cfg[size])
    return int(size)


def numel(shape, cfg: dict, n_elements: int) -> int:
    return math.prod(dim(s, cfg, n_elements) for s in shape)


def path_flops(inputs: tuple, output: str, sizes: dict) -> int:
    """Least operations of the contraction ``inputs -> output`` over every
    pairwise order (*inputs*: index strings; *sizes*: letter -> extent)."""

    def dom_size(letters) -> int:
        return math.prod(sizes[c] for c in letters)

    @functools.cache
    def best(ops: tuple) -> int:
        if len(ops) == 1:
            (only,) = ops
            if set(only) == set(output):
                return 0
            return dom_size(set(only))          # a lone sum
        least = None
        for a in range(len(ops)):
            for b in range(a + 1, len(ops)):
                rest = [ops[k] for k in range(len(ops)) if k not in (a, b)]
                pair = set(ops[a]) | set(ops[b])
                keep = set(output).union(*map(set, rest)) if rest \
                    else set(output)
                result = "".join(sorted(pair & keep))
                contracted = bool(pair - keep)
                cost = dom_size(pair) * (1 + int(contracted))
                total = cost + best(tuple(sorted(rest + [result])))
                least = total if least is None else min(least, total)
        return least

    return best(tuple(sorted(inputs)))


def einsum_counts(spec: dict, cfg: dict, n_elements: int) -> tuple:
    """``(operations, bytes)`` of one einsum of a configuration: its rows'
    operations, each distinct operand read once, each row's output written
    once."""
    ins, out = spec["subscripts"].replace(" ", "").split("->")
    ins = ins.split(",")
    shapes = spec["shapes"]
    sizes = {}
    for letters, name in zip(ins, spec["rows"][0]):
        for c, s in zip(letters, shapes[name]):
            sizes[c] = dim(s, cfg, n_elements)
    flops = len(spec["rows"]) * path_flops(tuple(ins), out, sizes)
    itemsize = _itemsize(cfg)
    operands = {name for row in spec["rows"] for name in row}
    reads = sum(numel(shapes[name], cfg, n_elements) for name in operands)
    writes = len(spec["rows"]) * math.prod(sizes[c] for c in out)
    return flops, itemsize * (reads + writes)


def step_counts(cfg: dict, n_elements: int) -> tuple:
    """``(operations, bytes)`` of one time step: the operations of its
    einsums; its state and geometry read once and its new state written
    once."""
    flops = sum(einsum_counts(spec, cfg, n_elements)[0]
                for spec in cfg["einsums"])
    state = sum(numel(s, cfg, n_elements) for s in cfg["state"].values())
    geom = sum(numel(s, cfg, n_elements) for s in cfg["geometry"].values())
    return flops, _itemsize(cfg) * (2 * state + geom)


def _itemsize(cfg: dict) -> int:
    return {"float32": 4, "float64": 8}[cfg["dtype"]]


def device_peaks(device_name: str):
    """``{"flops": {dtype: FLOP/s}, "bytes_per_s": B/s}`` of the data sheet
    for *device_name*, or ``None`` for a device the table lacks."""
    return json.loads(PEAKS_FILE.read_text())["devices"].get(device_name)


def least_time(flops: float, nbytes: float, peaks: dict, dtype: str) -> tuple:
    """``(seconds, "flops" | "bytes")``: the larger of operations over the
    compute peak and bytes over the memory peak, and which one it is."""
    t_flops = flops / peaks["flops"][dtype]
    t_bytes = nbytes / peaks["bytes_per_s"]
    return (t_flops, "flops") if t_flops >= t_bytes else (t_bytes, "bytes")


def einsums_least_time(cfg: dict, n_elements: int, peaks: dict) -> float:
    """The sum over the step's einsums of each one's least time."""
    return sum(least_time(*einsum_counts(spec, cfg, n_elements), peaks,
                          cfg["dtype"])[0] for spec in cfg["einsums"])


def busy_seconds(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def idle_gaps(intervals) -> list:
    """``(start, end)`` of each gap between the merged intervals."""
    gaps, end = [], None
    for lo, hi in sorted(intervals):
        if end is not None and lo > end:
            gaps.append((end, lo))
        end = hi if end is None else max(end, hi)
    return gaps


def is_pytorch_kernel(name: str) -> bool:
    """Whether a device operation of the trace is PyTorch's own (an ATen
    kernel, such as the step's adds, scales and ``torch.stack``, or a copy
    or fill) rather than a kernel of the program."""
    return "at::" in name or name.lower().startswith(("memcpy", "memset"))

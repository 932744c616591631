"""What a lane reshape and broadcast cost on the card
(``scripts/tpu_lane_reshape_probe.py`` on the H100):

    python -m feinsum_tpu_torch.probes.lane_reshape_probe [--cpu]

The lane-pack rewrites pack g elements of a d-dof operand into one row of
g * d values, x (E / g, g d), and apply a per-element factor j (E / g, g)
broadcast over d.  ``probe(d, g)`` (``:80-140``, one ``pallas_call`` site,
``:52``) times four kernels, f32, E = 2**20 (``--cpu``: the script's
``--interpret`` smoke size, E = 2**12, checked only):

* A ``out = 2 x`` (``:93``), ``probe_stream_f32``, the streaming floor;
* B ``out = (x viewed (rows, g, d)) * j[:, :, None]`` (``:96``),
  ``probe_stream_f32`` with j as a (rows, g, d) view of strides (g, 1, 0);
* C ``out = ((x @ K) viewed (rows, g, d)) * j[:, :, None]`` (``:101``),
  ``probe_apply_f32`` with R = K^T, u = x^T (element-major), sigma = j over
  the output's rows split (g, d);
* D ``out = x @ K`` (``:109``), ``probe_apply_f32``;

with K (g d, g d) dense, at (d, g) in (4, 32), (10, 64), (20, 32), (35,
16), (4, 8).  It prints the script's "taxes": B - A, the reshape and
broadcast on a streamed operand, and C - D, the same on a computed one.
The script's blocks of 1024 packed rows are ``block_elems`` here (the
kernels' defaults first).
"""

from __future__ import annotations

import numpy as np
import torch

from . import (ApplyRow, E_CPU, E_FULL, apply_case, cli, draw, default_device,
               stream_case)

SHAPES = ((4, 32), (10, 64), (20, 32), (35, 16), (4, 8))
BLK_ROWS = 1024


def lane_arrays(d: int, g: int, device, seed: int, E: int) -> dict:
    """x (E / g, g d), j (E / g, g) and K (g d, g d) (as ``R = K^T``)."""
    if E % g:
        raise ValueError(f"E = {E} is not a multiple of g = {g}")
    rng = np.random.default_rng(seed)
    B, gd = E // g, g * d
    x = draw(rng, (B, gd), device)
    j = draw(rng, (B, g), device)
    K = draw(rng, (gd, gd), device)
    return {"x": x, "j": j, "R": K.t().contiguous()[None]}


def kernel_case(kind: str, d: int, g: int, device=None, seed: int = 0, *,
                E: int = E_FULL, block: int = 0):
    """Kernel *kind* (``"A"``-``"D"``) of ``probe(d, g)`` with *block*
    packed rows per thread block (0: the kernel's default), timed also as
    a CUDA graph (the taxes compare device times)."""
    case = _kernel_case(kind, d, g, device, seed, E=E, block=block)
    case.graph = True
    return case


def _kernel_case(kind, d, g, device, seed, *, E, block):
    device = default_device(device, caller="lane_reshape_probe.kernel_case")
    B, gd = E // g, g * d
    arrays = lane_arrays(d, g, device, seed, E)
    x_bytes = 4 * B * gd
    bytes_a = 2 * x_bytes / 1e9
    bytes_b = (2 * x_bytes + 4 * B * g) / 1e9
    label = f"d={d} g={g} {kind} blk {block or 'default'}"
    if kind in "AB":
        del arrays["R"]
        if kind == "A":
            return stream_case(
                label, lambda a: [a["x"]], {"x": arrays["x"]},
                gbytes=bytes_a, alpha=2.0, block_elems=gd * block,
                library=lambda a: torch.mul(a["x"], 2.0), family="P-lane")

        def ops(a):
            return [a["x"].view(B, g, d), a["j"][:, :, None].expand(B, g, d)]
        return stream_case(
            label, ops, arrays, gbytes=bytes_b, block_elems=gd * block,
            library=lambda a: torch.mul(a["x"].view(B, g, d),
                                        a["j"][:, :, None]), family="P-lane")
    if kind == "C":
        def rows(a):
            return [ApplyRow(u=a["x"].t(),
                             sigma=a["j"].t()[:, None, :].expand(g, d, B))]

        def library(a):
            return torch.einsum("bk,gdk,bg->bgd", a["x"],
                                a["R"][0].view(g, d, gd), a["j"])
        gbytes = bytes_b
    else:
        del arrays["j"]

        def rows(a):
            return [ApplyRow(u=a["x"].t())]

        def library(a):
            return torch.matmul(a["x"], a["R"][0].t())
        gbytes = bytes_a
    return apply_case(label, rows, arrays, gbytes=gbytes, block_elems=block,
                      out_elem_major=True, library=library, family="P-lane")


def cases(device=None, seed: int = 0, *, cpu: bool = False,
          first_block_only: bool = False):
    device = default_device(device, caller="lane_reshape_probe.cases")
    E = E_CPU if cpu else E_FULL
    for d, g in SHAPES:
        for block in (0, BLK_ROWS)[:1 if first_block_only else 2]:
            for kind in "ABCD":
                yield kernel_case(kind, d, g, device, seed, E=E, block=block)


def taxes(results) -> None:
    """The script's B - A and C - D, per (d, g) and block, on the CUDA
    graph times (the device's) and on the event times of single calls."""
    by = {r.label: r for r in results}
    for r in results:
        if " A blk" not in r.label or r.ms is None:
            continue
        head, tail = r.label.split(" A blk")
        a, b, c, dd = (by[f"{head} {k} blk{tail}"] for k in "ABCD")
        for name, x, y in (("reshape+broadcast (B-A)", b, a),
                           ("on a computed operand (C-D)", c, dd)):
            print(f"[tax] {head} blk{tail}: {name}"
                  f" {1e3 * (x.graph_ms - y.graph_ms):+8.1f} us"
                  f" ({100 * (x.graph_ms - y.graph_ms) / y.graph_ms:+.1f}%)"
                  f" as CUDA graphs, {1e3 * (x.ms - y.ms):+8.1f} us"
                  f" ({100 * (x.ms - y.ms) / y.ms:+.1f}%) per call",
                  flush=True)


def main() -> None:
    cli(cases, "lane_reshape_probe", summary=taxes)


if __name__ == "__main__":
    main()

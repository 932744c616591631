"""How the card streams DG data in one storage or another
(``scripts/tpu_layout_probe.py`` on the H100):

    python -m feinsum_tpu_torch.probes.layout_probe [--cpu]

Copy ``y = a * b`` over logically (E, 35) float32, E = 2**20, on
``probe_stream_f32``:

* A (E, 35) element-major (the script's blocks (blk, 35)), B flat
  (35 E,), C flat 2-D (35 E / 128, 128), D dof-major (35, E) (``:75``, the
  one case the script ran, blocks (35, 32768)).  The kernel merges every
  axis that all tensors walk contiguously, so on the card the four are one
  stream of the same bytes; the TPU's block of blk long-axis elements is
  ``35 * blk`` floats per thread block here (the kernel's default first:
  one float4 per thread);
* the transposing copy (E, 35) -> (35, E) and back, through the kernel's
  shared-memory tile, against ``permute(1, 0).contiguous()``: the relayout
  that ``apply._RETILE_GBPS`` prices (320.4 GB/s for the permute copy).

Matvec ``out[e, i] = Σ_j D[i, j] u[e, j]`` on ``probe_apply_f32``: E, u and
out element-major (E, 35) (``:101``, blk 8192 elements per block); F,
dof-major (35, E) (``:119``, blk 32768).
"""

from __future__ import annotations

import numpy as np
import torch

from . import (ApplyRow, E_CPU, E_FULL, apply_case, cli, draw, default_device,
               stream_case)

ND = 35
# (label, storage shape of a logically (E, ND) array, the TPU block in
# long-axis elements)
COPY_LAYOUTS = (("A copy (E,35)", lambda E: (E, ND), 32768),
                ("B copy flat (35E,)", lambda E: (E * ND,), 32768),
                ("C copy flat (35E/128,128)", lambda E: (E * ND // 128, 128),
                 32768),
                ("D copy transposed (35,E)", lambda E: (ND, E), 32768))


def copy_case(layout: int, device=None, seed: int = 0, *, E: int = E_FULL,
              block: int = 0):
    """Copy ``y = a * b`` in storage ``COPY_LAYOUTS[layout]`` with *block*
    long-axis elements per thread block (0: the kernel's default)."""
    device = default_device(device, caller="layout_probe.copy_case")
    label, shape, _ = COPY_LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    arrays = {"a": draw(rng, shape(E), device),
              "b": draw(rng, shape(E), device)}
    return stream_case(
        f"{label} blk {block or 'default'}", lambda a: [a["a"], a["b"]],
        arrays, gbytes=3 * E * ND * 4 / 1e9, block_elems=ND * block,
        library=lambda a: torch.mul(a["a"], a["b"]))


def transpose_case(device=None, seed: int = 0, *, E: int = E_FULL,
                   to_dof_major: bool = True):
    """The transposing copy (E, 35) -> (35, E) (or back) on the kernel's
    tile, against ``permute(1, 0).contiguous()``."""
    device = default_device(device, caller="layout_probe.transpose_case")
    rng = np.random.default_rng(seed)
    shape = (E, ND) if to_dof_major else (ND, E)
    arrays = {"a": draw(rng, shape, device)}
    label = ("transpose (E,35)->(35,E)" if to_dof_major
             else "transpose (35,E)->(E,35)")
    return stream_case(
        label, lambda a: [a["a"].permute(1, 0)], arrays,
        gbytes=2 * E * ND * 4 / 1e9, family="transpose",
        library=lambda a: a["a"].permute(1, 0).contiguous())


def matvec_case(element_major: bool, device=None, seed: int = 0, *,
                E: int = E_FULL, block: int = 0):
    """Matvec E (element-major, ``:101``) or F (dof-major, ``:119``) with
    *block* elements per thread block (0: the kernel's 128)."""
    device = default_device(device, caller="layout_probe.matvec_case")
    rng = np.random.default_rng(seed)
    D = draw(rng, (ND, ND), device)
    if element_major:
        arrays = {"u": draw(rng, (E, ND), device), "R": D[None]}

        def rows(a):
            return [ApplyRow(u=a["u"].t())]

        def library(a):
            return torch.einsum("ej,ij->ei", a["u"], a["R"][0])
        label = "E matvec (E,35)"
    else:
        arrays = {"u": draw(rng, (ND, E), device), "R": D[None]}

        def rows(a):
            return [ApplyRow(u=a["u"])]

        def library(a):
            return torch.einsum("ij,je->ie", a["R"][0], a["u"])
        label = "F matvec (35,E)"
    return apply_case(f"{label} blk {block or 'default'}", rows, arrays,
                      gbytes=(E * ND * 2 * 4 + ND * ND * 4) / 1e9,
                      block_elems=block, out_elem_major=element_major,
                      library=library)


def cases(device=None, seed: int = 0, *, cpu: bool = False,
          first_block_only: bool = False):
    """Every case of the module: the copies (each at the kernel's default
    block and at the TPU's), both transposing copies, both matvecs."""
    device = default_device(device, caller="layout_probe.cases")
    E = E_CPU if cpu else E_FULL
    for k, (_, _, tpu_block) in enumerate(COPY_LAYOUTS):
        for block in (0, tpu_block)[:1 if first_block_only else 2]:
            yield copy_case(k, device, seed, E=E, block=block)
    for to_dof_major in (True, False):
        yield transpose_case(device, seed, E=E, to_dof_major=to_dof_major)
    for element_major, tpu_block in ((True, 8192), (False, 32768)):
        for block in (0, tpu_block)[:1 if first_block_only else 2]:
            yield matvec_case(element_major, device, seed, E=E, block=block)


def main() -> None:
    cli(cases, "layout_probe")


if __name__ == "__main__":
    main()

"""Production-shape kernels under the precision strategies
(``scripts/tpu_fold_probe4.py`` on the H100):

    python -m feinsum_tpu_torch.probes.fold_probe4 [--cpu]

The TPU's strategies land on the port's two routes: ``HIGHEST`` (6-pass
bf16) is f32, ``probe_apply_f32``; ``X3`` (``BF16_BF16_F32_X3``) and the
script docstring's manual 3x split are both the port's ``bf16_3x``,
three TF32 tensor-core passes, ``probe_apply_3xtf32`` (the two TPU labels
land on one route, so it runs once).  E = 2**20:

* the matvec at nd 20 and 35: base, dof-major, blk 32768 (``:95``); fold,
  mapping I, blkC 4096 (``:110``);
* the div with b = 3 rows in one launch, the archived K-folded schedule
  ``out_b = R_cat @ cat_s(u_b * J_b[s])`` (the same sum, ``Σ_s J_b[s] *
  (R_s @ u_b)``): base, blk 8192 (``:144``); fold, mapping I, blkC 1024
  (``:163``);
* the X3 accuracy: the fold matvec at blkC 1024 against float64
  (``:201``).

Each sweep starts with the kernel's default block (128 elements).
"""

from __future__ import annotations

import numpy as np
import torch

from . import (ApplyRow, E_CPU, E_FULL, F, apply_case, cli, draw,
               oracle_error, default_device)

ND = 35
# the TPU's precision label -> the port's route
PRECS = {"HIGHEST": "f32", "X3": "3x"}
ROUTE = {"f32": "f32", "3x": "3xTF32"}


def matvec_case(folded: bool, nd: int, tpu_prec: str, device=None,
                seed: int = 0, *, E: int = E_FULL, block: int = 0):
    """The matvec at *nd*: base (``:95``) or fold (``:110``, mapping I),
    at the route of the TPU precision *tpu_prec*."""
    device = default_device(device, caller="fold_probe4.matvec_case")
    rng = np.random.default_rng(seed)
    arrays = {"R": draw(rng, (nd, nd), device)[None],
              "u": draw(rng, (nd, E), device)}
    precision = PRECS[tpu_prec]
    name = "fold" if folded else "base"
    return apply_case(
        f"mv{nd} {name} {tpu_prec} -> {ROUTE[precision]} blk"
        f" {block or 'default'}", lambda a: [ApplyRow(u=a["u"])], arrays,
        gbytes=E * nd * 2 * 4 / 1e9, precision=precision,
        runs=F if folded else 1, block_elems=block,
        library=lambda a: torch.einsum("ij,je->ie", a["R"][0], a["u"]))


def div_arrays(device, seed: int, E: int) -> dict:
    """R (3, 35, 35) and three rows' J (3, E) and u (35, E)."""
    rng = np.random.default_rng(seed)
    arrays = {"R": draw(rng, (3, ND, ND), device)}
    for b in range(3):
        arrays[f"J{b}"] = draw(rng, (3, E), device)
        arrays[f"u{b}"] = draw(rng, (ND, E), device)
    return arrays


def div_rows(a) -> list:
    return [ApplyRow(u=a[f"u{b}"], J=a[f"J{b}"]) for b in range(3)]


def div_library(a) -> list:
    return [torch.einsum("sij,je,se->ie", a["R"], a[f"u{b}"], a[f"J{b}"])
            for b in range(3)]


def div_case(folded: bool, tpu_prec: str, device=None, seed: int = 0, *,
             E: int = E_FULL, block: int = 0):
    """The div, b = 3 rows in one launch: base (``:144``) or fold
    (``:163``, mapping I)."""
    device = default_device(device, caller="fold_probe4.div_case")
    precision = PRECS[tpu_prec]
    name = "fold" if folded else "base"
    return apply_case(
        f"div {name} b=3 {tpu_prec} -> {ROUTE[precision]} blk"
        f" {block or 'default'}", div_rows, div_arrays(device, seed, E),
        gbytes=3 * E * (ND + 3 + ND) * 4 / 1e9, precision=precision,
        runs=F if folded else 1, block_elems=block, library=div_library,
        family="P-div")


def x3_oracle(device=None, seed: int = 0, *, E: int = E_FULL) -> float:
    """X3 (3xTF32) fold matvec, blkC 1024, against float64 (``:201``)."""
    case = matvec_case(True, ND, "X3", device, seed, E=E, block=F * 1024)
    got = case.fn(case.arrays)[0]
    want = case.arrays["R"][0].double() @ case.arrays["u"].double()
    return oracle_error("X3 -> 3xTF32 fold matvec", got, want)


def cases(device=None, seed: int = 0, *, cpu: bool = False,
          first_block_only: bool = False):
    device = default_device(device, caller="fold_probe4.cases")
    E = E_CPU if cpu else E_FULL
    first = 1 if first_block_only else None
    for nd in (20, ND):
        for tpu_prec in PRECS:
            for folded, tpu_block in ((False, 32768), (True, F * 4096)):
                for block in (0, tpu_block)[:first]:
                    yield matvec_case(folded, nd, tpu_prec, device, seed,
                                      E=E, block=block)
    for tpu_prec in PRECS:
        for folded, tpu_block in ((False, 8192), (True, F * 1024)):
            for block in (0, tpu_block)[:first]:
                yield div_case(folded, tpu_prec, device, seed, E=E,
                               block=block)
    yield lambda: x3_oracle(device, seed, E=E)


def main() -> None:
    cli(cases, "fold_probe4")


if __name__ == "__main__":
    main()

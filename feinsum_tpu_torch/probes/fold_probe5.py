"""Native 3x against f32 and the per-run mapping III
(``scripts/tpu_fold_probe5.py`` on the H100):

    python -m feinsum_tpu_torch.probes.fold_probe5 [--cpu]

``HIGHEST`` is f32 (``probe_apply_f32``); the TPU's native
``precision="bfloat16_3x"`` (``n3x``) is the port's ``bf16_3x``, 3xTF32
(``probe_apply_3xtf32``).  E = 2**20:

* the matvec at nd 20 and 35: base, dof-major, blk 32768 (``:87``); fIII,
  folded storage with a block taking its 8 blkC = 32768 elements from one
  run (``:102``);
* the div with b = 3 rows in one launch (K-folded schedule): base, blk
  8192 (``:133``); fIII, blkC 1024 (``:151``);
* the native 3x accuracy: the dof-major matvec at blk 8192 against float64
  (``:187``).

Each sweep starts with the kernel's default block (128 elements).
"""

from __future__ import annotations

import numpy as np
import torch

from . import (ApplyRow, E_CPU, E_FULL, F, apply_case, cli, draw,
               oracle_error, default_device)
from .fold_probe4 import ROUTE, div_arrays, div_library, div_rows

ND = 35
PRECS = {"HIGHEST": "f32", "n3x": "3x"}


def matvec_case(per_run: bool, nd: int, tpu_prec: str, device=None,
                seed: int = 0, *, E: int = E_FULL, block: int = 0):
    """The matvec at *nd*: base (``:87``) or fIII (``:102``: u folded, a
    block inside one run) at the route of *tpu_prec*."""
    device = default_device(device, caller="fold_probe5.matvec_case")
    rng = np.random.default_rng(seed)
    arrays = {"R": draw(rng, (nd, nd), device)[None],
              "u": draw(rng, (nd, E), device)}
    precision = PRECS[tpu_prec]
    name = "fIII" if per_run else "base"
    return apply_case(
        f"mv{nd} {name} {tpu_prec} -> {ROUTE[precision]} blk"
        f" {block or 'default'}",
        lambda a: [ApplyRow(u=a["u"])], arrays,
        gbytes=E * nd * 2 * 4 / 1e9, precision=precision,
        block_elems=block,
        library=lambda a: torch.einsum("ij,je->ie", a["R"][0], a["u"]))


def div_case(per_run: bool, tpu_prec: str, device=None, seed: int = 0, *,
             E: int = E_FULL, block: int = 0):
    """The div, b = 3: base (``:133``) or fIII (``:151``)."""
    device = default_device(device, caller="fold_probe5.div_case")
    precision = PRECS[tpu_prec]
    name = "fIII" if per_run else "base"
    return apply_case(
        f"div {name} b=3 {tpu_prec} -> {ROUTE[precision]} blk"
        f" {block or 'default'}", div_rows, div_arrays(device, seed, E),
        gbytes=3 * E * (ND + 3 + ND) * 4 / 1e9, precision=precision,
        block_elems=block, library=div_library, family="P-div")


def n3x_oracle(device=None, seed: int = 0, *, E: int = E_FULL) -> float:
    """Native 3x (3xTF32) dof-major matvec, blk 8192, against float64
    (``:187``)."""
    case = matvec_case(False, ND, "n3x", device, seed, E=E, block=8192)
    got = case.fn(case.arrays)[0]
    want = case.arrays["R"][0].double() @ case.arrays["u"].double()
    return oracle_error("native 3x -> 3xTF32 matvec", got, want)


def cases(device=None, seed: int = 0, *, cpu: bool = False,
          first_block_only: bool = False):
    device = default_device(device, caller="fold_probe5.cases")
    E = E_CPU if cpu else E_FULL
    first = 1 if first_block_only else None
    for nd in (20, ND):
        for tpu_prec in PRECS:
            for per_run, tpu_block in ((False, 32768), (True, F * 4096)):
                for block in (0, tpu_block)[:first]:
                    yield matvec_case(per_run, nd, tpu_prec, device, seed,
                                      E=E, block=block)
    for tpu_prec in PRECS:
        for per_run, tpu_block in ((False, 8192), (True, F * 1024)):
            for block in (0, tpu_block)[:first]:
                yield div_case(per_run, tpu_prec, device, seed, E=E,
                               block=block)
    yield lambda: n3x_oracle(device, seed, E=E)


def main() -> None:
    cli(cases, "fold_probe5")


if __name__ == "__main__":
    main()

"""Folded mappings I and III and the div on folded storage
(``scripts/tpu_fold_probe2.py`` on the H100):

    python -m feinsum_tpu_torch.probes.fold_probe2 [--cpu]

nd = 35, E = 2**20, u folded (35, 8, C), C = E / 8, a view of dof-major:

* I, the merged view (``:102``): a thread block takes blkC elements from
  each of the 8 runs (``runs=8``), one dot over 8 blkC elements;
* III, per-run slices (``:123``): a block takes its 8 blkC elements from
  one run (``runs=1``);
  each at blkC 2048 and 4096, in f32 and at ``bf16_3x`` (the script's
  manual bf16 split; here 3xTF32), on ``probe_apply_f32`` /
  ``probe_apply_3xtf32``;
* I and III at 3x against float64 (``:337-346``, blkC 4096);
* the div ``out[i, s, c] = Σ_r J[r, s, c] (D_r @ u)[i, s, c]``, S = 3,
  per-run slices (``:191``, blkC 2048), f32 and 3x.

Each sweep starts with the kernel's default block (128 elements; 16 from
each run under mapping I).
"""

from __future__ import annotations

import numpy as np
import torch

from . import (ApplyRow, E_CPU, E_FULL, F, apply_case, cli, draw, fold,
               oracle_error, default_device)

ND = 35
PRECISIONS = ("f32", "3x")


def matvec_case(mapping: str, precision: str, device=None, seed: int = 0,
                *, E: int = E_FULL, blkC: int = 0):
    """Mapping ``"I"`` (``:102``) or ``"III"`` (``:123``) of the folded
    matvec, *blkC* elements of each run (I) or 8 blkC of one (III) per
    thread block (0: the kernel's default)."""
    device = default_device(device, caller="fold_probe2.matvec_case")
    rng = np.random.default_rng(seed)
    arrays = {"R": draw(rng, (ND, ND), device)[None],
              "u": draw(rng, (ND, E), device)}
    runs = F if mapping == "I" else 1
    tag = "3x" if precision == "3x" else "  "
    name = "I   mv reshape" if mapping == "I" else "III mv slices "
    # the folded storage is these bytes; the mapping is the tiling
    return apply_case(
        f"{name} {tag} blk{blkC or ' default'}",
        lambda a: [ApplyRow(u=a["u"])], arrays,
        gbytes=(E * ND * 2 * 4 + ND * ND * 4) / 1e9, precision=precision,
        runs=runs, block_elems=F * blkC,
        library=lambda a: torch.einsum("ij,jsc->isc", a["R"][0],
                                       fold(a["u"])))


def matvec_oracle(mapping: str, device=None, seed: int = 0, *,
                  E: int = E_FULL) -> float:
    """Mapping *mapping* at 3x, blkC 4096, against float64
    (``:337-346``)."""
    case = matvec_case(mapping, "3x", device, seed, E=E, blkC=4096)
    got = case.fn(case.arrays)[0]
    want = case.arrays["R"][0].double() @ case.arrays["u"].double()
    return oracle_error(f"{mapping} 3x (3xTF32)", got, want)


def div_case(precision: str, device=None, seed: int = 0, *,
             E: int = E_FULL, blkC: int = 0):
    """The div on folded storage with per-run slices (``:191``): R (3, 35,
    35), J (3, 8, C), u (35, 8, C)."""
    device = default_device(device, caller="fold_probe2.div_case")
    rng = np.random.default_rng(seed)
    arrays = {"R": draw(rng, (3, ND, ND), device),
              "J": draw(rng, (3, E), device),
              "u": draw(rng, (ND, E), device)}

    def rows(a):
        return [ApplyRow(u=a["u"], J=a["J"])]
    tag = "3x" if precision == "3x" else "  "
    return apply_case(
        f"div slices {tag} blk{blkC or ' default'}", rows, arrays,
        gbytes=E * (ND + 3 + ND) * 4 / 1e9, precision=precision,
        block_elems=F * blkC, family="P-div",
        library=lambda a: torch.einsum("rij,jsc,rsc->isc", a["R"],
                                       fold(a["u"]), fold(a["J"])))


def cases(device=None, seed: int = 0, *, cpu: bool = False,
          first_block_only: bool = False):
    device = default_device(device, caller="fold_probe2.cases")
    E = E_CPU if cpu else E_FULL
    first = 1 if first_block_only else None
    for blkC in (0, 2048, 4096)[:first]:
        for precision in PRECISIONS:
            for mapping in ("I", "III"):
                yield matvec_case(mapping, precision, device, seed, E=E,
                                  blkC=blkC)
    for mapping in ("I", "III"):
        yield lambda mapping=mapping: matvec_oracle(mapping, device, seed,
                                                    E=E)
    for blkC in (0, 2048)[:first]:
        for precision in PRECISIONS:
            yield div_case(precision, device, seed, E=E, blkC=blkC)


def main() -> None:
    cli(cases, "fold_probe2")


if __name__ == "__main__":
    main()

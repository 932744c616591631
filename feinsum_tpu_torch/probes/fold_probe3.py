"""Fold-8 mapping I at the production precision
(``scripts/tpu_fold_probe3.py`` on the H100):

    python -m feinsum_tpu_torch.probes.fold_probe3 [--cpu]

The TPU ran these at ``Precision.HIGHEST``; on the card that is f32
(``probe_apply_f32``).  E = 2**20:

* the matvec at nd 20 and 35: base, dof-major (35, E), blk 32768
  (``:95``); fold-I, folded storage with a block taking blkC = 4096
  elements from each of the 8 runs (``:109``); kron, ``(D kron I_8) @ u``
  over u viewed (8 nd, C), blkC 4096 (``:122``; R 160 x 160 or 280 x 280);
* the div ``Σ_s J_s * (R_s @ u)``, S = 3, nd 35: base, dof-major, blk
  16384 (``:158``); fold-I, blkC 2048 (``:183``), and fold-I against
  float64 (``:194-208``).

Each sweep starts with the kernel's default block (128 elements).
"""

from __future__ import annotations

import numpy as np
import torch

from . import (ApplyRow, E_CPU, E_FULL, F, apply_case, cli, draw, fold,
               kron_eye, oracle_error, default_device)

ND = 35
MATVEC_BLOCKS = {"base": 32768, "fold-I": 8 * 4096, "kron": 4096}


def matvec_case(variant: str, nd: int, device=None, seed: int = 0, *,
                E: int = E_FULL, block: int = 0):
    """The matvec at *nd*: ``"base"`` (``:95``), ``"fold-I"`` (``:109``)
    or ``"kron"`` (``:122``), *block* elements (of E, or of C for kron) per
    thread block."""
    device = default_device(device, caller="fold_probe3.matvec_case")
    rng = np.random.default_rng(seed)
    D = draw(rng, (nd, nd), device)
    u = draw(rng, (nd, E), device)
    gbytes = E * nd * 2 * 4 / 1e9
    label = f"mv{nd} {variant} HIGHEST (f32) blk {block or 'default'}"
    if variant == "kron":
        arrays = {"R": kron_eye(D)[None], "u": u}

        def rows(a):
            return [ApplyRow(u=fold(a["u"]).reshape(nd * F, E // F))]
        return apply_case(
            label, rows, arrays, gbytes=gbytes, block_elems=block,
            family="P-kron",
            library=lambda a: torch.einsum("ij,jc->ic", a["R"][0],
                                           rows(a)[0].u))
    arrays = {"R": D[None], "u": u}
    return apply_case(
        label, lambda a: [ApplyRow(u=a["u"])], arrays, gbytes=gbytes,
        runs=F if variant == "fold-I" else 1, block_elems=block,
        library=lambda a: torch.einsum("ij,je->ie", a["R"][0], a["u"]))


def div_case(folded: bool, device=None, seed: int = 0, *, E: int = E_FULL,
             block: int = 0):
    """The div at nd 35: base (``:158``) or fold-I (``:183``, a block
    takes block / 8 elements of each run)."""
    device = default_device(device, caller="fold_probe3.div_case")
    rng = np.random.default_rng(seed)
    arrays = {"R": draw(rng, (3, ND, ND), device),
              "J": draw(rng, (3, E), device),
              "u": draw(rng, (ND, E), device)}
    name = "div fold-I" if folded else "div base"
    return apply_case(
        f"{name} HIGHEST (f32) blk {block or 'default'}",
        lambda a: [ApplyRow(u=a["u"], J=a["J"])], arrays,
        gbytes=E * (ND + 3 + ND) * 4 / 1e9, runs=F if folded else 1,
        block_elems=block, family="P-div",
        library=lambda a: torch.einsum("sij,je,se->ie", a["R"], a["u"],
                                       a["J"]))


def div_oracle(device=None, seed: int = 0, *, E: int = E_FULL) -> float:
    """The fold-I div (blkC 2048) against float64 (``:194-208``)."""
    case = div_case(True, device, seed, E=E, block=F * 2048)
    got = case.fn(case.arrays)[0]
    R, J, u = (case.arrays[k].double() for k in ("R", "J", "u"))
    want = torch.einsum("sij,je,se->ie", R, u, J)
    return oracle_error("div fold-I (f32)", got, want)


def cases(device=None, seed: int = 0, *, cpu: bool = False,
          first_block_only: bool = False):
    device = default_device(device, caller="fold_probe3.cases")
    E = E_CPU if cpu else E_FULL
    first = 1 if first_block_only else None
    for nd in (20, ND):
        for variant, tpu_block in MATVEC_BLOCKS.items():
            for block in (0, tpu_block)[:first]:
                yield matvec_case(variant, nd, device, seed, E=E,
                                  block=block)
    for folded, tpu_block in ((False, 16384), (True, F * 2048)):
        for block in (0, tpu_block)[:first]:
            yield div_case(folded, device, seed, E=E, block=block)
    yield lambda: div_oracle(device, seed, E=E)


def main() -> None:
    cli(cases, "fold_probe3")


if __name__ == "__main__":
    main()

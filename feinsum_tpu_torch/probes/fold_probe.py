"""The fold-8 storage on the card (``scripts/tpu_fold_probe.py`` on the
H100):

    python -m feinsum_tpu_torch.probes.fold_probe [--cpu]

Dof-major (nd, E) stored as (nd, 8, E / 8): on the TPU the fold fills the
sublane tile exactly (no 35 -> 40 padding); on the card it is a view of the
same bytes (e = s * C + c, C = E / 8), so only the thread tiling can differ.
E = 2**20, nd = 35:

* A copy (35, E), blocks (35, 32768) (``:84``), and B copy (35, 8, C),
  blocks (35, 8, 4096) (``:96``), on ``probe_stream_f32``: the same 35 x
  32768 floats per thread block;
* C matvec ``D @ u`` dof-major (``:117``, blk 32768) on ``probe_apply_f32``;
* D/E the kron matvec ``(D kron I_8) @ u`` over u viewed (280, C)
  (``:162``): R = 280 x 280, blkC 2048 and 4096 elements of C per block, in
  f32 (D) and at ``bf16_3x`` (E: the script's manual bf16 split; here
  3xTF32 on ``probe_apply_3xtf32``);
* the 3x relative error against float64 (``:176-186``, blkC 4096).

Each sweep starts with the kernel's default block (128 elements).
"""

from __future__ import annotations

import numpy as np
import torch

from . import (ApplyRow, E_CPU, E_FULL, F, apply_case, cli, draw, fold,
               kron_eye, oracle_error, default_device, stream_case)

ND = 35


def copy_case(folded: bool, device=None, seed: int = 0, *, E: int = E_FULL,
              block: int = 0):
    """A (dof-major, ``:84``) or B (folded, ``:96``) copy ``y = a * b``
    with *block* long-axis elements per thread block."""
    device = default_device(device, caller="fold_probe.copy_case")
    rng = np.random.default_rng(seed)
    arrays = {"a": draw(rng, (ND, E), device), "b": draw(rng, (ND, E),
                                                         device)}
    if folded:
        def ops(a):
            return [fold(a["a"]), fold(a["b"])]
        label = "B copy (35,8,E/8)"
    else:
        def ops(a):
            return [a["a"], a["b"]]
        label = "A copy (35,E)"
    return stream_case(f"{label} blk {block or 'default'}", ops, arrays,
                       gbytes=3 * E * ND * 4 / 1e9, block_elems=ND * block,
                       library=lambda a: torch.mul(*ops(a)))


def matvec_case(device=None, seed: int = 0, *, E: int = E_FULL,
                block: int = 0):
    """C: the dof-major matvec (``:117``)."""
    device = default_device(device, caller="fold_probe.matvec_case")
    rng = np.random.default_rng(seed)
    arrays = {"R": draw(rng, (ND, ND), device)[None],
              "u": draw(rng, (ND, E), device)}
    return apply_case(
        f"C matvec (35,E) blk {block or 'default'}",
        lambda a: [ApplyRow(u=a["u"])], arrays,
        gbytes=(E * ND * 2 * 4 + ND * ND * 4) / 1e9, block_elems=block,
        library=lambda a: torch.einsum("ij,je->ie", a["R"][0], a["u"]))


def kron_case(precision: str, device=None, seed: int = 0, *,
              E: int = E_FULL, block: int = 0, nd: int = ND):
    """D (f32) / E (3x): ``(D kron I_8) @ u`` on u folded (nd, 8, C)
    viewed (8 nd, C) (``:162``), *block* elements of C per thread block."""
    device = default_device(device, caller="fold_probe.kron_case")
    rng = np.random.default_rng(seed)
    D = draw(rng, (nd, nd), device)
    arrays = {"R": kron_eye(D)[None], "u": draw(rng, (nd, E), device)}

    def rows(a):
        return [ApplyRow(u=fold(a["u"]).reshape(nd * F, E // F))]
    tag = "E matvec fold 3x" if precision == "3x" else "D matvec fold"
    return apply_case(
        f"{tag} blkC {block or 'default'}", rows, arrays,
        gbytes=(E * nd * 2 * 4 + nd * nd * 4) / 1e9, precision=precision,
        block_elems=block, family="P-kron",
        library=lambda a: torch.einsum("ij,jc->ic", a["R"][0],
                                       rows(a)[0].u))


def kron_oracle(device=None, seed: int = 0, *, E: int = E_FULL) -> float:
    """The 3x kron matvec (blkC 4096) against float64 (``:176-186``)."""
    case = kron_case("3x", device, seed, E=E, block=4096)
    got = case.fn(case.arrays)[0]
    u = case.arrays["u"].double()
    want = torch.einsum("ij,jc->ic", case.arrays["R"][0].double(),
                        fold(u).reshape(ND * F, E // F))
    return oracle_error("fold matvec 3x (3xTF32)", got, want)


def cases(device=None, seed: int = 0, *, cpu: bool = False,
          first_block_only: bool = False):
    device = default_device(device, caller="fold_probe.cases")
    E = E_CPU if cpu else E_FULL
    first = 1 if first_block_only else None
    for folded, tpu_block in ((False, 32768), (True, 8 * 4096)):
        for block in (0, tpu_block)[:first]:
            yield copy_case(folded, device, seed, E=E, block=block)
    for block in (0, 32768)[:first]:
        yield matvec_case(device, seed, E=E, block=block)
    for block in (0, 2048, 4096)[:first]:
        for precision in ("f32", "3x"):
            yield kron_case(precision, device, seed, E=E, block=block)
    yield lambda: kron_oracle(device, seed, E=E)


def main() -> None:
    cli(cases, "fold_probe")


if __name__ == "__main__":
    main()

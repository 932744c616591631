"""``step_block_f32``'s time on the rows of ``chip_smoke.py`` phase 19, at
E = 1M, in both stored layouts (dof-major and the einsum's own) and under
both of the kernel's thread mappings, on one NVIDIA card:

    python -m feinsum_tpu_torch.tools.step_block_mappings

For each row and layout it prints the time of the mapping the wrapper picks
(``kernels.step_block_mode``), of the element-fastest and of the
entry-fastest mapping forced in this process, and each one's largest error
against ``step_block_plain`` over max|plain|.
"""

from __future__ import annotations

from unittest import mock

import torch

from ..codegen.program import generate_program, get_index_lengths
from ..einsum import SizeParam
from ..make_einsum import array, batched_einsum, einsum
from ..measure import apply_layouts, timeit_cuda
from ..ops import kernels
from ..ops.cuda_emitter import plan_cuda_launch
from ..tuning.impls._common import fused_pallas_program
from . import LONG_DIM_LENGTH, card_line

BLOCK_LONG = 512    # elements per thread block of the rows' programs


def step_block_rows() -> list:
    """``(name, einsum, hoist)`` of the rows no row family takes: sum
    factorization on Q4 hexahedra (the optimal path's three steps, the
    trivial one step, and b = 2: two fields under one operator), the
    contraction-free ``ej,e->ej`` and the resident reduction ``ej,j->`` at
    ndof 35, and the Gram matrix at ndof 120 (p = 7 tetrahedra)."""
    def a(name, shape):
        return array(name, shape, "float32")
    mats = [a(n, (5, 5)) for n in ("Ax", "Ay", "Az")]

    def field(name):
        return a(name, ("E", 5, 5, 5))
    sumfact = einsum("ai,bj,ck,eabc->eijk", *mats, field("u"))
    return [
        ("sumfact_q4", sumfact, True),
        ("sumfact_q4_one_step", sumfact, False),
        ("sumfact_q4_b2", batched_einsum(
            "ai,bj,ck,eabc->eijk", [[*mats, field("u")],
                                    [*mats, field("v")]]), True),
        ("broadcast_ndof35", einsum("ej,e->ej", a("A", ("E", 35)),
                                    a("w", ("E",))), False),
        ("resident_reduce_ndof35", einsum("ej,j->", a("A", ("E", 35)),
                                          a("w", (35,))), False),
        ("gram_ndof120", einsum("ei,ej->ij", a("u", ("E", 120)),
                                a("v", ("E", 120))), False)]


def demo_einsum():
    """The demo space's einsum at its width, ``ij,ejk->eik`` at ndof 35."""
    return einsum("ij,ejk->eik", array("A", (35, 35), "float32"),
                  array("B", ("E", 35, 35), "float32"))


def programs(e, hoist: bool) -> dict:
    """The row's ``fused_pallas_program`` in each stored layout."""
    return {layout: fused_pallas_program(
        generate_program(e), block_long=BLOCK_LONG, hoist=hoist,
        dofmajor=layout == "dof-major", parallel_grid=False)
        for layout in ("dof-major", "logical")}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    rows = [("demo_ndof35", demo_einsum(), False)] + step_block_rows()
    for name, e, hoist in rows:
        for layout, program in programs(e, hoist).items():
            plan = plan_cuda_launch(program, get_index_lengths(
                e, LONG_DIM_LENGTH))
            gen = torch.Generator(device=dev).manual_seed(0)
            logical = {n: torch.rand(tuple(
                LONG_DIM_LENGTH if isinstance(d, SizeParam) else d
                for d in shape), generator=gen, device=dev)
                for n, shape in e.arg_to_shape.items()}
            arrays = apply_layouts(program, logical)
            operands = plan.operands(arrays)
            want = plan.plain(operands)
            cols = []
            for label, forced in (("picked", None), ("element-fastest", True),
                                  ("entry-fastest", False)):
                with mock.patch.object(
                        kernels, "step_block_mode",
                        kernels.step_block_mode if forced is None
                        else (lambda *_, f=forced: f)):
                    got = plan.run(operands)
                    err = max(float((g - w).abs().max() / w.abs().max())
                              for g, w in zip(got, want))
                    ms = timeit_cuda(lambda a: plan.run(plan.operands(a)),
                                     arrays)
                cols.append(f"{label} {ms:.4f} ms (err {err:.1e})")
            print(f"[mappings] {name} {layout} E={LONG_DIM_LENGTH}: "
                  + ", ".join(cols), flush=True)
            del logical, arrays, operands, want, got
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

"""
Transform space of the contraction-free (bandwidth-bound) rows over one
long axis: the suite's copy row ``ij,ij->ij`` and 1-D products such as
``e,e->e``.

The file name and parameters are those of ``feinsum_tpu``'s space, so its
facts bind here.  On the card:

* ``flatten`` is K3's route (``ew_flat_f32``, ``block_long`` elements per
  thread block); it is searched on 1-D rows, where the reference's K3 takes
  it, and pinned off elsewhere (the reference raises there at build);
* ``log2_block``/``blkc128`` set ``block_long``, which only the flatten
  route reads: searched on 1-D rows, pinned elsewhere;
* ``dofmajor`` is searched where it changes a layout (the copy row);
* ``parallel_grid`` (pinned 1) sets ``dimension_semantics``; ``vmem_idx``
  (pinned 2) is accepted and ignored; ``fold`` (pinned 0) raises at 1.
"""

from __future__ import annotations

from feinsum_tpu_torch.ops.layouts import dofmajor_layouts
from feinsum_tpu_torch.tuning import BoolParameter, IntParameter, \
    transform_param
from feinsum_tpu_torch.tuning.impls._common import fused_pallas_program, \
    resolve_block


def _flat(e) -> bool:
    """Whether K3 takes the einsum: 1-D operands that all carry the
    output's subscript, no contraction."""
    out = tuple(e.out_idx_set)
    return (len(out) == 1 and not e.sum_indices
            and all(tuple(s) == out for s in e.in_idx_sets))


def _gate(cond):
    return BoolParameter() if cond else IntParameter(0, 0)


@transform_param("log2_block", lambda e: (
    IntParameter(8, 18) if _flat(e) else IntParameter(9, 9)))
@transform_param("blkc128", lambda e: IntParameter(0, 32 if _flat(e) else 0))
@transform_param("dofmajor", lambda e: _gate(
    dofmajor_layouts(e) != ((), None)))
@transform_param("fold", lambda e: IntParameter(0, 0))
@transform_param("flatten", lambda e: _gate(_flat(e)))
@transform_param("parallel_grid", lambda e: IntParameter(1, 1))
@transform_param("vmem_idx", lambda e: IntParameter(2, 2))
def transform(program, log2_block, blkc128=0, *, dofmajor, flatten,
              parallel_grid, fold=False, vmem_idx=None):
    return fused_pallas_program(
        program, block_long=resolve_block(log2_block, blkc128), hoist=False,
        parallel_grid=parallel_grid, dofmajor=dofmajor, fold=fold,
        flatten=bool(flatten), vmem_idx=vmem_idx)

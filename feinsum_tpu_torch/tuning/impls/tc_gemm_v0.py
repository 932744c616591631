"""
TC-as-GEMM transform space for dense 2-operand tensor contractions: the
contraction is rewritten into the 2D program ``ej,ij->ei`` (e = the
flattened M letters of the streamed lhs, i = the flattened N letters of the
resident rhs, j = the flattened contracted letters), with the operands and
the output stored GEMM-natural 2D (``descriptor.pre_layouts`` and
``pre_out_layout``, the host-side storage contracts) and the M length fixed
by ``bind_lengths``.

The file name and parameters are those of ``feinsum_tpu``'s space, so its
facts bind here.  On the port:

* ``backend_pallas=False``: one ``torch.einsum`` of the 2D program (a
  cuBLAS matrix product in full fp32 on the card);
* ``backend_pallas=True``: the fused DG kernel ``dg_rows_f32`` (the
  matvec row: the resident (N, K) factor staged in shared memory, the M
  axis over thread blocks of ``2 ** log2_block`` or ``1024 * blkc128``
  rows, ``dofmajor`` layouts).  A resident factor larger than a Hopper
  block's shared memory raises :class:`InvalidParameterError`.
* ``swap`` exchanges the lhs and rhs relative to CANONICAL operand
  positions (the archive's params are tuned on the canonical einsum; replay
  applies the transform to the user's program).
* ``precision_idx`` indexes ``("highest", "bf16_3x", "default")``:
  ``bf16_3x`` runs the fused route on ``dg_rows_3xtf32`` and the plain
  route's product in three full-fp32 passes over the TF32 split;
  ``default`` on the fused route raises (a duplicate of ``highest``), as
  in the reference.
* ``vmem_idx`` chose the TPU's VMEM cap: accepted and ignored (no
  ``vmem_limit_bytes``).  ``fold=True`` (the TPU's fold-8 storage) raises.
"""

from __future__ import annotations

from feinsum_tpu_torch.diagnostics import InvalidParameterError
from feinsum_tpu_torch.tuning import BoolParameter, IntParameter, \
    transform_param

_PRECISIONS = ("highest", "bf16_3x", "default")


def _gemm_split(e, swap):
    """(lhs_arg, rhs_arg, lhs_idx, rhs_idx, M_idx, N_idx, K_idx) for a pure
    (no batch index) 2-operand contraction, the operand order optionally
    swapped relative to the canonical positions.  Raises
    :class:`InvalidParameterError` when the einsum is not of this shape."""
    from feinsum_tpu_torch.canonicalization import \
        canonical_operand_positions
    from feinsum_tpu_torch.einsum import SizeParam

    if e.n != 2 or e.b != 1:
        raise InvalidParameterError(
            "tc_gemm_v0 expects a 2-operand single-row contraction")
    if any(isinstance(ln, SizeParam)
           for ln in e.index_to_dim_length.values()):
        raise InvalidParameterError(
            "tc_gemm_v0 expects a dense (fully concrete) contraction")
    lhs_pos, rhs_pos = canonical_operand_positions(e)
    if swap:
        lhs_pos, rhs_pos = rhs_pos, lhs_pos
    lhs, rhs = e.args[0][lhs_pos], e.args[0][rhs_pos]
    lhs_idx, rhs_idx = e.in_idx_sets[lhs_pos], e.in_idx_sets[rhs_pos]
    out_set = set(e.out_idx_set)
    k_idx = [ix for ix in lhs_idx if ix not in out_set]
    if not k_idx:
        raise InvalidParameterError("tc_gemm_v0: no contracted index")
    if set(k_idx) - set(rhs_idx):
        raise InvalidParameterError(
            "tc_gemm_v0: contracted index missing from the other operand")
    m_idx = [ix for ix in lhs_idx if ix in out_set]
    n_idx = [ix for ix in rhs_idx if ix in out_set]
    if set(m_idx) & set(n_idx):
        raise InvalidParameterError(
            "tc_gemm_v0: batch indices (shared free axes) are not a GEMM")
    if set(m_idx) | set(n_idx) != out_set:
        raise InvalidParameterError("tc_gemm_v0: output index unaccounted")
    if [ix for ix in rhs_idx if ix not in out_set and ix not in k_idx]:
        raise InvalidParameterError(
            "tc_gemm_v0: rhs has a privately-contracted index")
    return lhs, rhs, lhs_idx, rhs_idx, m_idx, n_idx, k_idx


@transform_param("log2_block", lambda e: IntParameter(8, 16))
@transform_param("blkc128", lambda e: IntParameter(0, 32))
@transform_param("backend_pallas", lambda e: BoolParameter())
@transform_param("precision_idx",
                 lambda e: IntParameter(0, len(_PRECISIONS) - 1))
@transform_param("swap", lambda e: BoolParameter())
@transform_param("dofmajor", lambda e: BoolParameter())
@transform_param("fold", lambda e: BoolParameter())
@transform_param("vmem_idx", lambda e: IntParameter(0, 2))
def transform(program, log2_block, blkc128=0, *, backend_pallas,
              precision_idx, swap, dofmajor=False, fold=False, vmem_idx=2):
    import numpy as np

    from feinsum_tpu_torch.codegen.program import generate_program
    from feinsum_tpu_torch.make_einsum import array, einsum
    from feinsum_tpu_torch.tuning.impls._common import (
        fp32_precision,
        fused_pallas_program,
        resolve_block,
    )

    del vmem_idx     # a TPU VMEM cap; see the module docstring
    e = program.einsum
    lhs, rhs, lhs_idx, rhs_idx, m_idx, n_idx, k_idx = _gemm_split(e, swap)
    lengths = {ix: int(ln) for ix, ln in e.index_to_dim_length.items()}
    m_len = int(np.prod([lengths[ix] for ix in m_idx], dtype=np.int64))
    n_len = int(np.prod([lengths[ix] for ix in n_idx], dtype=np.int64))
    k_len = int(np.prod([lengths[ix] for ix in k_idx], dtype=np.int64))

    # the rewritten 2D program "ej,ij->ei": e = M (streamed, its SizeParam
    # bound to m_len by bind_lengths), i = N, j = K; the operand names carry
    # over so the measurement plumbing feeds the same (2D-stored) arrays
    e2d = einsum("ej,ij->ei",
                 array(lhs.name, ("E_tc", k_len), lhs.dtype.name),
                 array(rhs.name, (n_len, k_len), rhs.dtype.name))
    p2 = generate_program(e2d)

    # host-side storage contracts (nested = groups of source axes)
    pre_layouts = (
        (lhs.name, (tuple(lhs_idx.index(ix) for ix in m_idx),
                    tuple(lhs_idx.index(ix) for ix in k_idx))),
        (rhs.name, (tuple(rhs_idx.index(ix) for ix in n_idx),
                    tuple(rhs_idx.index(ix) for ix in k_idx))),
    )
    pre_out = (tuple(e.out_idx_set.index(ix) for ix in m_idx),
               tuple(e.out_idx_set.index(ix) for ix in n_idx))

    precision = _PRECISIONS[precision_idx]
    if backend_pallas:
        p2 = fused_pallas_program(
            p2, block_long=resolve_block(log2_block, blkc128), hoist=False,
            parallel_grid=True, dofmajor=dofmajor, fold=fold,
            precision_3x=(precision == "bf16_3x"))
        if precision == "default":
            raise InvalidParameterError(
                "pallas route has no 1-pass mode (duplicate of highest)")
    else:
        if dofmajor or fold:
            raise InvalidParameterError(
                "dofmajor/fold are pallas-route knobs (xla duplicates)")
        p2 = p2.with_descriptor(backend="xla",
                                precision=fp32_precision(precision))
    return p2.with_descriptor(
        pre_layouts=pre_layouts, pre_out_layout=pre_out,
        bind_lengths=(("e", m_len),))

"""
Transform space of the mass-matrix family ``e,ij,ej->ei``, the per-element
matvec ``ej,ij->ei`` and the rows with no ``i`` output axis, vecmat
``ej,j->e`` and rowsum ``ej->e`` (``row_reduce_f32``).

The space is the shared DG definition
(:func:`~feinsum_tpu_torch.tuning.impls._common.make_dg_space`), which says
what each knob does on the card.  The file name is ``feinsum_tpu``'s, so an
archived fact's ``transform_id`` binds here.
"""

from __future__ import annotations

from feinsum_tpu_torch.tuning.impls._common import make_dg_space

transform = make_dg_space()

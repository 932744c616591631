"""
Transform space of the DG divergence family ``es,sij,ej->ei`` (batched, b = 3,
or single-row).  ``rowcat`` and ``split_rows`` gate on for the batched
rows.

The space is the shared DG definition
(:func:`~feinsum_tpu_torch.tuning.impls._common.make_dg_space`), which says
what each knob does on the card.  The file name is ``feinsum_tpu``'s, so an
archived fact's ``transform_id`` binds here.
"""

from __future__ import annotations

from feinsum_tpu_torch.tuning.impls._common import make_dg_space

transform = make_dg_space()

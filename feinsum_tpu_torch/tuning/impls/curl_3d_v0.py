"""
Transform space of the 3-D curl rows ``e,rij,ej->ei`` (b = 3), where
``prereduce`` gates on: ``R = Σ_r D`` is hoisted, evaluated once per call
and shared by the three rows, and each row becomes a mass-shaped
``dg_rows_f32`` launch with S = 1 instead of 3.

The space is the shared DG definition
(:func:`~feinsum_tpu_torch.tuning.impls._common.make_dg_space`), which says
what each knob does on the card.  The file name is ``feinsum_tpu``'s, so an
archived fact's ``transform_id`` binds here.
"""

from __future__ import annotations

from feinsum_tpu_torch.tuning.impls._common import make_dg_space

transform = make_dg_space()

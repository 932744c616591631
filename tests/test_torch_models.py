"""The port's workload models (``feinsum_tpu_torch.models``) held to the
JAX package's: the same random state for a seed, array for array, and one
wave step and one Maxwell step at ndof 10 (6 face dofs) from the
reference's state carried across, within 2e-5 of max|ref|.  The
reference's fused kernels run in Pallas interpret mode at one grid step
(``block_long`` >= E; ROADMAP fault F3); the port's run their plain
versions at several thread blocks.  Also the face-restriction row
``fji,ei->fej``: it plans onto ``dg_rows_f32`` as a matvec over the merged
(f, j), and any other stored order of those letters raises."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import feinsum_tpu_torch as ft
from feinsum_tpu.models import MaxwellOperator3D as RefMaxwell
from feinsum_tpu.models import WaveOperator3D as RefWave
from feinsum_tpu.models import make_maxwell_state as ref_maxwell_state
from feinsum_tpu.models import make_wave_state as ref_wave_state
from feinsum_tpu_torch.codegen.program import get_index_lengths
from feinsum_tpu_torch.models import state_from_reference
from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch

E = 256
NDOF, NFDOF = 10, 6
RTOL = 2e-5


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _close(got, want):
    got = got.numpy().astype(np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def test_states_equal_the_reference():
    for ours, ref in (
            (ft.make_wave_state(E, ndof=NDOF, nfacedof=NFDOF, seed=4,
                                device="cpu"),
             ref_wave_state(E, ndof=NDOF, nfacedof=NFDOF, seed=4)),
            (ft.make_maxwell_state(E, ndof=NDOF, seed=4, device="cpu"),
             ref_maxwell_state(E, ndof=NDOF, seed=4))):
        for d_ours, d_ref in zip(ours, ref):
            assert d_ours.keys() == d_ref.keys()
            for k in d_ref:
                np.testing.assert_array_equal(d_ours[k].numpy(),
                                              np.asarray(d_ref[k]))


def test_wave_step_matches_reference():
    ref_op = RefWave(ndof=NDOF, nfacedof=NFDOF, block_long=E)
    state, geom = ref_wave_state(E, ndof=NDOF, nfacedof=NFDOF, seed=1)
    want = _np(ref_op.make_step(E)(state, geom))
    op = ft.WaveOperator3D(ndof=NDOF, nfacedof=NFDOF, block_long=64)
    st, gm = state_from_reference(_np(state), _np(geom), device="cpu")
    got = op.make_step(E)(st, gm)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])
    # the module's forward is one step
    for k, v in op(st, gm).items():
        torch.testing.assert_close(v, got[k])
    assert op.layouts() == {n: tuple(p) for n, p in ref_op.layouts().items()}


def test_maxwell_step_matches_reference():
    ref_op = RefMaxwell(ndof=NDOF, block_long=E)
    state, geom = ref_maxwell_state(E, ndof=NDOF, seed=2)
    want = _np(ref_op.make_step(E, dt=1e-3)(state, geom))
    op = ft.MaxwellOperator3D(ndof=NDOF, block_long=64)
    st, gm = state_from_reference(_np(state), _np(geom), device="cpu")
    got = op.make_step(E, dt=1e-3)(st, gm)
    for k in want:
        _close(got[k], want[k])


def test_model_kernels():
    """Every wave program and the Maxwell curl plan onto ``dg_rows_f32``;
    the restriction row merges (f, j) into the kernel's i."""
    op = ft.WaveOperator3D(ndof=NDOF, nfacedof=NFDOF)
    for name, program in op.programs.items():
        plan = plan_cuda_launch(program, get_index_lengths(program.einsum,
                                                           E))
        assert plan.kernel == "dg_rows_f32", name
    restrict = op.programs["restrict"]
    plan = plan_cuda_launch(restrict, get_index_lengths(restrict.einsum, E))
    st, gm = ft.make_wave_state(E, ndof=NDOF, nfacedof=NFDOF, device="cpu")
    (row,) = plan.operands({"R": gm["Rface"], "u": st["u"]})
    assert tuple(row.R.shape) == (1, 4 * NFDOF, NDOF)
    assert row.R.data_ptr() == gm["Rface"].data_ptr()        # a view
    (out,) = plan.run([row])
    torch.testing.assert_close(out, torch.einsum(
        "fji,ie->fje", gm["Rface"], st["u"]))
    mx = ft.MaxwellOperator3D(ndof=NDOF)
    assert plan_cuda_launch(mx.program, get_index_lengths(
        mx.program.einsum, E)).kernel == "dg_rows_f32"


@pytest.mark.parametrize("r_perm, out_perm", [
    ((1, 0, 2), (0, 2, 1)),      # R stored (j, f, i): the order differs
    ((0, 1, 2), (0, 1, 2)),      # output stored (f, e, j): not adjacent
    ((0, 2, 1), (0, 2, 1)),      # R stored (f, i, j): j splits (f, j)
])
def test_restriction_rows_refuse_other_orders(r_perm, out_perm):
    e = ft.einsum("fji,ei->fej", ft.array("R", (4, NFDOF, NDOF), "float32"),
                  ft.array("u", ("E", NDOF), "float32"))
    program = ft.generate_program(e).with_descriptor(
        backend="pallas", arg_layouts=(("R", r_perm), ("u", (1, 0))),
        out_layout=out_perm)
    with pytest.raises(ft.InvalidParameterError, match="restriction rows"):
        plan_cuda_launch(program, get_index_lengths(e, E))


def test_models_take_no_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.make_wave_state(E, ndof=NDOF, nfacedof=NFDOF)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.make_maxwell_state(E, ndof=NDOF)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_reference({}, {})

"""The port's workload models (``feinsum_tpu_torch.models``) held to the
JAX package's: the same random state for a seed, array for array, and one
wave step and one Maxwell step at ndof 10 (6 face dofs) from the
reference's state carried across, within 2e-5 of max|ref|.  The
reference's fused kernels run in Pallas interpret mode at one grid step
(``block_long`` >= E; ROADMAP fault F3); the port's run their plain
versions at several thread blocks.  The models take their default block
length from ``suite.BLOCK_LONG`` and bind an archived fact without its
storage knobs (``fold``, ``preblock``), its precision carried over (the
reference's own tests of both); a lane-pack fact fails the reference's
step and is refused by the port's model.  Also the face-restriction row
``fji,ei->fej``: it plans onto ``dg_rows_f32`` as a matvec over the merged
(f, j), and any other stored order of those letters raises.

At float64 both models take pair storage by default (every einsum on
``dd_rows``, none on the plain route; the float32 plans unchanged): a step
is held to the reference's float64 run at one grid step (``jax_enable_x64``
for that run alone, the inputs drawn as numpy float64 arrays, so that
nothing is downcast on the way: ROADMAP fault F4) within 1e-12 of max|ref|,
and the wave step to the benchmark's plain float64 reference
(``benchmark_torch/configs/wave3d_p4_f64.py``) within its limit.

The spectral-element wave operator on hexahedra (``HexWaveOperator3D``),
which the JAX package lacks, is held to the benchmark's plain reference
(``benchmark_torch/configs/hexwave3d_q4.py``), and that reference to the
kron-expanded dense operator, computed here apart; its element operator is
skew-symmetric, and every program it plans runs on ``step_block_f32``.
SeisSol's elastic ADER-DG element (``AderElasticOperator3D``), which the
JAX package lacks too, is held to the benchmark's plain reference
(``benchmark_torch/configs/seissol_elastic_o5.py``) on both routes, and a
step without its last derivative has to fail that check; its viscoelastic
element (``AderViscoelasticOperator3D``) to the plain reference in the
27-quantity form (``benchmark_torch/configs/seissol_viscoelastic_o5.py``),
which the faults of the mathematics it plants have to fail; and the plans
of the elastic and hexahedral tables, which share its planner, are
pinned."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import feinsum_tpu_torch as ft
from feinsum_tpu.models import MaxwellOperator3D as RefMaxwell
from feinsum_tpu.models import WaveOperator3D as RefWave
from feinsum_tpu.models import make_maxwell_state as ref_maxwell_state
from feinsum_tpu.models import make_wave_state as ref_wave_state
from feinsum_tpu_torch.codegen.program import (
    generate_program_with_opt_einsum_schedule,
    get_index_lengths,
)
from feinsum_tpu_torch.models import state_from_reference
from feinsum_tpu_torch.ops import kernels
from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
from feinsum_tpu_torch.ops.dd_emitter import plan_dd_launch
from feinsum_tpu_torch.ops.layouts import dofmajor_layouts

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


def test_models_default_to_the_h100_block_length():
    """Without an archive the models run the reference's default schedule
    at ``suite.BLOCK_LONG`` (512) elements per thread block, not the TPU's
    4096."""
    from feinsum_tpu_torch import suite as S
    op = ft.WaveOperator3D(ndof=NDOF, nfacedof=NFDOF)
    assert {p.descriptor.block_long for p in op.programs.values()} == {
        S.BLOCK_LONG} == {512}
    assert ft.MaxwellOperator3D(ndof=NDOF).program.descriptor.block_long \
        == 512


def test_wave_model_strips_storage_knobs_from_db_schedules(tmp_path):
    """An archived fact may set ``fold`` and ``preblock`` (how its schedule
    stores the arrays on the TPU); the models keep plain dof-major storage,
    so the fact is bound with them off, as the reference resets
    ``fold_long`` and ``preblock_args``; block size and precision carry
    over.  A step matches the reference's."""
    from feinsum_tpu_torch import sql_utils
    db = str(tmp_path / "db.sqlite")
    probe = ft.WaveOperator3D(ndof=NDOF, nfacedof=NFDOF, use_pallas=False)
    sql_utils.record_facts(
        probe.grad_einsum, transform_id="dg_grad_v0.py",
        transform_params={"log2_block": 10, "hoist": True,
                          "parallel_grid": True, "dofmajor": True,
                          "fold": True, "preblock": True,
                          "precision_3x": True},
        runtime_in_sec=1e-4, device="cpu", db_path=db,
        long_dim_length=2048)
    op = ft.WaveOperator3D(ndof=NDOF, nfacedof=NFDOF, db_path=db,
                           device="cpu")
    desc = op.programs["grad"].descriptor
    assert desc.fold_long == 1 and desc.preblock_args == ()
    assert desc.precision == "bf16_3x"    # the dot's precision carries over
    assert desc.block_long == 1024
    assert op.programs["div"].descriptor.precision == "default"
    grad = op.programs["grad"]
    assert plan_cuda_launch(grad, get_index_lengths(
        grad.einsum, E)).kernel == "dg_rows_3xtf32"
    ref_op = RefWave(ndof=NDOF, nfacedof=NFDOF, block_long=E)
    state, geom = ref_wave_state(E, ndof=NDOF, nfacedof=NFDOF, seed=5)
    want = _np(ref_op.make_step(E)(state, geom))
    st, gm = state_from_reference(_np(state), _np(geom), device="cpu")
    got = op.make_step(E)(st, gm)
    for k in want:
        _close(got[k], want[k])


def test_maxwell_model_uses_db_schedule(tmp_path):
    """The reference's Maxwell case: a ``dg_div_v0.py`` fact with
    ``precision_3x`` (and ``fold`` and ``preblock``, which the model drops)
    bound to the curl einsum; the curl runs on ``dg_rows_3xtf32`` at the
    fact's block and a step matches the reference's."""
    from feinsum_tpu_torch import sql_utils
    db = str(tmp_path / "db.sqlite")
    probe = ft.MaxwellOperator3D(ndof=NDOF, use_pallas=False)
    sql_utils.record_facts(
        probe.curl_einsum, transform_id="dg_div_v0.py",
        transform_params={"log2_block": 9, "hoist": True,
                          "parallel_grid": True, "dofmajor": True,
                          "fold": True, "preblock": True,
                          "precision_3x": True},
        runtime_in_sec=1e-4, device="cpu", db_path=db,
        long_dim_length=1024)
    op = ft.MaxwellOperator3D(ndof=NDOF, db_path=db, device="cpu")
    desc = op.program.descriptor
    assert desc.block_long == 512 and desc.precision == "bf16_3x"
    assert desc.fold_long == 1 and desc.preblock_args == ()
    assert plan_cuda_launch(op.program, get_index_lengths(
        op.program.einsum, E)).kernel == "dg_rows_3xtf32"
    ref_op = RefMaxwell(ndof=NDOF, block_long=E)
    state, geom = ref_maxwell_state(E, ndof=NDOF, seed=6)
    want = _np(ref_op.make_step(E, dt=1e-3)(state, geom))
    st, gm = state_from_reference(_np(state), _np(geom), device="cpu")
    got = op.make_step(E, dt=1e-3)(st, gm)
    for k in want:
        _close(got[k], want[k])


def test_models_take_no_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.make_wave_state(E, ndof=NDOF, nfacedof=NFDOF)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.make_maxwell_state(E, ndof=NDOF)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_reference({}, {})


@pytest.mark.parametrize("which", ["div", "grad", "face", "curl"])
def test_models_refuse_lane_pack_facts(tmp_path, which):
    """A lane-pack fact (``lane_pack_g`` 3, g = 8) for a model's einsum:
    the reference's model binds it, keeps its packed operands, and its step
    fails on the shapes of the dof-major state; the port's model refuses
    the fact when it is built, naming ``lane_pack_g``."""
    from feinsum_tpu import sql_utils as ref_sql
    from feinsum_tpu_torch import sql_utils
    params = {"log2_block": 9, "hoist": False, "parallel_grid": True,
              "dofmajor": True, "lane_pack_g": 3}
    space = {"div": "dg_div_v0.py", "grad": "dg_grad_v0.py",
             "face": "face_mass_v0.py", "curl": "dg_div_v0.py"}[which]
    if which == "curl":
        ref_e = RefMaxwell(ndof=NDOF, use_pallas=False).curl_einsum
        e = ft.MaxwellOperator3D(ndof=NDOF, use_pallas=False).curl_einsum
    else:
        ref_e = getattr(RefWave(ndof=NDOF, nfacedof=NFDOF, use_pallas=False),
                        f"{which}_einsum")
        e = getattr(ft.WaveOperator3D(ndof=NDOF, nfacedof=NFDOF,
                                      use_pallas=False), f"{which}_einsum")
    ref_db, db = str(tmp_path / "ref.sqlite"), str(tmp_path / "db.sqlite")
    ref_sql.record_facts(ref_e, transform_id=space, transform_params=params,
                         runtime_in_sec=1e-4, device="cpu", db_path=ref_db,
                         long_dim_length=2048)
    sql_utils.record_facts(e, transform_id=space, transform_params=params,
                           runtime_in_sec=1e-4, device="cpu", db_path=db,
                           long_dim_length=2048)
    if which == "curl":
        ref_op = RefMaxwell(ndof=NDOF, db_path=ref_db, device="cpu",
                            block_long=E)
        assert ref_op._program.descriptor.lane_pack == 8
        state, geom = ref_maxwell_state(E, ndof=NDOF, seed=6)
    else:
        ref_op = RefWave(ndof=NDOF, nfacedof=NFDOF, db_path=ref_db,
                         device="cpu", block_long=E)
        assert ref_op._programs[which].descriptor.lane_pack == 8
        state, geom = ref_wave_state(E, ndof=NDOF, nfacedof=NFDOF, seed=5)
    with pytest.raises((TypeError, ValueError)):
        ref_op.make_step(E)(state, geom)
    with pytest.raises(ft.InvalidParameterError, match="lane_pack_g"):
        if which == "curl":
            ft.MaxwellOperator3D(ndof=NDOF, db_path=db, device="cpu")
        else:
            ft.WaveOperator3D(ndof=NDOF, nfacedof=NFDOF, db_path=db,
                              device="cpu")


# {{{ float64: pair storage on dd_rows

F64_RTOL = 1e-12
MODELS_F64 = {
    "wave": (ft.WaveOperator3D, RefWave, ft.make_wave_state,
             {"ndof": NDOF, "nfacedof": NFDOF}),
    "maxwell": (ft.MaxwellOperator3D, RefMaxwell, ft.make_maxwell_state,
                {"ndof": NDOF})}


def _programs(op) -> dict:
    return op.programs if hasattr(op, "programs") else {"curl": op.program}


@pytest.mark.parametrize("model", sorted(MODELS_F64))
def test_fp64_models_match_the_reference(model):
    """P1: the models at float64 with their default plan, against the
    reference's float64 run at one grid step, within 1e-12 of max|ref|."""
    cls, ref_cls, make_state, widths = MODELS_F64[model]
    st, gm = make_state(E, dtype="float64", seed=7, device="cpu", **widths)
    with jax.enable_x64(True):
        ref_op = ref_cls(dtype="float64", block_long=E, **widths)
        want = ref_op.make_step(E)({k: t.numpy() for k, t in st.items()},
                                   {k: t.numpy() for k, t in gm.items()})
        want = _np(want)
    op = cls(dtype="float64", block_long=64, **widths)
    got = op.make_step(E)(st, gm)
    assert got.keys() == want.keys()
    for k in want:
        assert want[k].dtype == np.float64 and got[k].dtype == torch.float64
        scale = float(np.max(np.abs(want[k])))
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=F64_RTOL,
                                   atol=F64_RTOL * scale)


@pytest.mark.parametrize("model", sorted(MODELS_F64))
def test_fp64_plans_take_dd_rows_and_no_plain_route(model, monkeypatch):
    """At float64 every einsum of the model is planned onto ``dd_rows`` on
    pair storage; a step calls the kernel's plain version (CPU tensors)
    once per einsum and never the plain per-step route."""
    cls, _, make_state, widths = MODELS_F64[model]
    op = cls(dtype="float64", **widths)
    programs = _programs(op)
    for name, program in programs.items():
        desc = program.descriptor
        assert desc.dd_pairs and desc.backend == "pallas", name
        assert plan_dd_launch(program, get_index_lengths(
            program.einsum, E)).kernel == "dd_rows", name
    calls = []
    plain = kernels.dd_rows_plain

    def counted(rows):
        calls.append(len(rows))
        return plain(rows)

    def refuse(*args):
        raise AssertionError("a float64 einsum took the plain route")
    monkeypatch.setattr(kernels, "dd_rows_plain", counted)
    monkeypatch.setattr(ft.codegen.program, "_xla_row", refuse)
    st, gm = make_state(E, dtype="float64", seed=3, device="cpu", **widths)
    out = op.make_step(E)(st, gm)
    assert all(t.dtype == torch.float64 for t in out.values())
    # wave: grad, div (3 rows), restrict, face; Maxwell: the curl twice
    assert calls == ([1, 3, 1, 1] if model == "wave" else [6, 6])


@pytest.mark.parametrize("model", sorted(MODELS_F64))
def test_f32_plans_are_unchanged(model):
    """At float32 the default programs are the reference's default schedule
    on the fused kernels, exactly as before pair storage: no ``dd_pairs``,
    every einsum on ``dg_rows_f32``."""
    cls, _, _, widths = MODELS_F64[model]
    op = cls(**widths)
    for name, program in _programs(op).items():
        layouts, out_perm = dofmajor_layouts(program.einsum)
        want = generate_program_with_opt_einsum_schedule(
            program.einsum).with_descriptor(
                backend="pallas", block_long=512,
                dimension_semantics="parallel", arg_layouts=layouts,
                out_layout=out_perm)
        assert program == want, name
        assert plan_cuda_launch(program, get_index_lengths(
            program.einsum, E)).kernel == "dg_rows_f32", name


def test_a_model_refuses_programs_that_mix_pair_storage():
    from feinsum_tpu_torch.models.common import on_pairs
    op = ft.WaveOperator3D(ndof=NDOF, nfacedof=NFDOF, dtype="float64")
    mixed = dict(op.programs, grad=op.programs["grad"].with_descriptor(
        dd_pairs=False))
    assert on_pairs(op.programs.values()) is True
    with pytest.raises(ft.InvalidParameterError, match="dd_pairs"):
        on_pairs(mixed.values())


def test_fp64_wave_step_matches_the_benchmark_reference():
    """The float64 wave step at ndof 35 (E = 96) against the benchmark's
    plain float64 reference: the widest gap between the new state and the
    old plus the reference's increment, over the largest increment, within
    the configuration's ``increment_gap_limit``."""
    bench = Path(__file__).resolve().parents[1] / "benchmark_torch"
    spec = importlib.util.spec_from_file_location(
        "reference_wave3d_p4_f64", bench / "configs" / "wave3d_p4_f64.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    cfg = json.loads((bench / "configs" / "wave3d_p4_f64.json").read_text())
    n = 96
    state, geom = ref.make_inputs(
        cfg, n, torch.Generator().manual_seed(2 ** 33 + 3), "cpu")
    op = ft.WaveOperator3D(**cfg["operator"]["kwargs"])
    new = op.make_step(n, dt=cfg["dt"])(state, geom)
    inc = ref.increments(cfg, state, geom)
    for k in ("u", "v"):
        gap = float((new[k] - (state[k] + inc[k])).abs().max()
                    / inc[k].abs().max())
        assert gap < cfg["check"]["increment_gap_limit"], (k, gap)

# }}}


# {{{ the spectral-element wave operator on hexahedra

BENCH = Path(__file__).resolve().parents[1] / "benchmark_torch"
HEX_CONFIG = "hexwave3d_q4"


def _bench_reference(config):
    """``(cfg, reference module)`` of a benchmark configuration."""
    import sys
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))       # the reference imports plain
    spec = importlib.util.spec_from_file_location(
        f"reference_{config}", BENCH / "configs" / f"{config}.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    return cfg, ref


def _hex_reference():
    """``(cfg, reference module)`` of the benchmark's hexahedral cell."""
    return _bench_reference(HEX_CONFIG)


def _hex_inputs(n_elements, seed, dtype=torch.float32):
    cfg, ref = _hex_reference()
    state, geom = ref.make_inputs(cfg, n_elements,
                                  torch.Generator().manual_seed(seed), "cpu")
    return (cfg, ref, {k: t.to(dtype) for k, t in state.items()},
            {k: t.to(dtype) for k, t in geom.items()})


@pytest.mark.parametrize("n_elements", [37, 64])
def test_hex_step_matches_the_benchmark_reference(n_elements):
    """A float32 step of the model with its default plan (CPU tensors: the
    kernels' plain versions) against the plain reference's increments: the
    widest gap between the new state and the old plus the increment, over
    the largest increment, within the configuration's limit."""
    cfg, ref, state, geom = _hex_inputs(n_elements, 2 ** 33 + n_elements)
    op = ft.HexWaveOperator3D(**cfg["operator"]["kwargs"])
    new = op.make_step(n_elements, dt=cfg["dt"])(state, geom)
    inc = ref.increments(cfg, state, geom)
    for k in ("u", "v"):
        assert new[k].shape == state[k].shape and new[k].is_contiguous()
        # beyond the half unit in the last place that storing costs, as the
        # benchmark's check (run.gap_terms) counts it
        half_ulp = 0.5 * (torch.nextafter(new[k].abs(), torch.tensor(
            float("inf"))) - new[k].abs()).double()
        excess = ((new[k].double() - (state[k].double() + inc[k].double()))
                  .abs() - half_ulp).clamp_min(0)
        gap = float(excess.max() / inc[k].abs().max())
        assert gap < cfg["check"]["increment_gap_limit"], (k, gap)
    # the module's forward is one step
    for k, t in op(state, geom, dt=cfg["dt"]).items():
        torch.testing.assert_close(t, new[k], rtol=0, atol=0)


def test_hex_reference_equals_the_kron_expanded_operator():
    """The reference's increments in float64 at E = 3 against the dense
    operator built here apart: D_1 = D (x) I (x) I, D_2 = I (x) D (x) I,
    D_3 = I (x) I (x) D over the 125 nodes (i slowest), g_x = sum_r G_xr
    D_r u and d = sum_r D_r (sum_x G_xr v_x)."""
    E3 = 3
    cfg, ref, state, geom = _hex_inputs(E3, 11, torch.float64)
    n = cfg["n"]
    D, eye = geom["D"], torch.eye(n, dtype=torch.float64)
    K = [torch.kron(torch.kron(D, eye), eye),
         torch.kron(torch.kron(eye, D), eye),
         torch.kron(torch.kron(eye, eye), D)]
    U = state["u"].reshape(n ** 3, E3)
    V = state["v"].reshape(3, n ** 3, E3)
    G = geom["G"].reshape(3, 3, n ** 3, E3)
    grad = torch.stack([sum(G[x, r] * (K[r] @ U) for r in range(3))
                        for x in range(3)])
    div = sum(K[r] @ sum(G[x, r] * V[x] for x in range(3))
              for r in range(3))
    inc = ref.increments(cfg, state, geom)
    dt = cfg["dt"]
    torch.testing.assert_close(inc["u"].reshape(n ** 3, E3), dt * div,
                               rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(inc["v"].reshape(3, n ** 3, E3), dt * grad,
                               rtol=1e-12, atol=1e-15)


def test_hex_operator_is_skew_symmetric():
    """With D skew (the configuration's draw) div = -grad^T, so <u, d> +
    <v, g> vanishes: in float64 through the reference, and in float32
    through the model's step, each against the sum of the terms'
    magnitudes."""
    cfg, ref, state, geom = _hex_inputs(40, 5, torch.float64)
    torch.testing.assert_close(geom["D"], -geom["D"].T, rtol=0, atol=0)

    def balance(inc_u, inc_v):
        terms = torch.cat([(state["u"] * inc_u).flatten(),
                           (state["v"] * inc_v).flatten()])
        return float(terms.sum().abs() / terms.abs().sum())
    inc = ref.increments(cfg, state, geom)
    assert balance(inc["u"], inc["v"]) < 1e-13
    s32 = {k: t.float() for k, t in state.items()}
    g32 = {k: t.float() for k, t in geom.items()}
    dt = 0.25       # an increment well above the state's rounding
    new = ft.HexWaveOperator3D().make_step(40, dt=dt)(s32, g32)
    got = [(new[k].double() - s32[k].double()) for k in ("u", "v")]
    assert balance(*got) < 1e-5
    assert balance(inc["u"], inc["v"] * 0) > 1e-3   # each half alone is not


def test_hex_programs_run_on_step_block():
    """Every program of the model runs on the fused route, each planned
    onto ``step_block_f32`` with every step dense and no step hoisted: no
    plain route, and no operand wider than D's stack (3, n, n) besides the
    streamed ones (no kron-expanded derivative)."""
    from feinsum_tpu_torch.ops.cuda_emitter import hoist_resident_steps
    from feinsum_tpu_torch.ops.step_block import plan_step_block
    op = ft.HexWaveOperator3D()
    n_elements = 4099
    for name, program in op.programs.items():
        assert program.descriptor.backend == "pallas", name
        long_len = 125 * n_elements if "metric" in name else n_elements
        lengths = get_index_lengths(program.einsum, long_len)
        assert plan_cuda_launch(program, lengths).kernel \
            == "step_block_f32", name
        kernel_program, hoisted = hoist_resident_steps(program)
        assert hoisted == (), name
        table = plan_step_block(kernel_program, lengths)
        assert table.mode == "dense", name
        for row in program.einsum.args:
            for arg in row:
                if all(isinstance(d, int) for d in arg.shape):
                    assert np.prod(arg.shape) <= 3 * 5 * 5, (name, arg)
    assert list(op.programs) == ["grad_axes", "grad_metric", "div_metric",
                                 "div_1", "div_2", "div_3"]


def test_hex_leaves_the_tet_plans_as_they_were():
    """Building and stepping the hexahedral model changes no float32 plan
    of the tetrahedral models: each program equals the one built before
    it, on ``dg_rows_f32``."""
    before = {cls: _programs(cls(**widths))
              for cls, _, _, widths in MODELS_F64.values()}
    cfg, _, state, geom = _hex_inputs(8, 3)
    ft.HexWaveOperator3D().make_step(8)(state, geom)
    for cls, _, _, widths in MODELS_F64.values():
        after = _programs(cls(**widths))
        assert after == before[cls]
        for name, program in after.items():
            assert plan_cuda_launch(program, get_index_lengths(
                program.einsum, E)).kernel == "dg_rows_f32", name


def test_hex_axis_factors_are_made_once_per_d(monkeypatch):
    """The grad's factors (D, I, I), (I, D, I), (I, I, D) are made on the
    first step and again only for another D or one written in place."""
    from feinsum_tpu_torch.models import hexwave
    made, axis_factors = [], hexwave.axis_factors

    def counted(D):
        made.append(D)
        return axis_factors(D)
    monkeypatch.setattr(hexwave, "axis_factors", counted)
    cfg, ref, state, geom = _hex_inputs(5, 9)
    step = ft.HexWaveOperator3D().make_step(5)
    step(state, geom)
    step(state, geom)
    assert len(made) == 1
    A, B, C = axis_factors(geom["D"])
    eye = torch.eye(5)
    for r, factor in enumerate((A, B, C)):
        for s in range(3):
            assert torch.equal(factor[s], geom["D"] if s == r else eye)
    geom["D"].mul_(1.0)                        # written in place
    step(state, geom)
    step(state, dict(geom, D=geom["D"].clone()))   # another tensor
    assert len(made) == 3


def test_hex_model_refuses_float64_and_draws_its_state():
    """The model runs float32 alone and takes no precision: a ``dtype``
    is refused; its state is drawn in its layouts, the same for a seed."""
    with pytest.raises(TypeError, match="dtype"):
        ft.HexWaveOperator3D(dtype="float64")
    state, geom = ft.make_hexwave_state(6, seed=2, device="cpu")
    assert {k: tuple(t.shape) for k, t in {**state, **geom}.items()} == {
        "u": (5, 5, 5, 6), "v": (3, 5, 5, 5, 6), "G": (3, 3, 5, 5, 5, 6),
        "D": (5, 5)}
    again, _ = ft.make_hexwave_state(6, seed=2, device="cpu")
    assert all(torch.equal(state[k], again[k]) for k in state)

# }}}


# {{{ SeisSol's elastic ADER-DG element

ADER_CONFIG = "seissol_elastic_o5"
# the degree boxes at order 5: modal functions of degree <= 4, 3, 2, 1, 0
ADER_BOXES = (35, 20, 10, 4, 1)


def _ader_inputs(n_elements, seed):
    cfg, ref = _bench_reference(ADER_CONFIG)
    state, geom = ref.make_inputs(cfg, n_elements,
                                  torch.Generator().manual_seed(seed), "cpu")
    return cfg, ref, state, geom


def _gap(new, old, inc):
    """The benchmark's ``increment_gap`` (``run.gap_terms``): the widest
    excess of the new state over the old plus the increment beyond the
    half unit in the last place that storing costs, over the largest
    increment."""
    half_ulp = 0.5 * (torch.nextafter(new.abs(), torch.tensor(
        float("inf"))) - new.abs()).double()
    excess = ((new.double() - (old.double() + inc.double())).abs()
              - half_ulp).clamp_min(0)
    return float(excess.max() / inc.abs().max())


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("n_elements", [37, 64])
def test_ader_step_matches_the_benchmark_reference(n_elements, use_pallas):
    """A float32 step of the model (its default plan, CPU tensors: the
    kernels' plain versions; and the plain per-step route) against the
    plain reference's increment, which follows the equations as written
    (unscaled derivatives, the time integral's weights applied), within
    the configuration's limit."""
    cfg, ref, state, geom = _ader_inputs(n_elements, 2 ** 33 + n_elements)
    op = ft.AderElasticOperator3D(use_pallas=use_pallas,
                                  **cfg["operator"]["kwargs"])
    new = op.make_step(n_elements, dt=cfg["dt"])(state, geom)
    assert set(new) == {"Q"}
    assert new["Q"].shape == state["Q"].shape and new["Q"].is_contiguous()
    inc = ref.increments(cfg, state, geom)["Q"]
    assert _gap(new["Q"], state["Q"], inc) \
        < cfg["check"]["increment_gap_limit"]
    # the module's forward is one step
    torch.testing.assert_close(op(state, geom, dt=cfg["dt"])["Q"], new["Q"],
                               rtol=0, atol=0)


@pytest.mark.parametrize("dropped", ["K3", "K2"])
def test_ader_check_tells_a_short_predictor(dropped):
    """A step whose last derivative (dQ4: K3 zeroed) or last two (K2
    zeroed) are left out reads above the configuration's limit, so the
    check tells a short predictor from the whole one."""
    n = 64
    cfg, ref, state, geom = _ader_inputs(n, 2 ** 33 + 7)
    inc = ref.increments(cfg, state, geom)["Q"]
    short = dict(geom, **{dropped: torch.zeros_like(geom[dropped])})
    new = ft.AderElasticOperator3D().make_step(n, dt=cfg["dt"])(state, short)
    assert _gap(new["Q"], state["Q"], inc) \
        > 10 * cfg["check"]["increment_gap_limit"]


def test_ader_einsums_keep_the_degree_boxes():
    """The six einsums in the degree boxes B = (35, 20, 10, 4, 1): the
    derivative d maps B_d functions to B_{d+1}, the volume term reads the
    first B_1 of I, the flux all B_0 through 15 face functions; each
    program runs on ``step_block_f32`` with every step dense and nothing
    hoisted."""
    from feinsum_tpu_torch.models import ader
    from feinsum_tpu_torch.ops.cuda_emitter import hoist_resident_steps
    from feinsum_tpu_torch.ops.step_block import plan_step_block
    assert ader.B == ADER_BOXES and ader.F == 15
    B = ADER_BOXES
    op = ft.AderElasticOperator3D()
    want = {**{f"derivative_{d}": {f"K{d}": (3, B[d + 1], B[d]),
                                   f"dQ{d}": (B[d], 9, "E"),
                                   "S": (3, 9, 9, "E")} for d in range(4)},
            "volume": {"Kv": (3, 35, 20), "I": (20, 9, "E"),
                       "S": (3, 9, 9, "E")},
            "flux": {"L": (4, 35, 15), "R": (4, 15, 35), "I": (35, 9, "E"),
                     "A": (4, 9, 9, "E")}}
    assert list(op.einsums) == list(want)
    n_elements = 4099
    for name, program in op.programs.items():
        shapes = {a.name: tuple(d if isinstance(d, int) else "E"
                                for d in a.shape)
                  for row in program.einsum.args for a in row}
        assert shapes == want[name], name
        assert program.descriptor.backend == "pallas", name
        lengths = get_index_lengths(program.einsum, n_elements)
        assert plan_cuda_launch(program, lengths).kernel \
            == "step_block_f32", name
        kernel_program, hoisted = hoist_resident_steps(program)
        assert hoisted == (), name
        assert plan_step_block(kernel_program, lengths).mode == "dense", name


def test_ader_model_draws_its_state_and_refuses_what_it_lacks():
    """``make_ader_state`` draws the same tensors for a seed, in the
    model's layouts; the model runs float32 alone."""
    state, geom = ft.make_ader_state(6, seed=2, device="cpu")
    assert {k: tuple(t.shape) for k, t in {**state, **geom}.items()} == {
        "Q": (35, 9, 6), "S": (3, 9, 9, 6), "A": (4, 9, 9, 6),
        "K0": (3, 20, 35), "K1": (3, 10, 20), "K2": (3, 4, 10),
        "K3": (3, 1, 4), "Kv": (3, 35, 20), "R": (4, 15, 35),
        "L": (4, 35, 15)}
    again = ft.make_ader_state(6, seed=2, device="cpu")
    other = ft.make_ader_state(6, seed=3, device="cpu")
    for k, t in {**state, **geom}.items():
        assert t.dtype == torch.float32
        assert torch.equal(t, {**again[0], **again[1]}[k])
        assert not torch.equal(t, {**other[0], **other[1]}[k])
    with pytest.raises(TypeError, match="dtype"):
        ft.AderElasticOperator3D(dtype="float64")


def test_ader_reference_matrices_are_scaled_once(monkeypatch):
    """The factors dt / (d + 2), dt and dt ride in K_d, Kv and L, each
    held in its program's stored layout with R: made on the first step,
    and not again for a step with the same geometry."""
    from feinsum_tpu_torch.models import ader
    cfg, ref, state, geom = _ader_inputs(8, 3)
    held, apply_layouts = [], ader.apply_layouts

    def counted(program, arrays):
        held.extend(arrays)
        return apply_layouts(program, arrays)
    monkeypatch.setattr(ader, "apply_layouts", counted)
    step = ft.AderElasticOperator3D().make_step(8, dt=cfg["dt"])
    first = step(state, geom)
    again = step(state, geom)
    assert sorted(held) == ["K0", "K1", "K2", "K3", "Kv", "L", "R"]
    torch.testing.assert_close(first["Q"], again["Q"], rtol=0, atol=0)

# }}}


# {{{ SeisSol's viscoelastic ADER-DG element

VISCO_CONFIG = "seissol_viscoelastic_o5"
# the executables of a step, in the order it calls them by kind
VISCO_EXECS = ([f"derivative_{d}" for d in range(4)]
               + [f"source_{d}" for d in range(5)]
               + [f"relax_{d}" for d in range(4)] + ["volume", "flux"])


def _visco_inputs(n_elements, seed):
    cfg, ref = _bench_reference(VISCO_CONFIG)
    state, geom = ref.make_inputs(cfg, n_elements,
                                  torch.Generator().manual_seed(seed), "cpu")
    return cfg, ref, state, geom


def _visco_gap(new, old, inc):
    """The benchmark's ``increment_gap`` over both fields."""
    return max(_gap(new[k], old[k], inc[k]) for k in ("Q", "Qane"))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("n_elements", [37, 64])
def test_visco_step_matches_the_27_quantity_reference(n_elements,
                                                      use_pallas):
    """A float32 step of the viscoelastic model (its default plan, CPU
    tensors: the kernels' plain versions; and the plain per-step route)
    against the plain reference's increments of Q and Qane, which the
    reference computes in Kaeser et al.'s 27-quantity form (unscaled
    derivatives, the time integral's weights applied), within the
    configuration's limit."""
    cfg, ref, state, geom = _visco_inputs(n_elements, 2 ** 33 + n_elements)
    op = ft.AderViscoelasticOperator3D(use_pallas=use_pallas,
                                       **cfg["operator"]["kwargs"])
    new = op.make_step(n_elements, dt=cfg["dt"])(state, geom)
    assert set(new) == {"Q", "Qane"}
    for k, t in new.items():
        assert t.shape == state[k].shape and t.is_contiguous(), k
    inc = ref.increments(cfg, state, geom)
    assert _visco_gap(new, state, inc) < cfg["check"]["increment_gap_limit"]
    again = op(state, geom, dt=cfg["dt"])
    for k in new:
        torch.testing.assert_close(again[k], new[k], rtol=0, atol=0)


@pytest.mark.parametrize("fault", ["degree_boxes", "source_zeroed",
                                   "relaxation_left_out"])
def test_visco_check_tells_the_faults_of_the_mathematics(fault):
    """Each fault of the mathematics that the reference can plant (the
    derivatives cut to the elastic element's degree boxes, Es zeroed, the
    relaxation left out) reads above 10 times the configuration's limit
    against the sound reference; the program itself with Es zeroed too."""
    n = 64
    cfg, ref, state, geom = _visco_inputs(n, 2 ** 33 + 11)
    limit = cfg["check"]["increment_gap_limit"]
    inc = ref.increments(cfg, state, geom)
    bad = ref.increments(cfg, state, geom, fault=fault)
    planted = {k: state[k] + bad[k] for k in state}
    assert _visco_gap(planted, state, inc) > 10 * limit
    if fault == "source_zeroed":
        zeroed = dict(geom, Es=torch.zeros_like(geom["Es"]))
        new = ft.AderViscoelasticOperator3D().make_step(
            n, dt=cfg["dt"])(state, zeroed)
        assert _visco_gap(new, state, inc) > 10 * limit


def test_visco_anelastic_state_stays_bounded():
    """64 chained steps from the benchmark's draw: Q and Qane stay finite
    and within a few times their first magnitudes (the anelastic state
    settles where its relaxation balances the strain rates that drive it,
    near 30)."""
    n = 32
    cfg, ref, state, geom = _visco_inputs(n, 2 ** 33 + 5)
    step = ft.AderViscoelasticOperator3D().make_step(n, dt=cfg["dt"])
    first = {k: float(t.abs().max()) for k, t in state.items()}
    for _ in range(64):
        state = step(state, geom)
    for k, t in state.items():
        assert bool(torch.isfinite(t).all()), k
    assert float(state["Q"].abs().max()) < 2 * first["Q"]
    assert float(state["Qane"].abs().max()) < 20 * first["Qane"]


def test_visco_einsums_run_on_step_block_f32():
    """The 15 executables, one program a kind of product shared by its
    executables: each planned onto ``step_block_f32`` with every step
    dense and nothing hoisted; the operands in the configuration's
    shapes; the model imports its constants from the elastic element's."""
    from feinsum_tpu_torch.models import ader, ader_visco
    from feinsum_tpu_torch.ops.cuda_emitter import hoist_resident_steps
    from feinsum_tpu_torch.ops.step_block import plan_step_block
    assert (ader_visco.ORDER, ader_visco.B, ader_visco.F, ader_visco.NQ,
            ader_visco.NFACES) == (ader.ORDER, ader.B, ader.F, ader.NQ,
                                   ader.NFACES)
    op = ft.AderViscoelasticOperator3D()
    assert list(op.programs) == VISCO_EXECS
    kinds = {name.rstrip("_0123456789") for name in VISCO_EXECS}
    assert len({id(p) for p in op.programs.values()}) == len(kinds) == 5
    want = {"derivative": {"Kt": (3, 20, 35), "dQ": (35, 9, "E"),
                           "S": (3, 9, 15, "E")},
            "source": {"dQane": (35, 6, 3, "E"), "Es": (6, 3, 9, "E")},
            "relax": {"dQane": (35, 6, 3, "E"), "w": (3, "E")},
            "volume": {"Kv": (3, 35, 20), "I": (20, 9, "E"),
                       "S": (3, 9, 15, "E")},
            "flux": {"L": (4, 35, 15), "R": (4, 15, 35), "I": (35, 9, "E"),
                     "A": (4, 9, 15, "E")}}
    n_elements = 4099
    for name, program in op.programs.items():
        shapes = {a.name: tuple(d if isinstance(d, int) else "E"
                                for d in a.shape)
                  for row in program.einsum.args for a in row}
        assert shapes == want[name.rstrip("_0123456789")], name
        lengths = get_index_lengths(program.einsum, n_elements)
        assert plan_cuda_launch(program, lengths).kernel \
            == "step_block_f32", name
        kernel_program, hoisted = hoist_resident_steps(program)
        assert hoisted == (), name
        assert plan_step_block(kernel_program, lengths).mode == "dense", name


def test_visco_model_draws_its_state():
    """``make_ader_visco_state`` draws the same tensors for a seed, in the
    model's layouts, w every element's relaxation frequencies (2 pi times
    0.05, 0.5 and 5 Hz: FreqCentral 0.5, FreqRatio 100)."""
    state, geom = ft.make_ader_visco_state(6, seed=2, device="cpu")
    assert {k: tuple(t.shape) for k, t in {**state, **geom}.items()} == {
        "Q": (35, 9, 6), "Qane": (35, 6, 3, 6), "S": (3, 9, 15, 6),
        "A": (4, 9, 15, 6), "Es": (6, 3, 9, 6), "Kt": (3, 20, 35),
        "Kv": (3, 35, 20), "R": (4, 15, 35), "L": (4, 35, 15),
        "w": (3, 6)}
    again = ft.make_ader_visco_state(6, seed=2, device="cpu")
    for k, t in {**state, **geom}.items():
        assert t.dtype == torch.float32
        assert torch.equal(t, {**again[0], **again[1]}[k])
    w = torch.tensor([2 * np.pi * f for f in (0.05, 0.5, 5.0)],
                     dtype=torch.float64)
    torch.testing.assert_close(geom["w"], w[:, None].expand(3, 6).float())
    cfg, ref = _bench_reference(VISCO_CONFIG)
    torch.testing.assert_close(torch.tensor(ref.frequencies(cfg),
                                            dtype=torch.float64), w)


# the plans of the elastic ADER element's six tables (E = 4M) and of the
# hexahedral model's four lanes tables (E = 2M) on step_block_f32's lanes
# path: (table mode, sub-tile, two buffers, threads, per step (X, W
# resident, tile, chain), shared memory floats)
ELASTIC_AND_HEX_PLANS = {
    "derivative_0": ("dense", 32, False, 256, (
        (0, True, (3, 12), 1), (1, False, (9, 4), 2)), 20128),
    "derivative_1": ("dense", 64, False, 256, (
        (0, True, (3, 12), 1), (1, False, (9, 4), 2)), 27904),
    "derivative_2": ("dense", 64, False, 256, (
        (0, True, (3, 12), 1), (1, False, (9, 4), 2)), 21504),
    "derivative_3": ("dense", 96, True, 256, (
        (0, True, (9, 4), 1), (1, False, (9, 1), 2)), 53632),
    "volume": ("dense", 32, False, 512, (
        (1, False, (4, 9), 0), (0, True, (2, 12), 0)), 33152),
    "flux": ("dense", 32, False, 512, (
        (0, True, (9, 4), 1), (1, False, (9, 4), 2),
        (0, True, (2, 12), 0)), 42336),
    "grad_axes": ("dense", 32, False, 256, (
        (0, True, (2, 16), 0), (0, True, (5, 8), 0),
        (0, True, (5, 8), 0)), 24544),
    "div_1": ("dense", 128, False, 256, ((0, True, (5, 4), 0),), 16128),
    "div_2": ("dense", 128, False, 256, ((0, True, (5, 4), 0),), 16128),
    "div_3": ("dense", 128, False, 256, ((0, True, (5, 4), 0),), 16128)}


@pytest.mark.parametrize("name", sorted(ELASTIC_AND_HEX_PLANS))
def test_the_elastic_and_hexahedral_plans_stay_as_they_were(name):
    """The viscoelastic element's tables share the planner with the
    elastic element's and the hexahedral model's: each of those plans as
    it did before it came (the lanes plan of each table at its cell's
    size)."""
    from feinsum_tpu_torch.ops.cuda_emitter import hoist_resident_steps
    from feinsum_tpu_torch.ops.step_block import plan_lanes, plan_step_block
    if name in ("grad_axes", "div_1", "div_2", "div_3"):
        op, n_elements = ft.HexWaveOperator3D(), 2_000_000
    else:
        op, n_elements = ft.AderElasticOperator3D(device="cpu"), 4_000_000
    program = op.programs[name]
    table = plan_step_block(hoist_resident_steps(program)[0],
                            get_index_lengths(program.einsum, n_elements))
    plan = plan_lanes(table)
    assert (table.mode, plan.te, plan.double, plan.threads,
            tuple((ls.x, ls.wres, ls.tile, ls.chain) for ls in plan.steps),
            plan.smem_floats) == ELASTIC_AND_HEX_PLANS[name]

# }}}

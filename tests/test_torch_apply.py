"""The port's consumer flow (``feinsum_tpu_torch.compile_fn_with_archive``)
held to the JAX package's on the functions of ``tests/test_apply.py``:
each is written once in ``jnp`` and once in ``torch``, both are compiled
against the archive and called on the same numpy-seeded inputs, and the
outputs agree within 2e-5 of max|ref| (2e-4 where the reference's own test
allows it).  The plans agree too: the same number, the same grouping of
instructions into batched einsums (b) and the same scales.

Where the reference reaches a Pallas kernel (an archive hit, read from a
copy of the shipped archive through ``FakeDevice("TPU v5 lite")`` in both
packages) it runs in interpret mode; the port runs its kernels' plain
versions, since the tensors lie on the CPU.  The port's own archive cases
(a planted corrupt row, relayout-aware scoring, the shootout, the consumer
rows tuned on the CPU) follow the reference's tests with the port's
spaces."""

from __future__ import annotations

import os
import shutil
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feinsum_tpu as fr
import feinsum_tpu_torch as ft
from feinsum_tpu_torch import apply as apply_mod
from feinsum_tpu_torch import measure, sql_utils
from feinsum_tpu_torch import suite as S
from feinsum_tpu_torch.codegen.program import get_index_lengths, \
    stored_lengths
from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch

SHIPPED = (Path(__file__).resolve().parents[1] / "feinsum_tpu" / "data"
           / "transform_archive_v1_tpu.sqlite")
TPU = "TPU v5 lite"


def _data(E=1024, ndof=8, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "J": rng.random((E, 3), np.float32),
        "D": rng.random((3, ndof, ndof), np.float32),
        "u": rng.random((E, ndof), np.float32),
        "L": rng.random((ndof, 4, 6), np.float32),
        "F": rng.random((4, E), np.float32),
        "flux": rng.random((4, E, 6), np.float32),
    }


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(arrays):
    return [torch.tensor(a) if np.ndim(a) == 0 else torch.from_numpy(
        np.ascontiguousarray(a)) for a in arrays]


def _close(got, ref, tol=2e-5):
    got = np.asarray(got.detach().cpu().numpy() if isinstance(
        got, torch.Tensor) else got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


def _plan_shape(plans):
    return [(e.b, tuple(i.scale for i in infos)) for infos, e, _ in plans]


def compile_both(jfn, tfn, arrays, call_arrays=None, tol=2e-5, **kw):
    """Compile *jfn* with the JAX package and *tfn* with the port on the
    same arrays, call both (on *call_arrays* if given) and compare the
    outputs and the plans; returns (reference fn, port fn)."""
    ref_kw = {k: (fr.FakeDevice(v.name) if k == "device" else v)
              for k, v in kw.items()}
    ref2 = fr.compile_fn_with_archive(jfn, _j(arrays), **ref_kw)
    ours2 = ft.compile_fn_with_archive(tfn, _t(arrays), **kw)
    call = call_arrays if call_arrays is not None else arrays
    got, want = ours2(*_t(call)), ref2(*_j(call))
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, tol)
    assert _plan_shape(ours2.plans) == _plan_shape(ref2.plans)
    return ref2, ours2


def _shipped_copy(tmp_path):
    db = str(tmp_path / "shipped.sqlite")
    shutil.copy(SHIPPED, db)
    return db


def test_sum_of_einsums_with_scales():
    d = _data()

    def j_rhs(J, D, u, L, F, flux):
        vol = jnp.einsum("es,sij,ej->ei", J, D, u)
        surf = jnp.einsum("ifj,fe,fej->ei", L, F, flux)
        return 2.0 * vol - surf

    def t_rhs(J, D, u, L, F, flux):
        vol = torch.einsum("es,sij,ej->ei", J, D, u)
        surf = torch.einsum("ifj,fe,fej->ei", L, F, flux)
        return 2.0 * vol - surf
    compile_both(j_rhs, t_rhs, [d[k] for k in ("J", "D", "u", "L", "F",
                                               "flux")])


def test_expression_operand_and_captured_const():
    d = _data()
    M = np.random.default_rng(1).random((8, 8), np.float32)
    jM, tM = jnp.asarray(M), torch.from_numpy(M)
    compile_both(
        lambda J, u: jnp.einsum("e,ej,ij->ei", 2.0 * J[:, 0] + 1.0, u, jM),
        lambda J, u: torch.einsum("e,ej,ij->ei", 2.0 * J[:, 0] + 1.0, u, tM),
        [d["J"], d["u"]])


def test_tuple_outputs_and_nonlinear_operand():
    d = _data()

    def jpair(J, D, u):
        a = jnp.einsum("es,sij,ej->ei", J, D, u)
        return a, -jnp.einsum("ei,ej->ij", jnp.exp(u), u)

    def tpair(J, D, u):
        a = torch.einsum("es,sij,ej->ei", J, D, u)
        return a, -torch.einsum("ei,ej->ij", torch.exp(u), u)
    compile_both(jpair, tpair, [d["J"], d["D"], d["u"]], tol=2e-4)


def test_archive_hit_replays_tuned_schedule(tmp_path):
    """Through the shipped archive's device both packages resolve the
    matvec to an archived fused schedule (``backend="pallas"``) and agree;
    the port's ladder passes over the facts whose knobs it refuses."""
    db = _shipped_copy(tmp_path)
    rng = np.random.default_rng(2)
    arrays = [rng.random((2048, 20), np.float32),
              rng.random((20, 20), np.float32)]
    ref2, ours2 = compile_both(
        lambda my_dofs, my_op: jnp.einsum("nq,dq->nd", my_dofs, my_op),
        lambda my_dofs, my_op: torch.einsum("nq,dq->nd", my_dofs, my_op),
        arrays, db_path=db, device=ft.FakeDevice(TPU), long_dim_length=500)
    assert ref2.plans[0][2].descriptor.backend == "pallas"
    assert ours2.plans[0][2].descriptor.backend == "pallas"


@pytest.mark.parametrize("form", ["mul", "div", "mixed"])
def test_traced_scalar_factors(form):
    d = _data()
    fns = {
        "mul": (lambda u, a, b: a * jnp.einsum("ej,ej->e", u, u),
                lambda u, a, b: a * torch.einsum("ej,ej->e", u, u)),
        "div": (lambda u, a, b: jnp.einsum("ej,ej->e", u, u) / a,
                lambda u, a, b: torch.einsum("ej,ej->e", u, u) / a),
        "mixed": (lambda u, a, b: b * jnp.einsum("ej,ej->e", u, u) / a,
                  lambda u, a, b: b * torch.einsum("ej,ej->e", u, u) / a),
    }
    jfn, tfn = fns[form]
    compile_both(jfn, tfn, [d["u"], np.float32(2.0), np.float32(3.0)],
                 call_arrays=[d["u"], np.float32(8.0), np.float32(5.0)])


def test_componentwise_div_groups_into_batched_archive_hit(tmp_path):
    """Three componentwise div einsums summed into one output group into
    one b = 3 plan that hits the shipped archive's batched-div class in
    both packages."""
    db = _shipped_copy(tmp_path)
    rng = np.random.default_rng(3)
    E = 512
    arrays = ([rng.random((E, 3), np.float32) for _ in range(3)]
              + [rng.random((3, 35, 35), np.float32)]
              + [rng.random((E, 35), np.float32) for _ in range(3)])

    def juser(Jx, Jy, Jz, R, ux, uy, uz):
        return (jnp.einsum("es,sij,ej->ei", Jx, R, ux)
                + jnp.einsum("es,sij,ej->ei", Jy, R, uy)
                - jnp.einsum("es,sij,ej->ei", Jz, R, uz))

    def tuser(Jx, Jy, Jz, R, ux, uy, uz):
        return (torch.einsum("es,sij,ej->ei", Jx, R, ux)
                + torch.einsum("es,sij,ej->ei", Jy, R, uy)
                - torch.einsum("es,sij,ej->ei", Jz, R, uz))
    ref2, ours2 = compile_both(juser, tuser, arrays, db_path=db,
                               device=ft.FakeDevice(TPU),
                               long_dim_length=500)
    ((infos, einsum, program),) = ours2.plans
    assert len(infos) == 3 and einsum.b == 3
    assert [i.scale for i in infos] == [1.0, 1.0, -1.0]
    assert program.descriptor.backend == "pallas"
    # the archive's champion, the reference's too, sets bf16_3x: the j-dot
    # runs on the 3xTF32 kernel
    ((_, _, ref_program),) = ref2.plans
    assert program.descriptor.precision == ref_program.descriptor.precision \
        == "bf16_3x"
    assert plan_cuda_launch(program, get_index_lengths(
        einsum, E * program.descriptor.rowcat)).kernel == "dg_rows_3xtf32"


def test_epilogues_match_reference():
    d = _data()
    u, D = d["u"], d["D"][0]
    cases = [
        (lambda u, D: jnp.tanh(jnp.einsum("ej,ij->ei", u, D)),
         lambda u, D: torch.tanh(torch.einsum("ej,ij->ei", u, D)), 1),
        (lambda u, D: jnp.tanh(jnp.einsum("ej,ij->ei", u, D)) + u,
         lambda u, D: torch.tanh(torch.einsum("ej,ij->ei", u, D)) + u, 1),
        (lambda u, D: jnp.max(jnp.abs(jnp.einsum("ej,ij->ei", u, D))),
         lambda u, D: torch.max(torch.abs(torch.einsum("ej,ij->ei", u, D))),
         1),
    ]
    for jfn, tfn, nplans in cases:
        _, ours2 = compile_both(jfn, tfn, [u, D], tol=2e-4)
        assert len(ours2.plans) == nplans

    def jlim(u, D):
        a = jnp.einsum("ej,ij->ei", u, D)
        return jnp.where(a > 0, a, 0.1 * a)

    def tlim(u, D):
        a = torch.einsum("ej,ij->ei", u, D)
        return torch.where(a > 0, a, 0.1 * a)
    compile_both(jlim, tlim, [u, D], tol=2e-4)


def test_epilogue_mixed_outputs_and_direct_slot():
    d = _data()

    def jmixed(u, D, dt):
        a = jnp.einsum("ej,ij->ei", u, D)
        b = jnp.einsum("ej,ij->ei", u, 2.0 * D)
        return a, jnp.exp(dt * (a - b))

    def tmixed(u, D, dt):
        a = torch.einsum("ej,ij->ei", u, D)
        b = torch.einsum("ej,ij->ei", u, 2.0 * D)
        return a, torch.exp(dt * (a - b))
    _, ours2 = compile_both(jmixed, tmixed,
                            [d["u"], d["D"][0], np.float32(0.1)],
                            call_arrays=[d["u"], d["D"][0],
                                         np.float32(0.25)], tol=2e-4)
    assert sum(len(i) for i, _e, _p in ours2.plans) == 3
    assert len(ours2.plans) == 1

    def jreuse(u, D):
        a = jnp.einsum("ej,ij->ei", u, D)
        return a, jnp.exp(a)

    def treuse(u, D):
        a = torch.einsum("ej,ij->ei", u, D)
        return a, torch.exp(a)
    _, ours2 = compile_both(jreuse, treuse, [d["u"], d["D"][0]], tol=2e-4)
    assert sum(len(i) for i, _e, _p in ours2.plans) == 1


def test_pure_non_einsum_fn_still_rejects():
    d = _data()
    with pytest.raises(ft.EinsumMatchError, match="outside the batched"):
        ft.compile_fn_with_archive(lambda x: torch.tanh(x), _t([d["u"]]))


def _corrupt_module(tmp_path) -> str:
    mod = tmp_path / "corrupt_v0.py"
    mod.write_text(
        "from dataclasses import replace\n"
        "from feinsum_tpu_torch.tuning import BoolParameter,"
        " transform_param\n"
        "\n"
        "@transform_param('corrupt', lambda e: BoolParameter())\n"
        "def transform(program, corrupt):\n"
        "    # the square operand's indices reversed: builds, miscomputes\n"
        "    sch = program.schedule\n"
        "    ins, out = sch.subscripts[0].split('->')\n"
        "    a, b = ins.split(',')\n"
        "    new = a + ',' + b[::-1] + '->' + out\n"
        "    return program.copy(schedule=replace(\n"
        "        sch, subscripts=(new,) + sch.subscripts[1:]))\n")
    return str(mod)


def _matvec20():
    return ft.einsum("ej,ij->ei", ft.array("u", ("E", 20), "float32"),
                     ft.array("D", (20, 20), "float32"))


def _matvec_args(seed):
    rng = np.random.default_rng(seed)
    return _t([rng.random((2048, 20), np.float32),
               rng.random((20, 20), np.float32)])


def _user(dofs, op):
    return torch.einsum("nq,dq->nd", dofs, op)


def test_default_spot_check_skips_corrupted_archive_row(tmp_path):
    db = str(tmp_path / "scratch.sqlite")
    sql_utils.record_facts(_matvec20(), transform_id=_corrupt_module(tmp_path),
                           transform_params={"corrupt": True},
                           runtime_in_sec=1e-9, device=ft.FakeDevice(TPU),
                           db_path=db, long_dim_length=2048)
    u, M = _matvec_args(3)
    bad = ft.compile_fn_with_archive(_user, [u, M], db_path=db,
                                     device=ft.FakeDevice(TPU),
                                     long_dim_length=500, spot_check=False)
    assert not np.allclose(bad(u, M).numpy(), _user(u, M).numpy(),
                           rtol=1e-3)
    good = ft.compile_fn_with_archive(_user, [u, M], db_path=db,
                                      device=ft.FakeDevice(TPU),
                                      long_dim_length=500)
    _close(good(u, M), _user(u, M).numpy())


def _lane_pack_champion(tmp_path):
    """An archive whose one matvec fact is the shipped archive's matvec
    champion, g = 4 (``lane_pack_g`` 2)."""
    db = str(tmp_path / "scratch.sqlite")
    params = {"log2_block": 10, "blkc128": 0, "dofmajor": True,
              "fold": False, "preblock": False, "precision_3x": False,
              "hoist": False, "jfold": False, "mfold": False,
              "prereduce": False, "lane_pack_g": 2, "parallel_grid": True,
              "vmem_idx": 2, "split_rows": False, "accum_f32": False,
              "host_hoist": True}
    sql_utils.record_facts(_matvec20(), transform_id="mass_v0.py",
                           transform_params=params, runtime_in_sec=1e-4,
                           device=ft.FakeDevice(TPU), db_path=db,
                           long_dim_length=2048)
    return db


def test_lane_pack_champion_falls_through_the_ladder(tmp_path):
    """An archived lane-pack champion at a length g does not divide (2046
    elements, g = 4) is passed over, as the reference passes over it: the
    plan falls to the plain program, whose output is the function's."""
    db = _lane_pack_champion(tmp_path)
    rng = np.random.default_rng(7)
    u, M = _t([rng.random((2046, 20), np.float32),
               rng.random((20, 20), np.float32)])
    fn2 = ft.compile_fn_with_archive(_user, [u, M], db_path=db,
                                     device=ft.FakeDevice(TPU),
                                     long_dim_length=500)
    assert fn2.plans[0][2].descriptor.backend == "xla"
    _close(fn2(u, M), _user(u, M).numpy())


def test_lane_pack_champion_is_served(tmp_path):
    """At a length g divides (2048 elements), the lane-pack champion is
    served on the fused route: the packed matvec over g·d = 80 on
    ``dg_rows_f32``, its output the function's."""
    db = _lane_pack_champion(tmp_path)
    u, M = _matvec_args(7)
    fn2 = ft.compile_fn_with_archive(_user, [u, M], db_path=db,
                                     device=ft.FakeDevice(TPU),
                                     long_dim_length=500)
    ((_, einsum, program),) = fn2.plans
    assert program.descriptor.backend == "pallas"
    assert program.descriptor.lane_pack == 4
    assert plan_cuda_launch(program, stored_lengths(program, get_index_lengths(
        program.einsum, 2048))).kernel == "dg_rows_f32"
    _close(fn2(u, M), _user(u, M).numpy())


@pytest.mark.parametrize("shootout", [False, True])
def test_ladder_passes_only_over_refusals(tmp_path, monkeypatch, shootout):
    """The ladder steps over an archived schedule the port refuses or the
    spot check rejects (the cases above), never over another error: a
    kernel that fails to build or launch propagates instead of the plain
    program being served."""
    db = str(tmp_path / "scratch.sqlite")
    e = _matvec20()
    sql_utils.record_facts(e, transform_id="mass_v0",
                           transform_params=S.space_point("mass_v0", e),
                           runtime_in_sec=1e-6, device=ft.FakeDevice(TPU),
                           db_path=db, long_dim_length=2048)
    u, M = _matvec_args(9)
    fn2 = ft.compile_fn_with_archive(_user, [u, M], db_path=db,
                                     device=ft.FakeDevice(TPU),
                                     long_dim_length=500, shootout=False)
    assert fn2.plans[0][2].descriptor.backend == "pallas"

    def launch_fails(*a, **kw):
        raise RuntimeError("dg_rows_f32 launch failed: CUDA error 700")
    monkeypatch.setattr(measure, "validate_batched_einsum_transform",
                        launch_fails)
    with pytest.raises(RuntimeError, match="launch failed"):
        ft.compile_fn_with_archive(_user, [u, M], db_path=db,
                                   device=ft.FakeDevice(TPU),
                                   long_dim_length=501, shootout=shootout)


def test_plan_cache_memoizes_and_invalidates(tmp_path):
    db = str(tmp_path / "memo.sqlite")
    shutil.copy(SHIPPED, db)
    d = _data()
    args = _t([d["J"], d["D"], d["u"]])

    def user(J, D, u):
        return torch.einsum("es,sij,ej->ei", J, D, u)
    fn_a = ft.compile_fn_with_archive(user, args, db_path=db)
    assert ft.compile_fn_with_archive(user, args, db_path=db) is fn_a
    assert ft.compile_fn_with_archive(user, args, db_path=db,
                                      long_dim_length=777) is not fn_a
    # other shapes are another plan
    args2 = _t([d["J"][:512], d["D"], d["u"][:512]])
    assert ft.compile_fn_with_archive(user, args2, db_path=db) is not fn_a
    t = time.time() + 2
    os.utime(db, (t, t))
    fn_d = ft.compile_fn_with_archive(user, args, db_path=db)
    assert fn_d is not fn_a
    _close(fn_d(*args), user(*args).numpy())

    big = torch.from_numpy(np.random.default_rng(2).random((1024, 64),
                                                           np.float32))

    def closure_fn(J, D, u):
        # a 256 KB constant in the graph: hashing it on every compile would
        # cost more than the memo saves, so there is no key
        out = torch.einsum("es,sij,ej->ei", J, D, u)
        return out + (out.sum() * big)[:, :8] * 0.0
    key = apply_mod._plan_cache_key(torch.fx.symbolic_trace(closure_fn), 100,
                                    None, db, None, False, True)
    assert key is None


def test_shared_expr_operand_across_plans_evaluates_once(monkeypatch):
    d = _data()

    def user(J, D, u):
        w = torch.tanh(J)
        vol = torch.einsum("es,sij,ej->ei", w, D, u)
        tot = torch.einsum("es->e", w)
        return vol, tot

    args = _t([d["J"], d["D"], d["u"]])
    fn2 = ft.compile_fn_with_archive(user, args)
    assert len(fn2.plans) == 2
    calls = []
    orig = apply_mod._backward_slice_eval

    def counting(*a, **kw):
        calls.append(a[2])
        return orig(*a, **kw)
    monkeypatch.setattr(apply_mod, "_backward_slice_eval", counting)
    got = fn2(*args)
    ref = user(*args)
    _close(got[0], ref[0].numpy())
    _close(got[1], ref[1].numpy())
    assert len(calls) == 1
    assert len([v for v in calls[0] if v.name.startswith("tanh")]) == 1


def _layout_module(tmp_path, name, param) -> str:
    mod = tmp_path / f"{name}.py"
    mod.write_text(
        "from feinsum_tpu_torch.codegen.descriptor import"
        " ScheduleDescriptor\n"
        "from feinsum_tpu_torch.tuning import BoolParameter, IntParameter,"
        " transform_param\n"
        "\n"
        f"@transform_param('{param}', lambda e: IntParameter(0, 64))\n"
        f"def transform(program, {param}):\n"
        "    e = program.einsum\n"
        f"    layouts = (((e.args[0][0].name, (1, 0)),) if {param} else ())\n"
        "    return program.copy(descriptor=ScheduleDescriptor(\n"
        "        backend='xla', arg_layouts=layouts))\n")
    return str(mod)


@pytest.mark.parametrize("n_transposing", [1, 8])
def test_plan_prefers_layout_free_row_when_relayout_dominates(
        tmp_path, n_transposing):
    """A faster-kernel row whose storage contract transposes the streamed
    operand per call loses to a slower layout-free row once the modeled
    relayout (the H100's permute-copy rate) dominates, however many
    transposing rows rank above it by rate."""
    mod = _layout_module(tmp_path, "lay_v0", "k")
    db = str(tmp_path / "scratch.sqlite")
    dev = ft.FakeDevice(TPU)
    for k in range(1, n_transposing + 1):
        sql_utils.record_facts(_matvec20(), transform_id=mod,
                               transform_params={"k": k},
                               runtime_in_sec=1e-6 * (1 + 0.1 * k),
                               device=dev, db_path=db, long_dim_length=2048)
    # the transpose of u (2048 x 20 float32) costs 1.02 us at the H100's
    # permute-copy rate, so 1.1 us + 1.02 us loses to 2 us
    sql_utils.record_facts(_matvec20(), transform_id=mod,
                           transform_params={"k": 0}, runtime_in_sec=2e-6,
                           device=dev, db_path=db, long_dim_length=2048)
    u, M = _matvec_args(5)
    fn2 = ft.compile_fn_with_archive(_user, [u, M], db_path=db, device=dev,
                                     long_dim_length=500)
    _close(fn2(u, M), _user(u, M).numpy())
    ((_infos, _e, program),) = fn2.plans
    assert program.descriptor.arg_layouts == ()


def test_plan_shootout_picks_measured_winner(tmp_path, monkeypatch):
    mod = tmp_path / "slow_v0.py"
    mod.write_text(
        "from feinsum_tpu_torch.codegen.descriptor import"
        " ScheduleDescriptor\n"
        "from feinsum_tpu_torch.tuning import BoolParameter,"
        " transform_param\n"
        "\n"
        "@transform_param('x', lambda e: BoolParameter())\n"
        "def transform(program, x):\n"
        "    e = program.einsum\n"
        "    return program.copy(descriptor=ScheduleDescriptor(\n"
        "        backend='xla',\n"
        "        arg_layouts=((e.args[0][0].name, (0, 1)),)))\n")
    db = str(tmp_path / "scratch.sqlite")
    dev = ft.FakeDevice(TPU)
    sql_utils.record_facts(_matvec20(), transform_id=str(mod),
                           transform_params={"x": True},
                           runtime_in_sec=1e-6, device=dev, db_path=db,
                           long_dim_length=2048)
    u, M = _matvec_args(7)
    times = iter([5e-3, 1e-4])
    calls = []

    def fake_time(runner, arrays, **kw):
        calls.append(runner)
        return next(times)
    monkeypatch.setattr(measure, "_timeit_in_graph", fake_time)
    fn2 = ft.compile_fn_with_archive(_user, [u, M], db_path=db, device=dev,
                                     long_dim_length=500, shootout=True)
    _close(fn2(u, M), _user(u, M).numpy())
    assert len(calls) == 2
    ((_i, _e, program),) = fn2.plans
    assert program.descriptor.arg_layouts == ()
    times2 = iter([1e-4, 5e-3])
    monkeypatch.setattr(measure, "_timeit_in_graph",
                        lambda r, a, **kw: next(times2))
    fn3 = ft.compile_fn_with_archive(_user, [u, M], db_path=db, device=dev,
                                     long_dim_length=501, shootout=True)
    _close(fn3(u, M), _user(u, M).numpy())
    ((_i, _e, program3),) = fn3.plans
    assert program3.descriptor.arg_layouts != ()


def test_timeit_in_graph_times_on_the_host():
    arrays = {"x": torch.ones(8)}
    assert measure._timeit_in_graph(lambda a: a["x"] * 2, arrays,
                                    min_work_seconds=0.01) > 0


def test_relayout_cost_model_accounting():
    E, d = 4096, 16
    from feinsum_tpu_torch.codegen.descriptor import ScheduleDescriptor

    def secs(e, **desc_kw):
        prog = ft.generate_program(e).copy(
            descriptor=ScheduleDescriptor(backend="xla", **desc_kw))
        lengths = {ix: (E if isinstance(ln, ft.SizeParam) else int(ln))
                   for ix, ln in e.index_to_dim_length.items()}
        return apply_mod._per_call_relayout_seconds(prog, lengths)

    e32 = ft.einsum("ej,ij->ei", ft.array("u", ("E", d), "float32"),
                    ft.array("D", (d, d), "float32"))
    u_bytes = E * d * 4
    retile, stream = apply_mod._RETILE_GBPS * 1e9, \
        apply_mod._STREAM_GBPS * 1e9
    assert secs(e32) == 0.0
    got = secs(e32, arg_layouts=(("u", (1, 0)),))
    assert np.isclose(got, 2 * u_bytes / retile)
    assert np.isclose(secs(e32, pre_layouts=(("u", ((0,), (1,))),)), got)
    assert np.isclose(secs(e32, rowcat=2, rowcat_args=(("u", ("u0", "u1")),)),
                      2 * 2 * u_bytes / stream)
    e64 = ft.einsum("ej,ij->ei", ft.array("u", ("E", d), "float64"),
                    ft.array("D", (d, d), "float64"))
    assert np.isclose(secs(e64, out_layout=(1, 0)), 2 * E * d * 8 / retile)
    assert np.isclose(secs(e64, dd_pairs=True),
                      2 * (E * d + d * d) * 8 / stream)
    # the floor: every distinct operand and output once over the H100's
    # data-sheet rate (also for a device with no peak table)
    lengths = {"e": E, "i": d, "j": d}
    floor = apply_mod._floor_seconds(e32, lengths, ft.FakeDevice(TPU))
    assert np.isclose(floor, (2 * u_bytes + d * d * 4) / 3350e9)


def _consumer_archive(tmp_path, E, sizes):
    db = str(tmp_path / "consumer.sqlite")
    for name, e in S.consumer_rows(**sizes):
        space = S.CONSUMER_SPACES[name]
        ft.autotune(e, space, db_path=db, device="cpu", long_dim_length=E,
                    test_limit=2,
                    seed_configs=[S.space_point(space, e),
                                  S.space_point(space, e, dofmajor=False)])
    return db


def test_consumer_flow_replays_archived_kernels(tmp_path):
    """examples/compile_user_rhs.py's flow at a small size: the div, lift
    and energy classes tuned into an archive on the CPU, then both torch
    functions compiled: the three div instructions form one b = 3 plan on
    ``dg_rows_f32``, the energy plan goes to ``long_reduce_f32``, and the
    outputs agree with the reference's functions (which find no facts and
    run their plain programs) on the same inputs."""
    E, sizes = 600, {"ndof": 8, "nf": 4, "nfdof": 6}
    db = _consumer_archive(tmp_path, E, sizes)
    args = S.consumer_args(E=E, **sizes, device="cpu")
    arrays = [a.numpy() for a in args]

    def j_rhs(dt, Jx, Jy, Jz, R, ux, uy, uz, L, Fj, flux):
        div = (jnp.einsum("es,sij,ej->ei", Jx, R, ux)
               + jnp.einsum("es,sij,ej->ei", Jy, R, uy)
               - jnp.einsum("es,sij,ej->ei", 2.0 * Jz + 1.0, R, uz))
        lift = jnp.einsum("ifj,fe,fej->ei", L, Fj, flux)
        return dt * (div - 0.5 * lift)

    def j_limited(dt, Jx, Jy, Jz, R, ux, uy, uz, L, Fj, flux):
        r = j_rhs(dt, Jx, Jy, Jz, R, ux, uy, uz, L, Fj, flux)
        energy = jnp.sqrt(jnp.einsum("ej,ej->", ux, ux))
        return jnp.tanh(r), energy

    for jfn, tfn in ((j_rhs, S.user_rhs), (j_limited, S.user_rhs_limited)):
        ref2 = fr.compile_fn_with_archive(jfn, _j(arrays),
                                          long_dim_length=500)
        fn2 = ft.compile_fn_with_archive(tfn, args, db_path=db,
                                         long_dim_length=500)
        got, want = fn2(*args), ref2(*_j(arrays))
        for g, w in zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))):
            _close(g, w)
        assert _plan_shape(fn2.plans) == _plan_shape(ref2.plans)
        kernels_of = {}
        for infos, einsum, program in fn2.plans:
            assert program.descriptor.backend == "pallas"
            kernels_of[einsum.b, einsum.get_subscripts()] = plan_cuda_launch(
                program, get_index_lengths(
                    einsum, E * program.descriptor.rowcat)).kernel
        assert any(b == 3 and k == "dg_rows_f32"
                   for (b, _), k in kernels_of.items())
        if tfn is S.user_rhs_limited:
            assert "long_reduce_f32" in kernels_of.values()

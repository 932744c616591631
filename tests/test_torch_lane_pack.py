"""The lane-pack rewrites of the port held to the JAX package on CPU, case
by case on the corpus of ``tests/test_lane_pack.py``: for each point the
port's program (einsum, schedule, descriptor, carried across by
``interop``) equals the reference's, the stored operands equal the
reference's ``apply_layouts``, and the outputs from the same numpy-seeded
inputs agree within 2e-5 of max|ref|, the reference's K1 in Pallas
interpret mode at one grid step (``block_long`` >= E/g; ROADMAP fault F3),
the port's packed programs on the kernels' plain versions
(``lane_pack_dg_plain``, ``dg_rows_plain``).  Where the port refuses a
point the reference builds, it says why: ``fold`` or ``mfold`` (no Hopper
meaning).  A packed matvec whose kron resident exceeds ``dg_rows_f32``'s
shared memory (g·d = 640 or 560) runs on ``probe_apply_f32``.  Every
shipped TPU lane-pack fact but those rulings builds and matches the
reference's output.  Also: the guards (alignment, the 4096 cap, the packed scale lanes, a long
axis g does not divide), the refused schedule knobs, the ``unpack_output``
round trip, ``lane_pack_dg_plain`` against the logical einsum, and the
relayout price of a packed program."""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import feinsum_tpu as fr
import feinsum_tpu_torch as ft
from feinsum_tpu.measure import (
    apply_layouts as ref_apply_layouts,
    generate_input_arrays as ref_generate_input_arrays,
)
from feinsum_tpu.tuning import get_transform_func_from_module_path as ref_space
from feinsum_tpu.tuning.impls import _common as ref_common
from feinsum_tpu_torch import apply as apply_mod
from feinsum_tpu_torch import sql_utils
from feinsum_tpu_torch.codegen.program import get_index_lengths, \
    stored_lengths
from feinsum_tpu_torch.interop import arrays_from_numpy, \
    program_from_reference
from feinsum_tpu_torch.measure import apply_layouts, generate_input_arrays
from feinsum_tpu_torch.ops import kernels
from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
from feinsum_tpu_torch.ops.lane_pack import expand_residents
from feinsum_tpu_torch.tuning import get_transform_func_from_module_path
from feinsum_tpu_torch.tuning.impls import _common

SEED = 11
RTOL = 2e-5
SHIPPED = (Path(__file__).resolve().parents[1] / "feinsum_tpu" / "data"
           / "transform_archive_v1_tpu.sqlite")
TPU = "TPU v5 lite"


def matvec(ndof=20):
    return ft.einsum("ej,ij->ei", ft.array("u", ("E", ndof), "float32"),
                     ft.array("D", (ndof, ndof), "float32"))


def vecmat(ndof=35):
    return ft.einsum("ej,j->e", ft.array("A", ("E", ndof), "float32"),
                     ft.array("x", (ndof,), "float32"))


def rect():
    return ft.einsum("ej,ij->ei", ft.array("u", ("E", 16), "float32"),
                     ft.array("D", (8, 16), "float32"))


def transposed():
    return ft.einsum("ej,ji->ei", ft.array("u", ("E", 16), "float32"),
                     ft.array("D", (16, 8), "float32"))


def div(ndof, b=3):
    return ft.batched_einsum(
        "es,sij,ej->ei",
        [[ft.array(j, ("E", 3), "float32"),
          ft.array("R", (3, ndof, ndof), "float32"),
          ft.array(u, ("E", ndof), "float32")]
         for j, u in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")][:b]])


def grad(ndof):
    return ft.einsum("xre,rij,ej->xei", ft.array("J", (3, 3, "E"), "float32"),
                     ft.array("D", (3, ndof, ndof), "float32"),
                     ft.array("u", ("E", ndof), "float32"))


def curl(ndof):
    return ft.batched_einsum(
        "e,rij,ej->ei",
        [[ft.array(j, ("E",), "float32"),
          ft.array("D", (3, ndof, ndof), "float32"),
          ft.array(u, ("E", ndof), "float32")]
         for j, u in [("Jy", "uz"), ("Jz", "ux"), ("Jx", "uy")]])


def face(ndof):
    return ft.einsum("ifj,fe,fej->ei", ft.array("L", (ndof, 4, 15), "float32"),
                     ft.array("Fj", (4, "E"), "float32"),
                     ft.array("flux", (4, "E", 15), "float32"))


def mass(ndof):
    return ft.einsum("e,ij,ej->ei", ft.array("jac", ("E",), "float32"),
                     ft.array("M", (ndof, ndof), "float32"),
                     ft.array("u", ("E", ndof), "float32"))


def to_reference(e):
    def dim(d):
        return d.name if isinstance(d, ft.SizeParam) else d
    return fr.batched_einsum(e.get_subscripts(), [
        [fr.array(a.name, tuple(dim(d) for d in a.shape), a.dtype)
         for a in row] for row in e.args])


def assert_close(got, ref, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _logical_out(e, E):
    return tuple(E if isinstance(e.index_to_dim_length[ix], ft.SizeParam)
                 else int(e.index_to_dim_length[ix]) for ix in e.out_idx_set)


def _check_against_reference(space, e, params, E, kernel=None):
    """*params* bound in *space* by both packages: the program, the stored
    operands and the outputs, and the port's through the numpy oracle; the
    fused route's kernel is *kernel*."""
    r = to_reference(e)
    ref_prog = ref_space(space).bind_args(r, **params)(fr.generate_program(r))
    want = program_from_reference(ref_prog)
    prog = get_transform_func_from_module_path(space).bind_args(
        e, **params)(ft.generate_program(e))
    assert (prog.schedule, prog.einsum) == (want.schedule, want.einsum)
    assert prog.descriptor == want.descriptor.copy(vmem_limit_bytes=None)
    assert prog.descriptor.block_long * prog.descriptor.lane_pack \
        >= E * prog.descriptor.rowcat
    logical = generate_input_arrays(e, long_dim_length=E, seed=SEED,
                                    as_numpy=True)
    ref_stored = ref_apply_layouts(ref_prog, ref_generate_input_arrays(
        r, long_dim_length=E, seed=SEED, as_numpy=True))
    ours = apply_layouts(prog, logical)
    assert sorted(ours) == sorted(ref_stored)
    for name in ours:
        np.testing.assert_array_equal(ours[name], np.asarray(ref_stored[name]))
    wants = fr.build_executable(ref_prog, long_dim_length=E)(ref_stored)
    kernels.reset_launch_counts()
    gots = ft.build_executable(prog, long_dim_length=E, device="cpu")(
        arrays_from_numpy(ours, "cpu"))
    assert not any(kernels.launch_counts.values())
    assert len(gots) == len(wants)
    for got, w in zip(gots, wants):
        assert_close(got.numpy(), np.asarray(w))
    if kernel is not None:
        assert plan_cuda_launch(prog, stored_lengths(
            prog, get_index_lengths(prog.einsum, E))).kernel == kernel
    ft.validate_batched_einsum_transform(
        e, get_transform_func_from_module_path(space).bind_args(e, **params),
        long_dim_length=E)
    return prog


# {{{ the matvec-class rewrite (rewrite_lane_pack)

MATVEC_CASES = {
    # test_lane_pack_validates_against_oracle
    "matvec_g4": (matvec, dict(dofmajor=False, lane_pack_g=2)),
    "matvec_g32": (matvec, dict(dofmajor=False, lane_pack_g=5)),
    "matvec_g32_dofmajor": (matvec, dict(dofmajor=True, lane_pack_g=5)),
    # test_lane_pack_rect_and_transposed_resident
    "rect": (rect, dict(dofmajor=True, lane_pack_g=3)),
    "transposed": (transposed, dict(dofmajor=True, lane_pack_g=2)),
    # test_lane_pack_vecmat_variant
    "vecmat_g8": (vecmat, dict(dofmajor=False, lane_pack_g=3)),
    "vecmat_g16_dofmajor": (vecmat, dict(dofmajor=True, lane_pack_g=4)),
    # test_lane_pack_packed_output_contract
    "matvec8_g16": (lambda: matvec(8), dict(dofmajor=False, lane_pack_g=4)),
}


@pytest.mark.parametrize("case", sorted(MATVEC_CASES))
def test_matvec_rewrite_matches_reference(case):
    """The packed matvec, rectangular, transposed and vecmat residents:
    the reference's program and outputs on ``dg_rows_f32``'s route; a
    packed resident over a Hopper block's shared memory of that kernel
    (g·d = 640 at g = 32, 560 for the vecmat at g = 16) goes to
    ``probe_apply_f32``, whose ring streams R, with the reference's program
    and outputs all the same."""
    make, knobs = MATVEC_CASES[case]
    e = make()
    params = dict(log2_block=10, parallel_grid=True, **knobs)
    E = 2048
    wide = case in ("matvec_g32", "matvec_g32_dofmajor",
                    "vecmat_g16_dofmajor")
    _check_against_reference(
        "mass_v0", e, params, E,
        kernel="probe_apply_f32" if wide else "dg_rows_f32")


def test_lane_pack_gates_by_class():
    """``lane_pack_g`` is searched where the reference searches it: the
    matvec, vecmat and the DG classes, not rowsum."""
    for e in (div(5), matvec(), vecmat(), grad(4), ft.einsum(
            "ej->e", ft.array("A", ("E", 35), "float32"))):
        ours = get_transform_func_from_module_path("dg_div_v0")\
            .get_param_space(e)["lane_pack_g"]
        ref = ref_space("dg_div_v0").get_param_space(
            to_reference(e))["lane_pack_g"]
        assert (ours.low, ours.high) == (ref.low, ref.high)
        assert bool(_common.lane_packable(e)) \
            == bool(ref_common.lane_packable(to_reference(e)))
    assert _common.lane_packable(ft.einsum(
        "ej->e", ft.array("A", ("E", 35), "float32"))) is None


@pytest.mark.parametrize("ndof,g,ok", [(35, 2, False), (35, 8, True),
                                       (20, 256, False), (20, 128, True)])
def test_lane_pack_guards(ndof, g, ok):
    """The reference's guards define the space: g·d a multiple of 8 (35 at
    g = 2), at most 4096 (20 at g = 256); the same errors."""
    e = matvec(ndof)
    results = []
    for common, pkg, ee in ((_common, ft, e),
                            (ref_common, fr, to_reference(e))):
        try:
            _p, extras = common.rewrite_lane_pack(pkg.generate_program(ee), g)
            results.append(extras["lane_pack"])
        except pkg.InvalidParameterError as err:
            results.append(str(err))
    assert results[0] == results[1]
    assert ok == isinstance(results[0], int)
    if ndof == 35 and ok:
        p2, _ = _common.rewrite_lane_pack(ft.generate_program(e), g)
        assert p2.einsum.arg_to_shape["D"] == (280, 280)


def test_lane_pack_requires_divisible_length():
    """A long axis g does not divide raises, in ``build_executable`` and in
    ``apply_layouts``, as in the reference; validation rounds up."""
    space = get_transform_func_from_module_path("mass_v0")
    e = matvec()
    tr = space.bind_args(e, log2_block=10, dofmajor=False,
                         parallel_grid=True, lane_pack_g=2)
    prog = tr(ft.generate_program(e))
    with pytest.raises(ft.InvalidParameterError, match="divisible"):
        ft.build_executable(prog, long_dim_length=1002)
    with pytest.raises(ft.InvalidParameterError, match="divisible"):
        apply_layouts(prog, generate_input_arrays(e, long_dim_length=1002,
                                                  as_numpy=True))
    ft.validate_batched_einsum_transform(e, tr, long_dim_length=1002)


def test_lane_pack_packed_output_contract():
    """The packed operand (E/g, g·d) is a view of the row-major (E, d)
    tensor, the resident arrives logical and is kron-expanded in the
    executable, and the packed output unpacks to the logical one."""
    space = get_transform_func_from_module_path("mass_v0")
    e = matvec(8)
    prog = space.bind_args(e, log2_block=10, dofmajor=False,
                           parallel_grid=True, lane_pack_g=4)(
        ft.generate_program(e))
    E = 1024
    raw = generate_input_arrays(e, long_dim_length=E, seed=SEED,
                                device="cpu")
    arrays = apply_layouts(prog, raw)
    assert arrays["u"].shape == (E // 16, 16 * 8)
    assert arrays["u"].data_ptr() == raw["u"].data_ptr()
    assert arrays["D"].shape == (8, 8)
    T = expand_residents(prog, arrays)["D"]
    assert T.shape == (128, 128)
    assert torch.equal(T, torch.block_diag(*[raw["D"]] * 16))
    (out,) = ft.build_executable(prog, long_dim_length=E, device="cpu")(
        arrays)
    assert out.shape == (E // 16, 16 * 8)
    assert_close(ft.unpack_output(prog, out, (E, 8)).numpy(),
                 raw["u"].double().numpy() @ raw["D"].double().numpy().T)

# }}}


# {{{ the DG rewrite (rewrite_lane_pack_dg)

DG_CASES = {
    "div4": (lambda: div(4), 3), "div4_b1": (lambda: div(4, b=1), 4),
    "div10": (lambda: div(10), 3), "grad4": (lambda: grad(4), 3),
    "grad10": (lambda: grad(10), 3), "curl4": (lambda: curl(4), 3),
    "mass8": (lambda: mass(8), 3), "face35": (lambda: face(35), 3),
}


@pytest.mark.parametrize("dofmajor", [False, True])
@pytest.mark.parametrize("case", sorted(DG_CASES))
def test_dg_rewrite_matches_reference(case, dofmajor):
    """div at b = 1 and 3, grad, curl, mass and face-mass in both layouts:
    the reference's program, stored operands and outputs, on
    ``lane_pack_dg_f32``'s route (its plain version here)."""
    make, lg = DG_CASES[case]
    _check_against_reference(
        "dg_div_v0", make(), dict(log2_block=9, dofmajor=dofmajor,
                                  parallel_grid=True, lane_pack_g=lg),
        E=512, kernel="lane_pack_dg_f32")


@pytest.mark.parametrize("make", [lambda: div(4), lambda: curl(4)],
                         ids=["div", "curl"])
def test_dg_rewrite_composes_with_rowcat(make):
    """rowcat first, then the packing of the stacked operands."""
    prog = _check_against_reference(
        "dg_div_v0", make(), dict(log2_block=9, dofmajor=True,
                                  parallel_grid=True, rowcat=True,
                                  lane_pack_g=3), E=512,
        kernel="lane_pack_dg_f32")
    assert prog.descriptor.rowcat == 3 and prog.descriptor.lane_pack == 8
    assert prog.einsum.b == 1


@pytest.mark.parametrize("make,g", [(lambda: div(4), 8), (lambda: grad(4), 8),
                                    (lambda: curl(4), 8),
                                    (lambda: mass(8), 8),
                                    (lambda: face(35), 8)],
                         ids=["div", "grad", "curl", "mass", "face"])
def test_dg_rewrite_on_canonical_forms(make, g):
    """The archive replays facts on the canonical einsum (letters and
    operand order permuted): the rewrite of each class there, through the
    reference's ``rewrite_lane_pack_dg`` and ``fused_pallas_program`` with
    the schedule kept."""
    r = fr.canonicalize_einsum(to_reference(make()))
    e = ft.canonicalize_einsum(make())
    ref_p, ref_ex = ref_common.rewrite_lane_pack_dg(fr.generate_program(r), g)
    ref_p = ref_common.fused_pallas_program(
        ref_p, block_long=512, hoist=False, parallel_grid=True,
        keep_schedule=True).with_descriptor(**ref_ex)
    p, ex = _common.rewrite_lane_pack_dg(ft.generate_program(e), g)
    p = _common.fused_pallas_program(
        p, block_long=512, hoist=False, parallel_grid=True,
        keep_schedule=True).with_descriptor(**ex)
    want = program_from_reference(ref_p)
    assert (p.einsum, p.schedule, p.descriptor) == (
        want.einsum, want.schedule, want.descriptor)
    ft.validate_batched_einsum_transform(e, lambda _p: p,
                                         long_dim_length=512)


@pytest.mark.parametrize("bad", ["hoist", "jfold", "mfold", "prereduce"])
def test_dg_rewrite_refuses_schedule_knobs(bad):
    """The DG variant fixes its own schedule: hoist, jfold, mfold and
    prereduce raise, in both packages."""
    e = ft.canonicalize_einsum(div(4))
    r = fr.canonicalize_einsum(to_reference(div(4)))
    params = dict(log2_block=9, dofmajor=False, parallel_grid=True,
                  lane_pack_g=1, **{bad: True})
    with pytest.raises(fr.InvalidParameterError, match="own schedule"):
        ref_space("dg_div_v0").bind_args(r, **params)(fr.generate_program(r))
    with pytest.raises(ft.InvalidParameterError, match="own schedule"):
        get_transform_func_from_module_path("dg_div_v0").bind_args(
            e, **params)(ft.generate_program(e))


@pytest.mark.parametrize("make,g,match", [
    (lambda: div(10), 1, "8-sublane-aligned"),
    (lambda: div(4), 4, "scale lanes"),
    (lambda: mass(8), 4, "scale lanes"),
    (lambda: mass(200), 32, "4096"),
    (lambda: div(4), 8, None)], ids=["dof", "scale_A", "scale_B", "cap",
                                     "ok"])
def test_dg_rewrite_guards(make, g, match):
    """The reference's guards: the dof lanes and the packed scale lanes
    (g·s for div's J, g for the others) multiples of 8, g·d at most 4096;
    the same errors in both packages."""
    e = make()
    results = []
    for common, pkg, ee in ((_common, ft, e),
                            (ref_common, fr, to_reference(e))):
        try:
            _p, extras = common.rewrite_lane_pack_dg(
                pkg.generate_program(ee), g)
            results.append(extras["lane_pack"])
        except pkg.InvalidParameterError as err:
            results.append(str(err))
    assert results[0] == results[1]
    if match is None:
        assert results[0] == g
    else:
        assert match in results[0]


def test_dg_rewrite_refuses_fold():
    """``fold`` with a lane-pack point (the reference composes them) names
    ``fold``: the TPU's fold-8 storage has no Hopper meaning."""
    e = grad(4)
    params = dict(log2_block=9, dofmajor=True, fold=True, parallel_grid=True,
                  lane_pack_g=3)
    ref_space("dg_grad_v0").bind_args(to_reference(e), **params)(
        fr.generate_program(to_reference(e)))
    with pytest.raises(ft.InvalidParameterError, match="fold"):
        get_transform_func_from_module_path("dg_grad_v0").bind_args(
            e, **params)(ft.generate_program(e))


def test_dg_tpu_vmem_guards_are_not_hopper_limits():
    """Points the reference refuses for the TPU's VMEM build here: the
    kernel stages a fixed tile whatever the block length."""
    e = ft.canonicalize_einsum(div(4))
    r = fr.canonicalize_einsum(to_reference(div(4)))
    params = dict(log2_block=9, dofmajor=False, parallel_grid=True,
                  fold=False, preblock=False, precision_3x=False,
                  hoist=False, jfold=False, mfold=False, prereduce=False,
                  accum_f32=False, host_hoist=True, blkc128=20, vmem_idx=0,
                  rowcat=True, lane_pack_g=5, split_rows=False)
    with pytest.raises(fr.InvalidParameterError, match="VMEM"):
        ref_space("dg_div_v0")(fr.generate_program(r), r, **params)
    prog = get_transform_func_from_module_path("dg_div_v0")(
        ft.generate_program(e), e, **params)
    assert prog.descriptor.block_long == 20 * 1024


def test_dg_unpack_output_roundtrip():
    """``build_executable`` and ``unpack_output`` give the logical grad
    output from its packed storage (x, E/g, g·di)."""
    e = grad(4)
    g, E = 8, 512
    p, extras = _common.rewrite_lane_pack_dg(ft.generate_program(e), g)
    p = _common.fused_pallas_program(p, block_long=512, hoist=False,
                                     parallel_grid=True,
                                     keep_schedule=True).with_descriptor(
        **extras)
    arrays = generate_input_arrays(e, long_dim_length=E, seed=SEED,
                                   device="cpu")
    (out,) = ft.build_executable(p, long_dim_length=E, device="cpu")(
        apply_layouts(p, arrays))
    assert out.shape == (3, E // g, g * 4)
    logical = ft.unpack_output(p, out, (3, E, 4))
    assert_close(logical.numpy(), np.einsum(
        "xre,rij,ej->xei", *[arrays[k].double().numpy()
                             for k in ("J", "D", "u")]))


@pytest.mark.parametrize("case", ["div4", "grad10", "face35", "curl4"])
@pytest.mark.parametrize("split", [False, True])
def test_lane_pack_dg_plain_is_the_logical_einsum(case, split):
    """``lane_pack_dg_plain`` (and its 3x version) on a packed program's
    rows, unpacked, is one ``torch.einsum`` of the logical einsum."""
    make, lg = DG_CASES[case]
    e = make()
    prog = get_transform_func_from_module_path("dg_div_v0").bind_args(
        e, log2_block=9, dofmajor=True, parallel_grid=True, lane_pack_g=lg,
        precision_3x=split)(ft.generate_program(e))
    E = 2 ** lg * 24
    arrays = generate_input_arrays(e, long_dim_length=E, seed=SEED,
                                   device="cpu")
    plan = plan_cuda_launch(prog, stored_lengths(
        prog, get_index_lengths(prog.einsum, E)))
    assert plan.kernel == ("lane_pack_dg_3xtf32" if split
                           else "lane_pack_dg_f32")
    outs = plan.plain(plan.operands(expand_residents(
        prog, apply_layouts(prog, arrays))))
    subs = e.get_subscripts().replace(" ", "")
    for row, out in zip(e.args, outs):
        want = torch.einsum(subs, *[arrays[a.name].double() for a in row])
        assert_close(ft.unpack_output(prog, out, _logical_out(e, E)).numpy(),
                     want.numpy(), rtol=2e-6 if split else RTOL)

# }}}


def test_lane_packing_costs_nothing_in_the_relayout_price():
    """A packed program's storage contract is priced at its packed sizes:
    the packing is a view (free), the dof-major copy of the packed operands
    and output is charged as any other."""
    e = div(8, b=1)
    space = get_transform_func_from_module_path("dg_div_v0")
    E = 4096

    def secs(**knobs):
        prog = space.bind_args(e, log2_block=9, parallel_grid=True,
                               **knobs)(ft.generate_program(e))
        # compile_fn_with_archive's lengths: the rewritten einsum's own
        # concrete axes, the caller's long axis
        return apply_mod._per_call_relayout_seconds(prog, {
            ix: (E if isinstance(ln, ft.SizeParam) else int(ln))
            for ix, ln in prog.einsum.index_to_dim_length.items()})
    assert secs(dofmajor=False, lane_pack_g=3) == 0.0
    assert secs(dofmajor=True) > 0
    assert np.isclose(secs(dofmajor=True, lane_pack_g=3),
                      secs(dofmajor=True))


# {{{ every shipped lane-pack fact

def shipped_facts_of(tmp_path, keep) -> list:
    """``(canonical einsum, fact)`` of the shipped archive (a copy) for the
    TPU whose fact passes *keep*."""
    db = tmp_path / "archive.sqlite"
    shutil.copy(SHIPPED, db)
    return [(e, q) for e in sql_utils.get_timed_einsums_in_db(db_path=str(db))
            for q in sql_utils.query(e, ft.FakeDevice(TPU), db_path=str(db),
                                     err_if_no_results=False)
            if keep(q)]


def run_fact_in_both(e, q, length: int, ref_block: int = 0) -> tuple:
    """The fact *q* bound on the canonical einsum *e* in both packages, on
    the same seeded inputs: ``(port outputs, reference outputs, port
    program)``.  The reference runs its K1 in interpret mode at one grid
    step (its block raised to *ref_block* where given, ROADMAP fault F3)."""
    params = dict(q.transform_params)
    space = q.transform_id.removesuffix(".py")
    r = to_reference(e)
    prog = get_transform_func_from_module_path(space).bind_args(
        e, **params)(ft.generate_program(e))
    gots = ft.build_executable(prog, long_dim_length=length, device="cpu")(
        arrays_from_numpy(apply_layouts(prog, generate_input_arrays(
            e, long_dim_length=length, seed=SEED, as_numpy=True)), "cpu"))
    try:
        ref_prog = ref_space(space).bind_args(r, **params)(
            fr.generate_program(r))
    except fr.InvalidParameterError as err:
        # the reference's VMEM guard (a TPU limit) refuses the point at its
        # block: the JAX package's plain program on the same inputs, and
        # the port's outputs unpacked to the logical layout
        assert "VMEM" in str(err), err
        ref_prog = fr.generate_program(r)
        gots = [ft.unpack_output(prog, g, _logical_out(e, length))
                for g in gots]
    if ref_block:
        ref_prog = ref_prog.copy(descriptor=ref_prog.descriptor.copy(
            block_long=ref_block))
    ref_stored = ref_apply_layouts(ref_prog, ref_generate_input_arrays(
        r, long_dim_length=length, seed=SEED, as_numpy=True))
    wants = fr.build_executable(ref_prog, long_dim_length=length)(ref_stored)
    return ([g.numpy() for g in gots], [np.asarray(w) for w in wants], prog)


@pytest.mark.parametrize("space_id,count", [
    ("dg_div_v0.py", 21), ("dg_grad_v0.py", 14), ("face_mass_v0.py", 2),
    ("mass_v0.py", 58)])
def test_shipped_lane_pack_facts_match_reference(tmp_path, space_id, count):
    """Every shipped lane-pack fact but the ``fold``/``mfold`` rulings (9
    of 104) builds and matches the JAX package's output on the CPU; the 25
    packed matvecs and vecmats whose kron resident exceeds ``dg_rows_f32``'s
    shared memory (which used to raise) plan onto ``probe_apply``."""
    facts = shipped_facts_of(tmp_path, lambda q: q.transform_id == space_id
                             and dict(q.transform_params).get("lane_pack_g"))
    n = n_wide = 0
    for e, q in facts:
        params = dict(q.transform_params)
        if params.get("fold") or params.get("mfold"):
            with pytest.raises(ft.InvalidParameterError, match="fold"):
                q.transform(ft.generate_program(e))
            continue
        gots, wants, prog = run_fact_in_both(e, q, 64)
        for got, want in zip(gots, wants):
            assert_close(got, want)
        kernel = plan_cuda_launch(prog, stored_lengths(
            prog, get_index_lengths(prog.einsum, 64))).kernel
        n_wide += kernel.startswith("probe_apply")
        n += 1
    assert n == count
    assert n_wide == (25 if space_id == "mass_v0.py" else 0)

# }}}

"""The f32 DG spaces of the port held to the JAX package on CPU.

* every space (``dg_div_v0``, ``dg_grad_v0``, ``face_mass_v0``, ``mass_v0``,
  ``curl_3d_v0``, ``elementwise_v1``, ``xla_v0`` and ``make_dg_space``
  itself) has the reference's parameter names and defaults, and at seeded
  points of the reference's space the port's program (schedule, einsum and
  descriptor, carried across by ``interop``) equals the reference's, or the
  port raises ``InvalidParameterError`` for a knob the descriptor's ruling
  refuses (``fold``, ``preblock``, ``mfold``) or for a Hopper block's
  shared memory; the port does not set ``vmem_limit_bytes`` (``vmem_idx``
  is accepted and ignored); ``precision_3x`` sets ``precision="bf16_3x"``
  and ``lane_pack_g`` the lane-pack rewrites, as in the reference;
* every shipped TPU fact of those seven transform ids binds: it builds, or
  raises naming a refused knob or shared memory; the 102 that set
  ``precision_3x`` and no refused knob build, and of the 104 that set
  ``lane_pack_g`` 70 build (the DG ones onto ``lane_pack_dg_f32`` or its
  3x variant, the matvec and vecmat ones onto ``dg_rows_f32`` or
  ``dg_rows_3xtf32``), 7 raise naming ``fold``, 2 ``mfold`` and 25 (packed
  matvecs over g·d up to 1120) shared memory;
* outputs equal the reference's from the same numpy-seeded inputs within
  2e-5 (f32) and 1e-12 (f64): vecmat and rowsum through ``mass_v0``, curl
  with ``prereduce`` (the hoisted pre-reduction), div with ``rowcat``,
  ``scale_flat`` with ``flatten``, ``xla_v0`` with a ragged last chunk, and
  one whole row taken through tune -> archive -> ``candidate_transforms`` ->
  replay.  The reference's K1 and K3 run in Pallas interpret mode at one
  grid step (``block_long`` >= the long axis; ROADMAP fault F3).
"""

from __future__ import annotations

import inspect
import shutil
from pathlib import Path

import numpy as np
import pytest

import feinsum_tpu as fr
import feinsum_tpu_torch as ft
from feinsum_tpu.algebraic import \
    extract_multiplicative_terms_in_sum_reduction_as_subst as ref_extract
from feinsum_tpu.measure import (
    apply_layouts as ref_apply_layouts,
    generate_input_arrays as ref_generate_input_arrays,
)
from feinsum_tpu.tuning import get_transform_func_from_module_path as ref_space
from feinsum_tpu.tuning.impls import _common as ref_common
from feinsum_tpu_torch import sql_utils, suite as S
from feinsum_tpu_torch.algebraic import \
    extract_multiplicative_terms_in_sum_reduction_as_subst
from feinsum_tpu_torch.codegen.descriptor import ScheduleDescriptor
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

E = 64
SEED = 17
SHIPPED = (Path(__file__).resolve().parents[1] / "feinsum_tpu" / "data"
           / "transform_archive_v1_tpu.sqlite")
TPU = "TPU_v5_lite"
DG_SPACES = ("dg_div_v0", "dg_grad_v0", "face_mass_v0", "mass_v0",
             "curl_3d_v0")
SPACES = DG_SPACES + ("elementwise_v1", "xla_v0")
# what the port refuses by the descriptor's rulings
RULED = ("fold", "preblock", "mfold")
# what the port refuses for a Hopper block (a packed matvec's resident)
HOPPER_GUARDS = ("shared memory",)
# what the reference refuses for the TPU alone
TPU_GUARDS = ("VMEM", "MiB")


def _vecmat(ndof):
    return ft.einsum("ej,j->e", ft.array("A", ("E", ndof), "float32"),
                     ft.array("x", (ndof,), "float32"))


def _rowsum(ndof):
    return ft.einsum("ej->e", ft.array("A", ("E", ndof), "float32"))


# narrow rows of each space's family
ROWS = {
    "dg_div_v0": {"div_b3": S.make_div(6), "div_single": ft.einsum(
        "es,sij,ej->ei", ft.array("J", ("E", 3), "float32"),
        ft.array("R", (3, 5, 5), "float32"),
        ft.array("u", ("E", 5), "float32"))},
    "dg_grad_v0": {"grad": S.make_grad(7)},
    "face_mass_v0": {"face": S.make_face_mass(8, 5)},
    "mass_v0": {"mass": S.make_mass(9), "matvec": S.make_matvec(10),
                "vecmat": _vecmat(5), "rowsum": _rowsum(4)},
    "curl_3d_v0": {"curl": S.make_curl(6)},
    "elementwise_v1": {"copy": S.make_copy(5),
                       "scale_flat": S.make_scale_flat()},
    "xla_v0": {"div_b3": S.make_div(6), "grad": S.make_grad(7),
               "div_f64": S.make_div(5, "float64")},
}


def to_reference(e):
    def dim(d):
        return d.name if isinstance(d, ft.SizeParam) else d
    return fr.batched_einsum(e.get_subscripts(), [
        [fr.array(a.name, tuple(dim(d) for d in a.shape), a.dtype)
         for a in row] for row in e.args])


def assert_close(got, ref, rtol=2e-5):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _sample_params(space: dict, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [{k: space[k].sample(rng) for k in sorted(space)}
            for _ in range(n)]


# {{{ the spaces against the reference's

@pytest.mark.parametrize("space", SPACES + ("make_dg_space",))
def test_space_has_the_reference_parameters(space):
    """Names, signature defaults, and ranges inside the reference's."""
    if space == "make_dg_space":
        ours, ref = _common.make_dg_space(), ref_common.make_dg_space()
        rows = [e for k in DG_SPACES for e in ROWS[k].values()]
    else:
        ours = get_transform_func_from_module_path(space)
        ref = ref_space(space)
        rows = list(ROWS[space].values())
    for e in rows:
        ours_params = ours.get_param_space(e)
        ref_params = ref.get_param_space(to_reference(e))
        assert set(ours_params) == set(ref_params)
        for k, p in ours_params.items():
            if hasattr(p, "low"):
                lo, hi = ((ref_params[k].low, ref_params[k].high)
                          if hasattr(ref_params[k], "low") else (0, 1))
                assert lo <= p.low <= p.high <= hi, k

    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(
            fn).parameters.items()}
    assert defaults(ours.fn) == defaults(ref.fn)


def _compare(space, key, params):
    """``(want, got)``: the reference's program carried across (or its
    error) and the port's (or its error)."""
    e = ROWS[space][key]
    r = to_reference(e)
    try:
        want = program_from_reference(
            ref_space(space).bind_args(r, **params)(fr.generate_program(r)))
    except fr.InvalidParameterError as err:
        want = err
    try:
        got = get_transform_func_from_module_path(space).bind_args(
            e, **params)(ft.generate_program(e))
    except ft.InvalidParameterError as err:
        got = err
    return e, want, got


@pytest.mark.parametrize("space,key", [(s, k) for s in SPACES
                                       for k in sorted(ROWS[s])])
def test_programs_match_reference(space, key):
    """At 60 seeded points of the reference's space, at each with the ruled
    knobs off, and at each with them and ``lane_pack_g`` off: the same
    schedule, einsum and descriptor (but ``vmem_limit_bytes``), or a ruled
    raise or a raise for a Hopper block's shared memory."""
    r = to_reference(ROWS[space][key])
    ref_params = ref_space(space).get_param_space(r)
    ruled_off = {k: False for k in ("fold", "preblock", "mfold")
                 if k in ref_params}
    unpacked = {"lane_pack_g": 0} if "lane_pack_g" in ref_params else {}
    n_compared = 0
    for sampled in _sample_params(ref_params, 60, seed=len(space + key)):
        for params in (sampled, {**sampled, **ruled_off},
                       {**sampled, **ruled_off, **unpacked}):
            e, want, got = _compare(space, key, params)
            if isinstance(want, Exception) and isinstance(got, Exception):
                continue
            if isinstance(got, Exception):
                assert any(w in str(got) for w in RULED + HOPPER_GUARDS), \
                    (params, got)
                continue
            if isinstance(want, Exception):
                assert any(w in str(want) for w in TPU_GUARDS), \
                    (params, want)
                ft.build_executable(got, long_dim_length=E, device="cpu")
                continue
            assert got.schedule == want.schedule, params
            assert got.einsum == want.einsum, params
            assert got.descriptor == want.descriptor.copy(
                vmem_limit_bytes=None), params
            n_compared += 1
    assert n_compared >= 10


@pytest.mark.parametrize("space,key,params", [
    ("curl_3d_v0", "curl", dict(prereduce=True)),
    ("curl_3d_v0", "curl", dict(prereduce=True, rowcat=True)),
    ("curl_3d_v0", "curl", dict(jfold=1, hoist=1)),
    ("curl_3d_v0", "curl", dict(prereduce=True, host_hoist=0)),
    ("dg_div_v0", "div_b3", dict(rowcat=True)),
    ("dg_div_v0", "div_b3", dict(jfold=1, split_rows=True)),
    ("dg_grad_v0", "grad", dict(hoist=1, dofmajor=False)),
    ("elementwise_v1", "scale_flat", dict(flatten=True)),
    ("mass_v0", "vecmat", dict(dofmajor=False)),
    ("dg_div_v0", "div_b3", dict(precision_3x=True)),
    ("curl_3d_v0", "curl", dict(prereduce=True, precision_3x=True)),
    ("mass_v0", "vecmat", dict(precision_3x=True)),
], ids=lambda v: str(v) if not isinstance(v, dict) else "-".join(v))
def test_searched_points_match_reference(space, key, params):
    """The points the port searches or seeds, at the reference's values
    for the rest (which build there and here)."""
    e = ROWS[space][key]
    full = S.space_point(space, e, **params)
    ref_params = ref_space(space).get_param_space(to_reference(e))
    full = {k: full.get(k, False) for k in ref_params}
    _, want, got = _compare(space, key, full)
    assert not isinstance(want, Exception) and not isinstance(got,
                                                              Exception)
    assert got.schedule == want.schedule
    assert got.einsum == want.einsum
    assert got.descriptor == want.descriptor.copy(vmem_limit_bytes=None)


@pytest.mark.parametrize("knob,value", [
    ("fold", 1), ("preblock", 1), ("mfold", 1), ("lane_pack_g", 2)])
def test_ruled_knobs_raise(knob, value):
    """``fold``, ``preblock`` and ``mfold`` raise naming the knob;
    ``lane_pack_g`` builds the reference's program (matvec at g = 4)."""
    if knob == "lane_pack_g":
        params = S.space_point("mass_v0", ROWS["mass_v0"]["matvec"],
                               lane_pack_g=value)
        _, want, got = _compare("mass_v0", "matvec", params)
        assert got.descriptor.lane_pack == 4
        assert (got.schedule, got.einsum, got.descriptor) == (
            want.schedule, want.einsum,
            want.descriptor.copy(vmem_limit_bytes=None))
        ft.build_executable(got, long_dim_length=E, device="cpu")
        return
    e = ROWS["mass_v0"]["mass"]
    params = S.space_point("mass_v0", e, **{knob: value})
    with pytest.raises(ft.InvalidParameterError, match=knob):
        get_transform_func_from_module_path("mass_v0").bind_args(
            e, **params)(ft.generate_program(e))


@pytest.mark.parametrize("space,key", [
    ("dg_div_v0", "div_b3"), ("curl_3d_v0", "curl"), ("mass_v0", "mass"),
    ("mass_v0", "vecmat"), ("elementwise_v1", "scale_flat"),
    ("elementwise_v1", "copy")])
def test_searched_knobs_change_the_launch(space, key):
    """Every knob the port searches changes the kernel, its arguments or
    its launch; every other knob is pinned to one value."""
    e = ROWS[space][key]
    space_params = get_transform_func_from_module_path(
        space).get_param_space(e)
    searched = [k for k, p in space_params.items()
                if not hasattr(p, "low") or p.low < p.high]
    base = S.space_point(space, e)

    def launch(params):
        """The kernel, its arguments' shapes and strides, and the launch
        knobs it reads."""
        p = get_transform_func_from_module_path(space).bind_args(
            e, **params)(ft.generate_program(e))
        plan = plan_cuda_launch(p, stored_lengths(
            p, get_index_lengths(p.einsum, E)))
        rows = plan.operands(expand_residents(p, apply_layouts(
            p, generate_input_arrays(e, long_dim_length=E, seed=SEED,
                                     device="cpu"))))
        args = [tuple((tuple(t.shape), t.stride()) for t in (
            row if isinstance(row, list)
            else [v for v in vars(row).values() if v is not None]))
            for row in rows]
        reads_block = plan.kernel != "ew_product_f32"
        return (plan.kernel, args,
                p.descriptor.block_long if reads_block else None,
                p.descriptor.multiple_results_in_one_kernel)

    for k in searched:
        p = space_params[k]
        other = (not base[k]) if not hasattr(p, "low") else (
            p.high if base[k] != p.high else p.low)
        if space == "elementwise_v1" and k in ("log2_block", "blkc128"):
            base_k = dict(base, flatten=True)
            assert launch(base_k) != launch(dict(base_k, **{k: other})), k
            continue
        assert launch(base) != launch(dict(base, **{k: other})), k


def test_jfold_schedule_matches_reference():
    for e in (S.make_div(5), S.make_curl(4), S.make_face_mass(6, 3)):
        r = to_reference(e)
        streamed = [p for p in range(e.n)
                    if any(isinstance(e.index_to_dim_length[ix],
                                      ft.SizeParam)
                           for ix in e.in_idx_sets[p])]
        ours = extract_multiplicative_terms_in_sum_reduction_as_subst(
            ft.generate_program(e), streamed)
        ref = ref_extract(fr.generate_program(r), streamed)
        assert ours.schedule == program_from_reference(ref).schedule
        assert _common.has_resident_private_indices(e) == \
            ref_common.has_resident_private_indices(r)
        assert _common.jfold_applicable(e) == ref_common.jfold_applicable(r)
        assert _common.rowcat_applicable(e) == \
            ref_common.rowcat_applicable(r)
        assert bool(_common.lane_pack_dg_applicable(e)) == \
            bool(ref_common.lane_pack_dg_applicable(r))
        assert _common.lane_packable(e) == ref_common.lane_packable(r)


def test_guard_smem_routes_each_row():
    """The shared-memory guard sends each row to the kernel that runs it:
    rows without i and contraction-free rows pass; a DG row over 227 KB
    and a vecmat over the kernel's j limit raise."""
    for e in (_vecmat(35), _rowsum(35), S.make_copy(35), S.make_mass(35),
              S.make_scale_flat()):
        _common.guard_smem(e, "dg_rows_f32")
    with pytest.raises(ft.InvalidParameterError, match="shared memory"):
        _common.guard_smem(_vecmat(kernels.MAX_REDUCE_J + 1), "dg_rows_f32")
    with pytest.raises(ft.InvalidParameterError, match="shared memory"):
        _common.guard_smem(S.make_grad(200), "dg_rows_f32")

# }}}


# {{{ the shipped archive's TPU facts

@pytest.fixture(scope="module")
def shipped_facts(tmp_path_factory):
    db = tmp_path_factory.mktemp("archive") / "archive.sqlite"
    shutil.copy(SHIPPED, db)
    facts: dict = {}
    for e in sql_utils.get_timed_einsums_in_db(db_path=str(db)):
        for q in sql_utils.query(e, ft.FakeDevice(TPU), db_path=str(db),
                                 err_if_no_results=False):
            facts.setdefault(q.transform_id, []).append((e, q))
    return facts


@pytest.mark.parametrize("space_id,count", [
    ("dg_div_v0.py", 299), ("dg_grad_v0.py", 271), ("face_mass_v0.py", 55),
    ("mass_v0.py", 380), ("curl_3d_v0.py", 32), ("elementwise_v1.py", 42),
    ("xla_v0.py", 26)])
def test_tpu_facts_bind(shipped_facts, space_id, count):
    """Every fact binds: its program builds on the port, or the bind or
    the build raises naming a knob the ruling refuses or shared memory."""
    n_built = n_ruled = 0
    for e, q in shipped_facts.get(space_id, []):
        try:
            prog = q.transform(ft.generate_program(e))
            ft.build_executable(prog, long_dim_length=64, device="cpu")
            n_built += 1
        except ft.InvalidParameterError as err:
            assert any(w in str(err) for w in RULED + HOPPER_GUARDS
                       + ("flatten",)), (dict(q.transform_params), err)
            n_ruled += 1
    assert n_built + n_ruled == count
    assert n_built > 0


@pytest.mark.parametrize("space_id,count", [
    ("dg_div_v0.py", 19), ("dg_grad_v0.py", 22), ("face_mass_v0.py", 3),
    ("mass_v0.py", 57), ("curl_3d_v0.py", 1)])
def test_tpu_facts_that_set_precision_3x_bind(shipped_facts, space_id,
                                              count):
    """The facts whose one knob outside the port's rulings was
    ``precision_3x`` (102 of the five DG spaces') build at ``bf16_3x``;
    those with a j-dot plan onto ``dg_rows_3xtf32``."""
    n = 0
    for e, q in shipped_facts.get(space_id, []):
        params = dict(q.transform_params)
        if not params.get("precision_3x") or any(
                params.get(k) for k in ("fold", "preblock", "mfold",
                                        "lane_pack_g")):
            continue
        prog = q.transform(ft.generate_program(e))
        assert prog.descriptor.precision == "bf16_3x"
        ft.build_executable(prog, long_dim_length=8, device="cpu")
        if _common.has_dg_dot(e):
            assert plan_cuda_launch(prog, get_index_lengths(
                prog.einsum, 8 * prog.descriptor.rowcat)).kernel \
                == "dg_rows_3xtf32"
        n += 1
    assert n == count



@pytest.mark.parametrize("space_id,built,fold,mfold,smem", [
    ("dg_div_v0.py", 21, 3, 0, 0), ("dg_grad_v0.py", 14, 2, 0, 0),
    ("face_mass_v0.py", 2, 0, 0, 0), ("mass_v0.py", 33, 2, 2, 25)])
def test_tpu_lane_pack_facts_bind(shipped_facts, space_id, built, fold,
                                  mfold, smem):
    """The 104 shipped facts that set ``lane_pack_g``: each builds, the DG
    ones onto ``lane_pack_dg_f32`` (``lane_pack_dg_3xtf32`` with
    ``precision_3x``) and the packed matvecs and vecmats onto
    ``dg_rows_f32`` (``dg_rows_3xtf32``), or raises naming ``fold``,
    ``mfold`` or shared memory (a packed matvec whose kron resident exceeds
    a Hopper block's)."""
    counts = {"built": 0, "fold": 0, "mfold": 0, "smem": 0}
    for e, q in shipped_facts.get(space_id, []):
        params = dict(q.transform_params)
        if not params.get("lane_pack_g"):
            continue
        try:
            prog = q.transform(ft.generate_program(e))
            ft.build_executable(prog, long_dim_length=64, device="cpu")
        except ft.InvalidParameterError as err:
            key = ("mfold" if "mfold" in str(err) else "fold"
                   if "fold" in str(err) else "smem"
                   if "shared memory" in str(err) else str(err))
            counts[key] += 1
            continue
        counts["built"] += 1
        kernel = plan_cuda_launch(prog, stored_lengths(
            prog, get_index_lengths(prog.einsum, 64))).kernel
        family = "dg_rows" if space_id == "mass_v0.py" else "lane_pack_dg"
        assert kernel == family + ("_3xtf32" if params.get("precision_3x")
                                   else "_f32"), (params, kernel)
    assert counts == {"built": built, "fold": fold, "mfold": mfold,
                      "smem": smem}

# }}}


# {{{ outputs against the reference's

def _run_reference(r, ref_prog, length, seed):
    stored = ref_apply_layouts(ref_prog, ref_generate_input_arrays(
        r, long_dim_length=length, seed=seed, as_numpy=True))
    fn = fr.build_executable(ref_prog, long_dim_length=length)
    return [np.asarray(o) for o in fn(stored)]


def _run_port(e, prog, length, seed):
    arrays = apply_layouts(prog, generate_input_arrays(
        e, long_dim_length=length, seed=seed, device="cpu"))
    fn = ft.build_executable(prog, long_dim_length=length, device="cpu")
    return [o.numpy() for o in fn(arrays)]


OUTPUT_CASES = [
    ("mass_v0", "vecmat", dict(dofmajor=True)),
    ("mass_v0", "vecmat", dict(dofmajor=False)),
    ("mass_v0", "rowsum", dict(dofmajor=True)),
    ("mass_v0", "rowsum", dict(dofmajor=False)),
    ("curl_3d_v0", "curl", dict(prereduce=True)),
    ("curl_3d_v0", "curl", dict(prereduce=True, rowcat=True)),
    ("dg_div_v0", "div_b3", dict(rowcat=True)),
    ("dg_div_v0", "div_b3", dict(rowcat=True, dofmajor=False)),
    ("dg_div_v0", "div_b3", dict(rowcat=True, precision_3x=True)),
    ("elementwise_v1", "scale_flat", dict(flatten=True)),
]


@pytest.mark.parametrize("space,key,params", OUTPUT_CASES, ids=[
    f"{s}-{k}-{'-'.join(f'{a}{int(b)}' for a, b in p.items())}"
    for s, k, p in OUTPUT_CASES])
def test_outputs_match_reference(space, key, params):
    e = ROWS[space][key]
    r = to_reference(e)
    full = S.space_point(space, e, log2_block=8, **params)
    ref_full = {k: full.get(k, False)
                for k in ref_space(space).get_param_space(r)}
    ref_prog = ref_space(space).bind_args(r, **ref_full)(
        fr.generate_program(r))
    prog = get_transform_func_from_module_path(space).bind_args(
        e, **full)(ft.generate_program(e))
    assert prog.descriptor.block_long >= E * prog.descriptor.rowcat
    kernels.reset_launch_counts()
    got = _run_port(e, prog, E, SEED)
    want = _run_reference(r, ref_prog, E, SEED)
    assert len(got) == len(want) == (1 if prog.descriptor.rowcat > 1
                                     else e.b)
    for g, w in zip(got, want):
        assert_close(g, w)
    assert not any(kernels.launch_counts.values())
    ft.validate_batched_einsum_transform(
        e, get_transform_func_from_module_path(space).bind_args(e, **full),
        long_dim_length=E)


@pytest.mark.parametrize("key,length,log2_chunk,opt", [
    ("div_b3", 1000, 7, True), ("grad", 333, 5, False),
    ("div_f64", 1001, 9, True)])
def test_xla_chunks_match_reference(key, length, log2_chunk, opt):
    """``log2_chunk`` > 0 on a length that leaves a ragged last chunk."""
    e = ROWS["xla_v0"][key]
    r = to_reference(e)
    params = dict(use_opt_path=opt, precision_idx=1, log2_chunk=log2_chunk)
    assert length % (1 << log2_chunk)
    prog = get_transform_func_from_module_path("xla_v0").bind_args(
        e, **params)(ft.generate_program(e))
    assert prog.descriptor.xla_block_long == 1 << log2_chunk
    ref_prog = ref_space("xla_v0").bind_args(r, **params)(
        fr.generate_program(r))
    rtol = 1e-12 if "f64" in key else 2e-5
    for g, w in zip(_run_port(e, prog, length, SEED),
                    _run_reference(r, ref_prog, length, SEED)):
        assert_close(g, w, rtol=rtol)


def test_rowcat_storage_contract():
    """``apply_layouts`` stacks the rows' streamed operands as the
    reference's does, and ``unpack_output`` gives the rows back."""
    e = ROWS["dg_div_v0"]["div_b3"]
    r = to_reference(e)
    params = S.space_point("dg_div_v0", e, rowcat=True)
    prog = get_transform_func_from_module_path("dg_div_v0").bind_args(
        e, **params)(ft.generate_program(e))
    ref_prog = ref_space("dg_div_v0").bind_args(
        r, **{k: params.get(k, False) for k in ref_space(
            "dg_div_v0").get_param_space(r)})(fr.generate_program(r))
    logical = generate_input_arrays(e, long_dim_length=E, seed=SEED,
                                    as_numpy=True)
    ours = apply_layouts(prog, logical)
    ref = ref_apply_layouts(ref_prog, dict(logical))
    assert sorted(ours) == sorted(ref)
    for name in ours:
        np.testing.assert_array_equal(ours[name], np.asarray(ref[name]))
    (out,) = ft.build_executable(prog, long_dim_length=E, device="cpu")(
        arrays_from_numpy(ours, "cpu"))
    rows = ft.unpack_output(prog, out, (E, 6))
    assert rows.shape == (3, E, 6)
    subs = e.get_subscripts().replace(" ", "")
    for k, row in enumerate(e.args):
        assert_close(rows[k].numpy(), np.einsum(
            subs, *[logical[a.name].astype(np.float64) for a in row]))


@pytest.mark.parametrize("name,space", [("dg_curl_ndof6", "curl_3d_v0"),
                                        ("vecmat_ndof5", "mass_v0")])
def test_row_through_the_archive(tmp_path, name, space):
    """tune -> archive -> candidate_transforms -> replay on CPU (host
    timings under the key ``cpu``), the seeds measured first; the replay's
    output equals the reference's for the same fact."""
    e = {"dg_curl_ndof6": S.make_curl(6), "vecmat_ndof5": _vecmat(5)}[name]
    r = to_reference(e)
    db = str(tmp_path / "f32.sqlite")
    seeds = [S.space_point(space, e, prereduce=True)
             if space == "curl_3d_v0" else S.space_point(space, e),
             S.space_point(space, e, log2_block=10)]
    ft.autotune(e, space, db_path=db, device="cpu", long_dim_length=500,
                test_limit=3, seed_configs=seeds)
    facts = ft.query(e, "cpu", db_path=db)
    assert len(facts) == 3 and {q.device_name for q in facts} == {"cpu"}
    assert {q.transform_id for q in facts} == {f"{space}.py"}
    measured = [dict(q.transform_params) for q in facts]
    assert all(s in measured for s in seeds)
    winner = next(S.candidate_transforms(name, e, db_path=db, device="cpu"))
    assert winner.fact is not None \
        and winner.fact.transform_id == f"{space}.py"
    ft.validate_batched_einsum_transform(e, winner.transform,
                                         long_dim_length=E)
    prog = winner.transform(ft.generate_program(e))
    params = dict(winner.fact.transform_params)
    ref_prog = ref_space(space).bind_args(r, **params)(
        fr.generate_program(r))
    ref_prog = ref_prog.with_descriptor(block_long=max(
        ref_prog.descriptor.block_long, E * ref_prog.descriptor.rowcat))
    got = _run_port(e, prog, E, SEED)
    want = _run_reference(r, ref_prog, E, SEED)
    for g, w in zip(got, want):
        assert_close(g, w)


def test_hoisted_results_are_shared_across_rows():
    """curl with ``prereduce``: one hoisted ``rij->ij`` serves the three
    rows, and each row is mass-shaped (S = 1)."""
    from feinsum_tpu_torch.ops.cuda_emitter import hoist_resident_steps
    e = S.make_curl(6)
    prog = get_transform_func_from_module_path("curl_3d_v0").bind_args(
        e, **S.space_point("curl_3d_v0", e, prereduce=True))(
        ft.generate_program(e))
    kernel_prog, host_steps = hoist_resident_steps(prog)
    assert [(h.result, h.subscripts) for h in host_steps] == [
        ("_host0", "rij->ij")]
    assert kernel_prog.einsum.get_subscripts() == "e,ij,ej -> ei"
    plan = plan_cuda_launch(prog, get_index_lengths(e, E))
    rows = plan.operands(apply_layouts(prog, generate_input_arrays(
        e, long_dim_length=E, seed=SEED, device="cpu")))
    assert [tuple(row.R.shape) for row in rows] == [(1, 6, 6)] * 3
    assert len({row.R.data_ptr() for row in rows}) == 1
    unhoisted = prog.with_descriptor(hoist_resident_steps=False)
    assert hoist_resident_steps(unhoisted) == (unhoisted, ())
    assert ScheduleDescriptor().hoist_resident_steps
    for g, w in zip(_run_port(e, prog, E, SEED),
                    _run_port(e, unhoisted, E, SEED)):
        assert_close(g, w)

# }}}

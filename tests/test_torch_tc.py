"""The TCCG dense tensor-contraction slice of the port held to the JAX
package on CPU: the TCCG table, the nested storage layouts, the op and byte
models without a long axis, every TC transform space's descriptor and
outputs (the JAX side runs ``tc_pallas_v0``/``v1`` through its K2,
``_build_multigrid``, in Pallas interpret mode; the port's CPU tensors run
``tc_grid_plain``), the shipped archive's TPU facts of the two K2 spaces,
and the archive path (autotune -> query -> candidate ladder -> replay) on a
small dense contraction.  Inputs come from one numpy seed; the tolerance is
the float32 oracle's, 2e-5 of max|ref|."""

from __future__ import annotations

import itertools
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import feinsum_tpu as fr
import feinsum_tpu_torch as ft
from feinsum_tpu.codegen.program import \
    generate_program_with_opt_einsum_schedule as ref_opt_program
from feinsum_tpu.measure import (
    apply_layouts as ref_apply_layouts,
    generate_input_arrays as ref_generate_input_arrays,
)
from feinsum_tpu.ops.layouts import (
    apply_nested_layout as ref_apply_nested_layout,
    dofmajor_layouts as ref_dofmajor_layouts,
    unpack_output as ref_unpack_output,
)
from feinsum_tpu.tuning import get_transform_func_from_module_path as ref_space
from feinsum_tpu_torch import sql_utils, suite as S, utils
from feinsum_tpu_torch.codegen.program import get_index_lengths, \
    stored_lengths
from feinsum_tpu_torch.interop import (
    arrays_from_numpy,
    einsum_from_reference,
    program_from_reference,
)
from feinsum_tpu_torch.measure import apply_layouts, generate_input_arrays
from feinsum_tpu_torch.ops import kernels
from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
from feinsum_tpu_torch.ops.layouts import apply_nested_layout
from feinsum_tpu_torch.ops.tc_emitter import plan_tc_launch
from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

RTOL = 2e-5
SEED = 11
SHIPPED = (Path(__file__).resolve().parents[1] / "feinsum_tpu" / "data"
           / "transform_archive_v1_tpu.sqlite")
TPU = "TPU_v5_lite"

# the small dense contractions of the JAX package's own TC tests
EINSUMS = {
    "tccg35_small": ("dfgb,geac->abcdef", (6, 4, 5, 7), (5, 8, 9, 10)),
    "tccg02_small": ("dca,bd->abc", (6, 8, 4), (5, 6)),
    "blocked_m": ("dma,bd->mab", (6, 4, 5), (8, 6)),
}
SPACES = ("tc_pallas_v0", "tc_pallas_v1", "tc_xla_v0", "ttgt_v0", "ttgt_v1",
          "tc_gemm_v0")
FIELDS = ("grid_index", "grid_blocks", "grid_m", "arg_layouts", "out_layout",
          "pre_layouts", "pre_out_layout", "bind_lengths")
# what the reference refuses for the TPU alone (VMEM, Mosaic, unrolling)
TPU_GUARDS = ("VMEM", "Mosaic", "unroll", "last-two", "carries M, K and N",
              "MiB")
# what the port refuses by its rulings: the fold-8 storage, and a resident
# factor over a Hopper block's shared memory
PORT_RULINGS = ("fold", "shared memory")


def make_pair(key):
    subs, sa, sb = EINSUMS[key]
    ours = ft.einsum(subs, ft.array("A", sa, "float32"),
                     ft.array("B", sb, "float32"))
    ref = fr.einsum(subs, fr.array("A", sa, "float32"),
                    fr.array("B", sb, "float32"))
    return ours, ref


def assert_close(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale)


# {{{ utils: the TCCG table and the helpers

@pytest.mark.parametrize("i", range(1, 49))
def test_tccg_table_matches_reference(i):
    ours = ft.get_tccg_benchmark(i, dtype="float32")
    ref = fr.get_tccg_benchmark(i, dtype="float32")
    assert ours == einsum_from_reference(ref)
    assert ours.get_subscripts() == ref.get_subscripts()
    assert ft.canonicalize_einsum(ours) == einsum_from_reference(
        fr.canonicalize_einsum(ref))
    assert ft.canonical_operand_positions(ours) == \
        fr.canonicalization.canonical_operand_positions(ref)
    assert utils.get_n_redn_dim(ours) == fr.utils.get_n_redn_dim(ref)
    assert not utils.is_any_redn_dim_parametric(ours)


def test_tccg_helpers():
    import doctest
    assert not doctest.testmod(utils).failed
    with pytest.raises(ValueError):
        ft.get_tccg_benchmark(49)
    assert ft.get_tccg_benchmark(3).arg_to_dtype["A"] == np.float64
    assert [name for name, _ in S.tccg_suite()] == [
        f"tccg_{i:02d}" for i in S.TCCG_SAMPLE]
    mass = S.make_mass(5)
    assert utils.is_any_redn_dim_parametric(S.make_grad(4)) is False
    assert utils.get_n_redn_dim(mass) == 1
    e = ft.einsum("ej->j", ft.array("A", ("E", 5), "float32"))
    assert utils.is_any_redn_dim_parametric(e)

# }}}


# {{{ layouts and the measurement models without a long axis

@pytest.mark.parametrize("nested", [((1, 2, 3), (0,)), ((0,), (3, 1), (2,)),
                                    ((3, 2, 1, 0),)])
def test_nested_layout_matches_reference(nested):
    a = np.random.default_rng(SEED).random((2, 3, 4, 5), dtype=np.float32)
    want = ref_apply_nested_layout(a, nested)
    got_np = apply_nested_layout(a, nested)
    got_t = apply_nested_layout(torch.from_numpy(a), nested)
    assert got_np.flags.c_contiguous and got_t.is_contiguous()
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    with pytest.raises(ValueError):
        apply_nested_layout(a, ((0, 1),))


def test_unpack_output_undoes_pre_out_layout():
    e, r = make_pair("tccg35_small")
    params = dict(log2_block=8, backend_pallas=False, precision_idx=0,
                  swap=False)
    prog = get_transform_func_from_module_path("tc_gemm_v0").bind_args(
        e, **params)(ft.generate_program(e))
    ref_prog = ref_space("tc_gemm_v0").bind_args(
        r, **params, dofmajor=False, fold=False, vmem_idx=2)(
        fr.generate_program(r))
    out = np.random.default_rng(SEED).random(
        tuple(dict(prog.descriptor.bind_lengths).values())
        + (int(np.prod([e.index_to_dim_length[ix] for ix in "bdf"])),),
        dtype=np.float32)
    logical = tuple(e.index_to_dim_length[ix] for ix in e.out_idx_set)
    np.testing.assert_array_equal(
        ft.unpack_output(prog, torch.from_numpy(out), logical).numpy(),
        ref_unpack_output(ref_prog, out, logical))


@pytest.mark.parametrize("i", [2, 12, 21, 35])
def test_op_and_byte_models_without_a_long_axis(i):
    ours = ft.get_tccg_benchmark(i, dtype="float32")
    ref = fr.get_tccg_benchmark(i, dtype="float32")
    assert {k: float(v) for k, v in ft.get_giga_op_map(ours).items()} == \
        {k: float(v) for k, v in fr.get_giga_op_map(ref).items()}
    assert ft.get_footprint_gbytes(ours, long_dim_length=7) == \
        fr.get_footprint_gbytes(ref, long_dim_length=7)
    rate = ft.get_roofline_flop_rate(ours, "NVIDIA_H100_80GB_HBM3")
    gflop = float(ft.get_giga_op_map(ours)["float32"])
    gbytes = ft.get_footprint_gbytes(ours, long_dim_length=1)
    assert rate == pytest.approx(
        gflop / max(gflop / 67_000.0, gbytes / 3_350.0), rel=1e-12)

# }}}


# {{{ the transform spaces: descriptors and outputs against the reference

def _sample_params(space: dict, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    names = sorted(space)
    out = []
    for _ in range(n):
        out.append({k: space[k].sample(rng) for k in names})
    return out


@pytest.mark.parametrize("key", sorted(EINSUMS))
@pytest.mark.parametrize("space", SPACES)
def test_descriptor_parity(space, key):
    e, r = make_pair(key)
    ours = get_transform_func_from_module_path(space)
    ref = ref_space(space)
    ref_params = ref.get_param_space(r)
    # the port's space is the reference's, less knobs with no effect on
    # Hopper; its ranges lie inside the reference's
    for k, p in ours.get_param_space(e).items():
        assert k in ref_params
        if hasattr(p, "low"):
            assert ref_params[k].low <= p.low <= p.high <= ref_params[k].high
    n_compared = 0
    for params in _sample_params(ref_params, 120, seed=len(space)):
        try:
            want = program_from_reference(
                ref.bind_args(r, **params)(fr.generate_program(r)))
        except fr.InvalidParameterError as err:
            want = err
        try:
            got = ours.bind_args(e, **params)(ft.generate_program(e))
        except ft.InvalidParameterError as err:
            got = err
        if isinstance(want, Exception) and isinstance(got, Exception):
            continue
        if isinstance(got, Exception):
            assert any(w in str(got) for w in PORT_RULINGS), (params, got)
            continue
        if isinstance(want, Exception):
            assert any(w in str(want) for w in TPU_GUARDS), (params, want)
            ft.build_executable(got, device="cpu")
            continue
        for name in FIELDS:
            assert getattr(got.descriptor, name) == \
                getattr(want.descriptor, name), (name, params)
        assert got.schedule == want.schedule
        assert got.descriptor.backend == want.descriptor.backend
        n_compared += 1
    assert n_compared > 0


def _run_reference(r, ref_prog, seed):
    stored = ref_apply_layouts(ref_prog, ref_generate_input_arrays(
        r, long_dim_length=100, seed=seed, as_numpy=True))
    outs = fr.build_executable(ref_prog, long_dim_length=100)(stored)
    return [np.asarray(ref_unpack_output(ref_prog, np.asarray(o),
                                         tuple(int(d) for d in r.shape)))
            for o in outs]


def _run_port(e, prog, seed):
    arrays = apply_layouts(prog, generate_input_arrays(
        e, long_dim_length=100, seed=seed, device="cpu"))
    outs = ft.build_executable(prog, long_dim_length=100, device="cpu")(
        arrays)
    return [ft.unpack_output(prog, o, tuple(int(d) for d in e.shape)).numpy()
            for o in outs]


OUTPUT_CASES = [
    ("tc_pallas_v0", "tccg35_small", dict(n_grid=3, precision_idx=0,
                                          use_opt_path=False)),
    ("tc_pallas_v0", "tccg35_small", dict(n_grid=2, precision_idx=0,
                                          use_opt_path=True)),
    ("tc_pallas_v0", "tccg02_small", dict(n_grid=1, precision_idx=0,
                                          use_opt_path=False)),
] + [
    ("tc_pallas_v1", "tccg02_small",
     dict(n_grid=1, blk0_idx=blk, blk1_idx=0, m_pos=m_pos, mstack=mstack,
          precision_idx=0, use_opt_path=False))
    for m_pos, mstack, blk in ((2, False, 0), (2, True, 1), (1, False, 1),
                               (2, True, 2))
] + [
    ("tc_pallas_v1", "blocked_m", dict(n_grid=1, blk0_idx=1, blk1_idx=0,
                                       m_pos=0, mstack=mstack,
                                       precision_idx=0, use_opt_path=False))
    for mstack in (False, True)
] + [
    ("tc_xla_v0", key, dict(use_opt_path=opt, precision_idx=p))
    for key, opt, p in (("tccg35_small", True, 0), ("tccg02_small", False, 1))
] + [
    ("ttgt_v0", "tccg35_small", dict(perm_a=5, perm_b=17, perm_out=301,
                                     precision_idx=1, natural_out=nat))
    for nat in (0, 1)
] + [
    ("ttgt_v1", "tccg02_small", dict(layout_a=(1, 0), layout_b=(2, 0, 1),
                                     layout_out=(1, 2, 0), precision_idx=0,
                                     natural_out=nat))
    for nat in (0, 1)
] + [
    ("tc_gemm_v0", "tccg35_small",
     dict(log2_block=10, blkc128=0, backend_pallas=pallas, precision_idx=0,
          swap=swap, dofmajor=dofmajor, fold=False, vmem_idx=2))
    for pallas, swap, dofmajor in ((False, False, False), (False, True, False),
                                   (True, False, True), (True, True, False))
]


@pytest.mark.parametrize("space,key,params", OUTPUT_CASES,
                         ids=[f"{s}-{k}-{i}" for i, (s, k, _)
                              in enumerate(OUTPUT_CASES)])
def test_outputs_match_reference(space, key, params):
    e, r = make_pair(key)
    ref_prog = ref_space(space).bind_args(r, **params)(fr.generate_program(r))
    prog = get_transform_func_from_module_path(space).bind_args(
        e, **params)(ft.generate_program(e))
    kernels.reset_launch_counts()
    (got,) = _run_port(e, prog, SEED)
    (want,) = _run_reference(r, ref_prog, SEED)
    assert_close(got, want)
    ft.validate_batched_einsum_transform(
        e, get_transform_func_from_module_path(space).bind_args(e, **params),
        device="cpu")
    assert not any(kernels.launch_counts.values())


def test_reference_k2_programs_carry_across():
    """The reference's own ``tc_pallas_v1`` program, carried across field by
    field, plans onto ``tc_grid_f32`` and gives the reference's output."""
    e, r = make_pair("tccg35_small")
    ref_prog = ref_space("tc_pallas_v1").bind_args(
        r, n_grid=4, blk0_idx=2, blk1_idx=1, m_pos=5, mstack=True,
        precision_idx=0, use_opt_path=False)(fr.generate_program(r))
    prog = program_from_reference(ref_prog).with_descriptor(
        vmem_limit_bytes=None)
    plan = plan_tc_launch(prog, get_index_lengths(e, 1))
    stored = ref_apply_layouts(ref_prog, ref_generate_input_arrays(
        r, long_dim_length=1, seed=SEED, as_numpy=True))
    (want,) = fr.build_executable(ref_prog, long_dim_length=1)(stored)
    (got,) = plan.run(plan.operands(arrays_from_numpy(stored, "cpu")))
    assert plan.kernel == "tc_grid_f32"
    assert_close(got.numpy(), np.asarray(want))

# }}}


# {{{ rulings

def test_rulings_on_the_multigrid_fields():
    e, _ = make_pair("tccg35_small")
    v1 = get_transform_func_from_module_path("tc_pallas_v1")
    prog = v1.bind_args(e, n_grid=1, blk0_idx=1, blk1_idx=0, m_pos=5,
                        precision_idx=0)(ft.generate_program(e))
    # bf16_3x (a TPU fact's precision_idx 1) binds: the same tables on
    # tc_grid_3xtf32
    p3x = v1.bind_args(e, n_grid=1, blk0_idx=1, blk1_idx=0, m_pos=5,
                       precision_idx=1)(ft.generate_program(e))
    assert p3x.descriptor == prog.descriptor.copy(precision="bf16_3x")
    lengths = get_index_lengths(e, 1)
    arrays = apply_layouts(prog, generate_input_arrays(e, long_dim_length=1,
                                                       seed=SEED,
                                                       device="cpu"))
    plan3x = plan_tc_launch(p3x, lengths)
    assert plan3x.kernel == "tc_grid_3xtf32"
    assert_close(plan3x.run(plan3x.operands(arrays))[0].numpy(),
                 plan_tc_launch(prog, lengths).run(plan_tc_launch(
                     prog, lengths).operands(arrays))[0].numpy())
    # mstack moves nothing: the same plan and output
    outs = [plan_tc_launch(p, lengths).run(plan_tc_launch(
        p, lengths).operands(arrays))[0] for p in
        (prog, prog.with_descriptor(mstack=True))]
    assert torch.equal(outs[0], outs[1])
    # the plain route ignores the grid fields, as the reference's XLA route
    (xla,) = ft.build_executable(prog.with_descriptor(backend="xla"))(arrays)
    assert_close(outs[0].numpy(), xla.numpy())
    for change in ({"dd_pairs": True}, {"grid_index": None},
                   {"grid_index": ("a", "g")},
                   {"grid_blocks": (("a", 4),)},
                   {"grid_blocks": (("b", 4),)},
                   {"grid_m": "g"}, {"vmem_limit_bytes": 2 ** 20},
                   {"fold_long": 8}):
        with pytest.raises(ft.InvalidParameterError):
            ft.build_executable(prog.with_descriptor(**change))
    # a dense contraction of three operands has a two-step schedule: it
    # runs per cell on tc_steps_f32 and gives the reference's K2 output
    e3 = ft.einsum("ab,bc,cd->abd", *[ft.array(n, (3, 4), "float32")
                                      if n == "A" else
                                      ft.array(n, (4, 4), "float32")
                                      for n in "ABC"])
    r3 = fr.einsum("ab,bc,cd->abd", *[fr.array(n, (3, 4), "float32")
                                      if n == "A" else
                                      fr.array(n, (4, 4), "float32")
                                      for n in "ABC"])
    p3 = ft.generate_program_with_opt_einsum_schedule(e3).with_descriptor(
        backend="pallas", grid_index=("a",))
    ref_p3 = fr.generate_program_with_opt_einsum_schedule(
        r3).with_descriptor(backend="pallas", grid_index=("a",))
    assert p3 == program_from_reference(ref_p3)
    assert p3.schedule.nsteps == 2
    assert plan_tc_launch(p3, get_index_lengths(e3, 1)).kernel \
        == "tc_steps_f32"
    (got,) = _run_port(e3, p3, SEED)
    (want,) = _run_reference(r3, ref_p3, SEED)
    assert_close(got, want)


def test_builtin_default_grids_a_dense_contraction_as_the_reference():
    """The built-in default on a fully concrete contraction used to raise
    (the fused route took one long axis only); it now grids as the
    reference's K1 does,
    over the longest output letter when that is at least 2048 long, else
    in one block, on ``step_block_f32``, and matches the JAX package's K1
    on the same program (interpret mode, one grid step) within 2e-5."""
    e, r = make_pair("tccg02_small")
    (only,) = S.candidate_transforms("tccg02", e, device="cpu",
                                     db_path="/nonexistent/x.sqlite")
    prog = only.transform(ft.generate_program(e))
    assert plan_cuda_launch(prog, get_index_lengths(
        e, 1)).kernel == "step_block_f32"
    layouts, out_perm = ref_dofmajor_layouts(r)
    ref_prog = ref_opt_program(r)
    ref_prog = ref_prog.copy(descriptor=ref_prog.descriptor.copy(
        backend="pallas", block_long=S.BLOCK_LONG,
        dimension_semantics="parallel", arg_layouts=layouts,
        out_layout=out_perm))
    assert program_from_reference(ref_prog) == prog
    (want,) = _run_reference(r, ref_prog, SEED)
    (got,) = _run_port(e, prog, SEED)
    assert_close(got, want)


def test_tc_gemm_resident_factor_over_shared_memory_runs_on_probe_apply():
    """A ``tc_gemm_v0`` point whose resident factor exceeds
    ``dg_rows_f32``'s shared memory used to raise; it now runs on
    ``probe_apply_f32``,
    whose ring streams the factor, and matches the JAX package's K1 on
    the same point (interpret mode, one grid step) within 2e-5.  The
    fold-8 storage stays a ruling."""
    e = ft.einsum("ik,kj->ij", ft.array("A", (64, 400), "float32"),
                  ft.array("B", (400, 300), "float32"))
    r = fr.einsum("ik,kj->ij", fr.array("A", (64, 400), "float32"),
                  fr.array("B", (400, 300), "float32"))
    params = dict(log2_block=8, backend_pallas=True, precision_idx=0,
                  swap=False)
    tr = get_transform_func_from_module_path("tc_gemm_v0").bind_args(
        e, **params)
    prog = tr(ft.generate_program(e))
    assert plan_cuda_launch(prog, stored_lengths(prog, get_index_lengths(
        prog.einsum, 1))).kernel == "probe_apply_f32"
    ref_prog = ref_space("tc_gemm_v0").bind_args(r, **params)(
        fr.generate_program(r))
    ref_prog = ref_prog.copy(descriptor=ref_prog.descriptor.copy(
        block_long=2 ** 20))
    (want,) = _run_reference(r, ref_prog, SEED)
    (got,) = _run_port(e, prog, SEED)
    assert_close(got, want)
    with pytest.raises(ft.InvalidParameterError, match="fold"):
        get_transform_func_from_module_path("tc_gemm_v0").bind_args(
            e, log2_block=8, backend_pallas=True, precision_idx=0,
            swap=True, dofmajor=True, fold=True)(ft.generate_program(e))

# }}}


# {{{ the shipped archive's TPU facts and the archive path

@pytest.fixture
def archive(tmp_path):
    db = tmp_path / "archive.sqlite"
    shutil.copy(SHIPPED, db)
    return str(db)


@pytest.mark.parametrize("space_id,count", [("tc_pallas_v0.py", 8),
                                            ("tc_pallas_v1.py", 67)])
def test_tpu_facts_bind_and_plan(archive, space_id, count):
    n = 0
    for e in sql_utils.get_timed_einsums_in_db(db_path=archive):
        for q in sql_utils.query(e, ft.FakeDevice(TPU), db_path=archive,
                                 err_if_no_results=False):
            if q.transform_id != space_id:
                continue
            pt = get_transform_func_from_module_path(space_id)
            params = dict(q.transform_params)
            for idx, kernel in ((0, "tc_grid_f32"), (1, "tc_grid_3xtf32")):
                prog = pt.bind_args(e, **{**params, "precision_idx": idx})(
                    ft.generate_program(e))
                plan = plan_tc_launch(prog, get_index_lengths(e, 1))
                assert plan.kernel == kernel
            n += 1
    assert n == count


# facts that set bf16_3x, by space, and the index that is bf16_3x
BF16_3X_FACTS = {"tc_xla_v0.py": (134, 2), "ttgt_v0.py": (127, 2),
                 "tc_pallas_v1.py": (44, 1), "tc_gemm_v0.py": (32, 1),
                 "ttgt_v1.py": (12, 2), "tc_pallas_v0.py": (4, 1)}


@pytest.mark.parametrize("space_id", sorted(BF16_3X_FACTS))
def test_tpu_facts_that_set_bf16_3x_bind(archive, space_id):
    """The shipped facts that set ``bf16_3x`` (353 of the six TC spaces')
    bind and build at that precision but four of ``tc_gemm_v0`` that also
    set ``fold``, which raise naming it; four whose resident factor (R
    split into hi and lo) exceeds a Hopper block of ``dg_rows_3xtf32`` go
    to ``probe_apply_3xtf32``, whose ring streams R (they used to raise
    naming the shared memory)."""
    count, index = BF16_3X_FACTS[space_id]
    n = n_fold = n_smem = n_apply = 0
    for e in sql_utils.get_timed_einsums_in_db(db_path=archive):
        for q in sql_utils.query(e, ft.FakeDevice(TPU), db_path=archive,
                                 err_if_no_results=False):
            if q.transform_id != space_id \
                    or dict(q.transform_params)["precision_idx"] != index:
                continue
            n += 1
            try:
                prog = q.transform(ft.generate_program(e))
            except ft.InvalidParameterError as err:
                if "shared memory" in str(err):
                    assert "dg_rows_3xtf32" in str(err)
                    n_smem += 1
                    continue
                assert "fold" in str(err) and dict(q.transform_params)["fold"]
                n_fold += 1
                continue
            assert prog.descriptor.precision == "bf16_3x"
            ft.build_executable(prog, device="cpu")
            if prog.descriptor.backend == "pallas" \
                    and not isinstance(prog.descriptor.grid_index, tuple):
                n_apply += plan_cuda_launch(prog, stored_lengths(
                    prog, get_index_lengths(prog.einsum, 1))).kernel \
                    == "probe_apply_3xtf32"
    assert n == count
    assert n_fold == n_apply == (4 if space_id == "tc_gemm_v0.py" else 0)
    assert n_smem == 0


def test_shipped_tc_gemm_facts_match_reference(archive):
    """Every shipped ``tc_gemm_v0`` fact (83) but the six that set ``fold``
    (four of them at ``bf16_3x``), a ruling, builds; the 17 on the fused
    route, the four whose resident factor exceeds ``dg_rows_3xtf32``'s
    shared memory (which used to raise) among them, run on the CPU against
    the JAX package's output of the same fact (its K1 in interpret mode,
    its block raised to one grid step, ROADMAP fault F3) within 2e-5."""
    n_built = n_fold = n_run = n_apply = 0
    for e in sql_utils.get_timed_einsums_in_db(db_path=archive):
        for q in sql_utils.query(e, ft.FakeDevice(TPU), db_path=archive,
                                 err_if_no_results=False):
            if q.transform_id != "tc_gemm_v0.py":
                continue
            params = dict(q.transform_params)
            if params["fold"]:
                with pytest.raises(ft.InvalidParameterError, match="fold"):
                    q.transform(ft.generate_program(e))
                n_fold += 1
                continue
            prog = q.transform(ft.generate_program(e))
            ft.build_executable(prog, device="cpu")
            n_built += 1
            if not params["backend_pallas"]:
                continue
            n_apply += plan_cuda_launch(prog, stored_lengths(
                prog, get_index_lengths(prog.einsum, 1))).kernel \
                .startswith("probe_apply")
            r = fr.batched_einsum(e.get_subscripts(), [[
                fr.array(a.name, tuple(int(d) for d in a.shape), a.dtype)
                for a in row] for row in e.args])
            ref_prog = ref_space("tc_gemm_v0").bind_args(r, **params)(
                fr.generate_program(r))
            ref_prog = ref_prog.copy(descriptor=ref_prog.descriptor.copy(
                block_long=2 ** 20))
            (want,) = _run_reference(r, ref_prog, SEED)
            (got,) = _run_port(e, prog, SEED)
            assert_close(got, want)
            n_run += 1
    assert (n_built, n_fold, n_run, n_apply) == (77, 6, 17, 4)


def test_archive_path_on_cpu(tmp_path):
    """autotune -> query -> candidate ladder -> replay -> validate, on CPU
    (host timings under the key ``cpu``), and the replay's output equals
    the reference's for the same fact."""
    e, r = make_pair("tccg35_small")
    db = str(tmp_path / "tc.sqlite")
    seeds = [dict(n_grid=1, blk0_idx=0, blk1_idx=0, m_pos=5,
                  precision_idx=0),
             dict(n_grid=2, blk0_idx=2, blk1_idx=9, m_pos=4,
                  precision_idx=0)]
    ft.autotune(e, "tc_pallas_v1", db_path=db, device="cpu", test_limit=3,
                seed_configs=seeds)
    facts = ft.query(e, "cpu", db_path=db)
    assert len(facts) == 3 and {q.device_name for q in facts} == {"cpu"}
    assert {q.transform_id for q in facts} == {"tc_pallas_v1.py"}
    assert [dict(q.transform_params) for q in facts[:2]] == seeds
    winner = next(S.candidate_transforms("tccg35", e, db_path=db,
                                         device="cpu"))
    assert winner.fact is not None \
        and winner.fact.transform_id == "tc_pallas_v1.py"
    ft.validate_batched_einsum_transform(e, winner.transform, device="cpu")
    prog = winner.transform(ft.generate_program(e))
    assert isinstance(prog.descriptor.grid_index, tuple)
    (got,) = _run_port(e, prog, SEED)
    # the reference's plain route on the same inputs (the port's K2 points
    # include some that the reference's Mosaic guards refuse)
    ref_prog = ref_space("tc_xla_v0").bind_args(
        r, use_opt_path=False, precision_idx=1)(fr.generate_program(r))
    (want,) = _run_reference(r, ref_prog, SEED)
    assert_close(got, want)


def test_ttgt_replay_routes_canonical_positions(tmp_path):
    """Position-sensitive params (ttgt ``perm_a``/``perm_b``, tc_gemm_v0
    ``swap``) are archived against canonical operand positions and land on
    the user's operands, as in the reference (``dca,bd->abc`` canonicalizes
    with its operands exchanged)."""
    e = ft.einsum("dca,bd->abc", ft.array("T", (24, 16, 48), "float32"),
                  ft.array("U", (32, 24), "float32"))
    r = fr.einsum("dca,bd->abc", fr.array("T", (24, 16, 48), "float32"),
                  fr.array("U", (32, 24), "float32"))
    assert ft.canonical_operand_positions(e) == (1, 0)
    ce, rce = ft.canonicalize_einsum(e), fr.canonicalize_einsum(r)
    for space, params in (
            ("ttgt_v0", dict(perm_a=0, perm_b=1, perm_out=0, precision_idx=1,
                             natural_out=1)),
            ("tc_gemm_v0", dict(log2_block=9, blkc128=0, backend_pallas=False,
                                precision_idx=0, swap=False, dofmajor=False,
                                fold=False, vmem_idx=2))):
        tr = get_transform_func_from_module_path(space).bind_args(
            ce, **params)
        want = ref_space(space).bind_args(rce, **params)(
            fr.generate_program(r))
        got = tr(ft.generate_program(e))
        for name in FIELDS:
            assert getattr(got.descriptor, name) == \
                getattr(program_from_reference(want).descriptor, name)
        ft.validate_batched_einsum_transform(e, tr, device="cpu")
    db = str(tmp_path / "t.sqlite")
    sql_utils.record_facts(
        e, transform_id="ttgt_v0.py",
        transform_params={"perm_a": 1, "perm_b": 1, "perm_out": 1,
                          "precision_idx": 1},
        runtime_in_sec=1e-3, device="cpu", db_path=db)
    prog = sql_utils.retrieve(e, "cpu", db_path=db)(ft.generate_program(e))
    assert {n for n, _ in prog.descriptor.arg_layouts} == {"T", "U"}

# }}}


def test_space_knobs_change_the_kernel():
    """Every parameter the port's ``tc_pallas_v1`` searches changes the
    launched kernel: which kernel (``precision_idx``), its step (grid,
    blocks, row letter) or its tables."""
    e, _ = make_pair("tccg35_small")
    v1 = get_transform_func_from_module_path("tc_pallas_v1")
    base = dict(n_grid=2, blk0_idx=1, blk1_idx=1, m_pos=4, precision_idx=0)
    lengths = get_index_lengths(e, 1)

    def launched(params):
        """The kernel and what it is launched with: the row and column
        operands' stored letters, the tile variant, the sizes and the
        tables."""
        from feinsum_tpu_torch.ops.tc_emitter import tc_step
        prog = v1.bind_args(e, **params)(ft.generate_program(e))
        step, _ = tc_step(prog, lengths)
        shape = kernels.tc_classify(step)

        def strides(letters):
            return tuple(int(np.prod([lengths[x] for x in letters[k + 1:]]))
                         for k in range(len(letters)))
        tables, flags = kernels.tc_tables(step, strides(step.a),
                                          strides(step.b), strides(step.c))
        rows, cols = (step.b, step.a) if shape.swap else (step.a, step.b)
        return (plan_tc_launch(prog, lengths).kernel, rows, cols,
                shape.variant, shape.Mc, shape.Nc, shape.K, shape.ncells,
                flags, tables.tobytes())
    ref = launched(base)
    space = v1.get_param_space(e)
    assert set(space) == {"n_grid", "blk0_idx", "blk1_idx", "m_pos",
                          "precision_idx"}
    for k, p in space.items():
        assert p.low < p.high, k
        changed = []
        for v in range(p.low, p.high + 1):
            if v == base[k]:
                continue
            try:
                changed.append(launched({**base, k: v}) != ref)
            except ft.InvalidParameterError:
                continue
        assert any(changed), k
    # the accepted, unsearched knobs change nothing
    for extra in ({"mstack": True}, {"use_opt_path": True}):
        assert launched({**base, **extra}) == ref, extra


def test_every_rank3_sample_row_binds_a_v1_point():
    v1 = get_transform_func_from_module_path("tc_pallas_v1")
    for name, e in S.tccg_suite():
        ce = ft.canonicalize_einsum(e)
        ok = 0
        for n_grid, m_pos in itertools.product((1, 2), range(len(ce.shape))):
            try:
                prog = v1.bind_args(ce, n_grid=n_grid, blk0_idx=0,
                                    blk1_idx=0, m_pos=m_pos,
                                    precision_idx=0)(ft.generate_program(e))
            except ft.InvalidParameterError:
                continue
            plan_tc_launch(prog, get_index_lengths(e, 1))
            ok += 1
        assert (ok > 0) == (len(e.shape) >= 3), name

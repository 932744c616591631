"""The port's CUDA emitter (``feinsum_tpu_torch/ops/cuda_emitter.py``) and its
kernels' plain versions against the JAX package's Pallas emitter.

The reference programs are built by the JAX package itself, with the
built-in default transform and ``block_long >= E`` so that its Pallas
kernel runs in interpret mode on one grid step (Pallas interpret mode is
unreliable at grid >= 2 on CPU, ROADMAP fault F3).  They are carried
across with ``feinsum_tpu_torch.interop``; both packages get the same
seeded numpy inputs.  On CPU tensors the port's wrappers run the kernels'
plain versions; ``test_torch_kernels.py`` holds the kernels to their plain
versions on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import feinsum_tpu as fr
import feinsum_tpu_torch as ft
from feinsum_tpu.measure import (
    apply_layouts as ref_apply_layouts,
    generate_input_arrays as ref_generate_input_arrays,
)
from feinsum_tpu.ops.dd_emitter import _recognize_row
from feinsum_tpu.ops.layouts import dofmajor_layouts as ref_dofmajor_layouts
from feinsum_tpu_torch import suite as S
from feinsum_tpu_torch.codegen.program import get_index_lengths
from feinsum_tpu_torch.interop import arrays_from_numpy, \
    program_from_reference
from feinsum_tpu_torch.ops import kernels
from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
from feinsum_tpu_torch.ops.dg_rows import plan_row

E = 64
RTOL = 2e-5

# narrow widths where full width is not the point; one full-width div row
ROWS = {
    "div_ndof35": S.make_div(35),
    "div_ndof6": S.make_div(6),
    "grad_ndof7": S.make_grad(7),
    "face_ndof8": S.make_face_mass(8, 5),
    "mass_ndof9": S.make_mass(9),
    "matvec_ndof10": S.make_matvec(10),
    "copy_ndof5": S.make_copy(5),
    "curl_ndof6": S.make_curl(6),
}


def to_reference(e):
    def dim(d):
        return d.name if isinstance(d, ft.SizeParam) else d
    return fr.batched_einsum(e.get_subscripts(), [
        [fr.array(a.name, tuple(dim(d) for d in a.shape), a.dtype)
         for a in row] for row in e.args])


def reference_program(e, backend="pallas"):
    """The JAX package's built-in default program (``bench.py``'s
    ``default_transform``) at block_long = E: one grid step."""
    r = to_reference(e)
    layouts, out_perm = ref_dofmajor_layouts(r)
    return fr.generate_program_with_opt_einsum_schedule(r).with_descriptor(
        backend=backend, block_long=E, dimension_semantics="parallel",
        arg_layouts=layouts, out_layout=out_perm)


def run_both(ref_prog, seed=0):
    stored = ref_apply_layouts(ref_prog, ref_generate_input_arrays(
        ref_prog.einsum, long_dim_length=E, seed=seed, as_numpy=True))
    ref_fn = fr.build_executable(ref_prog, long_dim_length=E)
    ref_outs = [np.asarray(o) for o in ref_fn(
        {k: np.asarray(v) for k, v in stored.items()})]
    fn = ft.build_executable(program_from_reference(ref_prog),
                             long_dim_length=E, device="cpu")
    outs = [o.numpy() for o in fn(arrays_from_numpy(stored, "cpu"))]
    return ref_outs, outs


def assert_close(got, ref):
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("name", sorted(ROWS))
def test_emitter_matches_reference(name, backend):
    kernels.reset_launch_counts()
    ref_outs, outs = run_both(reference_program(ROWS[name], backend))
    assert len(outs) == len(ref_outs) == ROWS[name].b
    for got, ref in zip(outs, ref_outs):
        assert_close(got, ref)
    # CPU tensors run the plain versions: no kernel was launched
    assert set(kernels.launch_counts) >= {"dg_rows_f32", "ew_product_f32",
                                          "dd_rows", "tc_grid_f32"}
    assert not any(kernels.launch_counts.values())


def test_one_launch_per_row_knob_matches():
    prog = reference_program(ROWS["div_ndof6"]).with_descriptor(
        multiple_results_in_one_kernel=False)
    ref_outs, outs = run_both(prog, seed=3)
    for got, ref in zip(outs, ref_outs):
        assert_close(got, ref)


def test_other_stored_layouts_match():
    """The kernels take one stride per letter: a non-dof-major layout
    (the logical one) gives the same values."""
    prog = reference_program(ROWS["grad_ndof7"]).with_descriptor(
        arg_layouts=(), out_layout=None)
    ref_outs, outs = run_both(prog, seed=4)
    assert_close(outs[0], ref_outs[0])


@pytest.mark.parametrize("name", sorted(ROWS))
def test_row_planning_matches_reference(name):
    e = ROWS[name]
    r = to_reference(e)
    for row in range(e.b):
        try:
            ref = _recognize_row(r, r.args[row])
        except fr.InvalidParameterError:
            with pytest.raises(ft.InvalidParameterError):
                plan_row(e, row)
            continue
        ours = plan_row(e, row)
        assert (ours.u.name, ours.u_idx, ours.R.name, ours.r_idx) == (
            ref.u.name, ref.u_idx, ref.R.name, ref.r_idx)
        assert (ours.F.name if ours.F else None, ours.f_idx) == (
            ref.J.name if ref.J else None, ref.j_idx)
        assert (ours.s_letter, ours.j_letter, ours.x_letter,
                ours.u_has_s) == (ref.s_letter, ref.j_letter, ref.x_letter,
                                  ref.u_has_s)


def test_copy_row_is_not_a_dg_row():
    with pytest.raises(ft.InvalidParameterError):
        plan_row(ROWS["copy_ndof5"], 0)


@pytest.mark.parametrize("change", [
    {"fold_long": 8}, {"flatten": True}, {"dd_pairs": True},
    {"grid_index": ("i", "j")}, {"vmem_limit_bytes": 2 ** 20},
    {"preblock_args": ("u",)}, {"lane_pack": 4}, {"mfold": True},
    {"interpret": True}, {"compute_dtype": "bfloat16"},
])
def test_unported_descriptors_raise(change):
    prog = ft.interop.program_from_reference(
        reference_program(ROWS["mass_ndof9"])).with_descriptor(**change)
    with pytest.raises(ft.InvalidParameterError):
        ft.build_executable(prog, long_dim_length=E)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_bf16_3x_builds_and_matches_on_both_routes(backend):
    """``precision="bf16_3x"`` (three TF32 passes over an f32 split): the
    fused route plans the row onto ``dg_rows_3xtf32`` and both routes meet
    the numpy oracle."""
    e = ROWS["mass_ndof9"]
    prog = ft.interop.program_from_reference(
        reference_program(e)).with_descriptor(backend=backend,
                                              precision="bf16_3x")
    if backend == "pallas":
        assert plan_cuda_launch(prog, get_index_lengths(
            e, E)).kernel == "dg_rows_3xtf32"
    ft.validate_batched_einsum_transform(
        e, lambda p: prog, long_dim_length=E)


@pytest.mark.parametrize("einsum", [
    # a contracted long axis with a resident operand (long_reduce_f32 takes
    # streamed operands only): K1's general steps, step_block_f32
    ft.einsum("ej,j->", ft.array("A", ("E", 5), "float32"),
              ft.array("w", (5,), "float32")),
    ft.einsum("ij,ej->ei", ft.array("D", (4, 4), "float64"),
              ft.array("u", ("E", 4), "float64")),
    # operands that do not share the output's layout: step_block_f32
    ft.einsum("ej,e->ej", ft.array("A", ("E", 5), "float32"),
              ft.array("w", ("E",), "float32")),
], ids=["contracted_long", "float64", "broadcast_product"])
def test_unfused_rows_raise_on_fused_route(einsum):
    """Rows outside the row families: float64 still raises on the fused
    route (it runs on pair storage, ``dd_pairs``); the float32 rows build
    on ``step_block_f32`` and match the reference's K1; the plain route
    computes all three."""
    prog = S.default_transform(einsum)(ft.generate_program(einsum))
    prog = prog.with_descriptor(backend="pallas")
    if "float64" in {str(dt) for dt in einsum.arg_to_dtype.values()}:
        with pytest.raises(ft.InvalidParameterError, match="dd_pairs"):
            ft.build_executable(prog, long_dim_length=E)
    else:
        assert plan_cuda_launch(prog, get_index_lengths(
            einsum, E)).kernel == "step_block_f32"
        ft.validate_batched_einsum_transform(einsum, lambda p: prog,
                                             long_dim_length=E)
        ref_prog = reference_program(einsum).with_descriptor(
            dimension_semantics="arbitrary")
        ref_outs, outs = run_both(ref_prog, seed=8)
        assert_close(outs[0], ref_outs[0])
    # the plain route still computes them
    ft.validate_batched_einsum_transform(
        einsum, lambda p: p.with_descriptor(backend="xla"),
        long_dim_length=E)


# rows whose long axis is contracted: the energy, the per-letter sums and the
# Gram matrix (long_reduce_f32), at a narrow width
LONG_ROWS = {
    "energy_ndof6": S.make_energy(6),
    "per_letter_ndof6": ft.einsum("ej,ej->j",
                                  ft.array("u", ("E", 6), "float32"),
                                  ft.array("v", ("E", 6), "float32")),
    "gram_ndof5x7": ft.einsum("ei,ej->ij",
                              ft.array("u", ("E", 5), "float32"),
                              ft.array("v", ("E", 7), "float32")),
}


@pytest.mark.parametrize("layout", ["dofmajor", "logical"])
@pytest.mark.parametrize("name", sorted(LONG_ROWS))
def test_contracted_long_axis_matches_reference(name, layout):
    """The reference's K1 accumulates a contracted long axis across its
    grid ("arbitrary" semantics; one grid step here, F3); the port plans
    the row onto ``long_reduce_f32`` (its plain version on CPU tensors)."""
    prog = reference_program(LONG_ROWS[name]).with_descriptor(
        dimension_semantics="arbitrary")
    if layout == "logical":
        prog = prog.with_descriptor(arg_layouts=(), out_layout=None)
    plan = plan_cuda_launch(program_from_reference(prog),
                            get_index_lengths(LONG_ROWS[name], E))
    assert plan.kernel == "long_reduce_f32"
    ref_outs, outs = run_both(prog, seed=6)
    assert_close(outs[0], ref_outs[0])


def test_contracted_long_axis_refuses_parallel_over_blocks():
    """As in the reference (``pallas_emitter.py:609-613``): "parallel"
    semantics over more than one block of a contracted long axis raise;
    over one block, or with "arbitrary" semantics, the row builds."""
    e = LONG_ROWS["energy_ndof6"]
    prog = program_from_reference(reference_program(e)).with_descriptor(
        block_long=16)
    with pytest.raises(ft.InvalidParameterError, match="'parallel'"):
        ft.build_executable(prog, long_dim_length=E)
    ft.build_executable(prog, long_dim_length=16)
    ft.build_executable(prog.with_descriptor(dimension_semantics="arbitrary"),
                        long_dim_length=E)


def test_energy_space_is_the_reference_reduction_grid():
    """``elementwise_v1`` gives the energy the reference's reduction grid:
    at the reference's point with ``parallel_grid`` off, both packages
    build the same program ("arbitrary" semantics), the port's space pins
    that knob there, and the outputs agree (one grid step, F3)."""
    from feinsum_tpu.tuning import \
        get_transform_func_from_module_path as ref_space
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

    e = LONG_ROWS["energy_ndof6"]
    params = dict(log2_block=6, blkc128=0, dofmajor=True, fold=False,
                  flatten=False, parallel_grid=False, vmem_idx=2)
    # vmem_idx sets the TPU's VMEM cap, which the port accepts and ignores
    ref_prog = ref_space("elementwise_v1").bind_args(
        to_reference(e), **params)(fr.generate_program(
            to_reference(e))).with_descriptor(vmem_limit_bytes=None)
    ours = get_transform_func_from_module_path("elementwise_v1")
    assert ours.get_param_space(e)["parallel_grid"].high == 0
    prog = ours.bind_args(e, **params)(ft.generate_program(e))
    assert prog == program_from_reference(ref_prog)
    assert prog.descriptor.dimension_semantics == "arbitrary"
    ref_outs, outs = run_both(ref_prog, seed=7)
    assert_close(outs[0], ref_outs[0])


# rows with no i output axis: the extended suite's vecmat and rowsum, at a
# narrow and at the suite's width
REDUCE_ROWS = {
    "vecmat_ndof5": ft.einsum("ej,j->e", ft.array("A", ("E", 5), "float32"),
                              ft.array("x", (5,), "float32")),
    "vecmat_ndof35": dict(S.extended_suite())["vecmat_ndof35"],
    "rowsum_ndof35": dict(S.extended_suite())["rowsum_ndof35"],
    "rowsum_ndof4": ft.einsum("ej->e", ft.array("A", ("E", 4), "float32")),
}


@pytest.mark.parametrize("layout", ["dofmajor", "logical"])
@pytest.mark.parametrize("name", sorted(REDUCE_ROWS))
def test_reduce_rows_match_reference(name, layout):
    """The reference's K1 runs vecmat and rowsum; the port plans them onto
    ``row_reduce_f32`` (its plain version on CPU tensors), in the
    dof-major (J, E) layout and in the element-major (E, J) one."""
    prog = reference_program(REDUCE_ROWS[name])
    if layout == "logical":
        prog = prog.with_descriptor(arg_layouts=(), out_layout=None)
    plan = plan_cuda_launch(program_from_reference(prog),
                            get_index_lengths(REDUCE_ROWS[name], E))
    assert plan.kernel == "row_reduce_f32"
    ref_outs, outs = run_both(prog, seed=5)
    assert_close(outs[0], ref_outs[0])


FLAT_ROWS = {
    "scale_flat": S.make_scale_flat(),
    "flat_b2": ft.batched_einsum(
        "e,e,e->e", [[ft.array(a, ("E",), "float32") for a in names]
                     for names in (("a", "b", "c"), ("d", "b", "f"))]),
}


@pytest.mark.parametrize("name", sorted(FLAT_ROWS))
def test_flatten_matches_reference_k3(name):
    """``flatten=True`` on 1-D products: the reference's K3
    (``_try_build_flat_elementwise``, one flat block in interpret mode)
    against the port's flatten route (``ew_flat_f32``)."""
    r = to_reference(FLAT_ROWS[name])
    prog = fr.generate_program(r).with_descriptor(
        backend="pallas", flatten=True, block_long=E)
    plan = plan_cuda_launch(program_from_reference(prog),
                            get_index_lengths(FLAT_ROWS[name], E))
    assert plan.kernel == "ew_flat_f32"
    ref_outs, outs = run_both(prog, seed=6)
    assert len(outs) == FLAT_ROWS[name].b
    for got, ref in zip(outs, ref_outs):
        assert_close(got, ref)


@pytest.mark.parametrize("change", [{"arg_layouts": (("a", (0,)),)},
                                    {"fold_long": 8}])
def test_flatten_refuses_what_the_reference_refuses(change):
    prog = ft.generate_program(S.make_scale_flat()).with_descriptor(
        backend="pallas", flatten=True, **change)
    with pytest.raises(ft.InvalidParameterError):
        ft.build_executable(prog, long_dim_length=E)


def test_tf32_is_refused():
    prog = ft.generate_program(ROWS["matvec_ndof10"])
    fn = ft.build_executable(prog, long_dim_length=E)
    arrays = ft.measure.generate_input_arrays(prog.einsum,
                                              long_dim_length=E,
                                              device="cpu")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(ft.InvalidParameterError):
            fn(arrays)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    fn(arrays)

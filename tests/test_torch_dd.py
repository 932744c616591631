"""The port's fp64 path (``dd_pairs``: ``ops/dd_emitter.py`` and the
``dd_rows`` kernel's plain version on CPU tensors) held to the JAX
package's double-double kernel K4 on the same seeded inputs.

The reference runs as ``tests/test_dd_pairs.py`` runs it: Pallas interpret
mode on the CPU, ``log2_block`` 9 and E = 1000, so its grid has two steps
and a partial tail; curl, as there, at ``log2_block`` 10 (one step),
because the reference's interpret run of curl at two grid steps loses the
lo half of its pairs (about 1e-7 of max|oracle|, where the port and the
reference's one-step run hold 1e-14).  Both sides are recombined to
float64 and compared within 1e-12 of max|reference| (the float64 oracle's
tolerance).  This file is on its own because the reference's dd path turns
``jax_enable_x64`` on for the whole process."""

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
from feinsum_tpu.ops.dd_emitter import split_to_pairs as ref_split
from feinsum_tpu.tuning import \
    get_transform_func_from_module_path as ref_space_of
from feinsum_tpu_torch.interop import arrays_from_numpy, \
    program_from_reference
from feinsum_tpu_torch.measure import apply_layouts, generate_input_arrays
from feinsum_tpu_torch.ops import kernels
from feinsum_tpu_torch.ops.dd_emitter import combine_pairs, split_to_pairs
from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

E = 1000
SEED = 3
RTOL = 1e-12


def _rows():
    A = ft.array
    f64 = "float64"
    return {
        "div_ndof7": ft.batched_einsum(
            "es,sij,ej->ei",
            [[A(j, ("E", 3), f64), A("R", (3, 7, 7), f64),
              A(u, ("E", 7), f64)]
             for j, u in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]]),
        "grad_ndof4": ft.einsum("xre,rij,ej->xei", A("J", (3, 3, "E"), f64),
                                A("D", (3, 4, 4), f64),
                                A("u", ("E", 4), f64)),
        "face_mass_ndof9": ft.einsum("ifj,fe,fej->ei",
                                     A("L", (9, 4, 6), f64),
                                     A("Fj", (4, "E"), f64),
                                     A("flux", (4, "E", 6), f64)),
        "mass_ndof8": ft.einsum("e,ij,ej->ei", A("jac", ("E",), f64),
                                A("M", (8, 8), f64), A("u", ("E", 8), f64)),
        "matvec_ndof6": ft.einsum("ej,ij->ei", A("u", ("E", 6), f64),
                                  A("D", (6, 6), f64)),
        "curl_ndof9": ft.batched_einsum(
            "e,rij,ej->ei",
            [[A(j, ("E",), f64), A("D", (3, 9, 9), f64),
              A(u, ("E", 9), f64)]
             for j, u in [("Jy", "uz"), ("Jz", "ux")]]),
    }


ROWS = _rows()
# log2_block of the reference's run per row (9 unless listed)
REF_LOG2_BLOCK = {"curl_ndof9": 10}


def to_reference(e):
    return fr.batched_einsum(e.get_subscripts(), [
        [fr.array(a.name, tuple(d.name if isinstance(d, ft.SizeParam) else d
                                for d in a.shape), a.dtype)
         for a in row] for row in e.args])


def reference_run(e, log2_block=9):
    """The reference's dd program and its (2, ...) pair outputs."""
    r = to_reference(e)
    prog = ref_space_of("dd_pallas_v0").bind_args(
        r, log2_block=log2_block, parallel_grid=True)(fr.generate_program(r))
    arrays = ref_apply_layouts(prog, ref_generate_input_arrays(
        r, long_dim_length=E, seed=SEED, as_numpy=True))
    fn = fr.build_executable(prog, long_dim_length=E)
    return prog, arrays, [np.asarray(o) for o in fn(arrays)]


def port_program(e, log2_block=9):
    return get_transform_func_from_module_path("dd_pallas_v0").bind_args(
        e, log2_block=log2_block)(ft.generate_program(e))


@pytest.mark.parametrize("name", sorted(ROWS))
def test_dd_path_matches_reference(name):
    e = ROWS[name]
    log2_block = REF_LOG2_BLOCK.get(name, 9)
    ref_prog, ref_arrays, ref_outs = reference_run(e, log2_block)
    program = port_program(e, log2_block)
    assert program.descriptor == program_from_reference(
        ref_prog).descriptor.copy(vmem_limit_bytes=None)

    arrays = apply_layouts(program, generate_input_arrays(
        e, long_dim_length=E, seed=SEED, device="cpu"))
    # the same stored pair layout, bit for bit
    assert arrays.keys() == ref_arrays.keys()
    for k, t in arrays.items():
        assert t.dtype == torch.float32 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), ref_arrays[k])

    kernels.reset_launch_counts()
    outs = ft.build_executable(program, long_dim_length=E, device="cpu")(
        arrays)
    assert kernels.launch_counts["dd_rows"] == 0     # CPU: plain version
    assert len(outs) == len(ref_outs) == e.b
    logical = tuple(E if isinstance(d, ft.SizeParam) else d
                    for d in [e.index_to_dim_length[ix]
                              for ix in e.out_idx_set])
    for got, ref in zip(outs, ref_outs):
        assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
        want = combine_pairs(ref)
        scale = float(np.max(np.abs(want)))
        np.testing.assert_allclose(combine_pairs(got.numpy()), want,
                                   rtol=RTOL, atol=RTOL * scale)
        # unpack_output: pairs -> float64 -> the logical output
        unpacked = ft.unpack_output(program, got, logical).numpy()
        ref_unpacked = np.asarray(fr.unpack_output(ref_prog, ref, logical))
        np.testing.assert_allclose(unpacked, ref_unpacked, rtol=RTOL,
                                   atol=RTOL * scale)


@pytest.mark.parametrize("name", ["div_ndof7", "grad_ndof4", "curl_ndof9"])
def test_dd_path_validates_at_1em12(name):
    ft.validate_batched_einsum_transform(
        ROWS[name], lambda p: port_program(p.einsum), long_dim_length=E)


@pytest.mark.parametrize("shape", [(1000,), (7, 33), (3, 4, 5)])
def test_split_to_pairs_is_bit_equal(shape):
    rng = np.random.default_rng(11)
    x = (rng.random(shape) - 0.5) * 10.0 ** rng.integers(-15, 15, shape)
    want = ref_split(x)
    np.testing.assert_array_equal(split_to_pairs(x), want)
    np.testing.assert_array_equal(
        split_to_pairs(torch.from_numpy(x)).numpy(), want)
    assert split_to_pairs(x).dtype == np.float32
    # hi + lo carries the value to about 48 bits
    np.testing.assert_allclose(combine_pairs(want), x, rtol=1e-14, atol=0)


def test_dd_space_refuses_what_the_reference_refuses():
    """The refusals of ``tests/test_dd_pairs.py``: a float32 einsum, and two
    residents (outside the DG family)."""
    sp = get_transform_func_from_module_path("dd_pallas_v0")
    e32 = ft.einsum("ej,ij->ei", ft.array("u", ("E", 8), "float32"),
                    ft.array("D", (8, 8), "float32"))
    with pytest.raises(ft.InvalidParameterError, match="fp64"):
        sp.bind_args(e32, log2_block=10)(ft.generate_program(e32))
    two_res = ft.einsum("ej,ik,kj->ei", ft.array("u", ("E", 6), "float64"),
                        ft.array("A", (8, 5), "float64"),
                        ft.array("B", (5, 6), "float64"))
    with pytest.raises(ft.InvalidParameterError):
        sp.bind_args(two_res, log2_block=10)(ft.generate_program(two_res))


@pytest.mark.parametrize("change", [
    {"arg_layouts": ()},                 # long axis not trailing
    {"out_layout": None},                # not the dof-major rotate
    {"backend": "xla"},                  # dd_pairs needs the kernel
])
def test_dd_storage_contract_is_enforced(change):
    program = port_program(ROWS["mass_ndof8"]).with_descriptor(**change)
    with pytest.raises(ft.InvalidParameterError):
        ft.build_executable(program, long_dim_length=E)


def test_dd_refuses_float32_operands_and_wrong_pair_shapes():
    e = ROWS["matvec_ndof6"]
    program = port_program(e)
    e32 = ft.einsum("ej,ij->ei", ft.array("u", ("E", 6), "float32"),
                    ft.array("D", (6, 6), "float32"))
    with pytest.raises(ft.InvalidParameterError):
        ft.build_executable(program.copy(einsum=e32), long_dim_length=E)
    fn = ft.build_executable(program, long_dim_length=E)
    arrays = arrays_from_numpy(apply_layouts(program, generate_input_arrays(
        e, long_dim_length=E, as_numpy=True)), "cpu")
    arrays["u"] = arrays["u"][0]             # the hi plane alone
    with pytest.raises(ft.InvalidParameterError, match="pair layout"):
        fn(arrays)

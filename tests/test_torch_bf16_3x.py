"""``precision="bf16_3x"`` held to the JAX package on CPU.

The reference computes each in-kernel dot at ``bf16_3x`` as three bf16
passes over an f32 hi/lo split (``feinsum_tpu/ops/kernel_lowering.py::
_dot_bf16_3x``); the port computes it as three TF32 passes over the same
split (``dg_rows_3xtf32``, ``tc_grid_3xtf32`` and their plain versions,
which CPU tensors run).  For each DG suite row, the face restriction,
curl with ``prereduce`` and two TCCG rows at small sizes, one ``bf16_3x``
program of the same space point runs through both packages on the same
numpy-seeded inputs.  The reference's K1 and K2 run in Pallas interpret
mode at one grid step (``block_long`` >= the long axis; ROADMAP fault F3),
one TCCG row also on its plain (XLA) route.  Each result is held to the
float64 oracle within 2e-5 of max|oracle|, and the two to each other
within 4e-5 of max|oracle| (bf16_3x is the coarser split).
"""

from __future__ import annotations

import numpy as np
import pytest

import feinsum_tpu as fr
import feinsum_tpu_torch as ft
from feinsum_tpu.measure import (
    apply_layouts as ref_apply_layouts,
    generate_input_arrays as ref_generate_input_arrays,
)
from feinsum_tpu.ops.layouts import unpack_output as ref_unpack_output
from feinsum_tpu.tuning import get_transform_func_from_module_path as ref_space
from feinsum_tpu_torch import suite as S
from feinsum_tpu_torch.codegen.program import get_index_lengths
from feinsum_tpu_torch.measure import apply_layouts, generate_input_arrays
from feinsum_tpu_torch.ops import kernels
from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
from feinsum_tpu_torch.ops.tc_emitter import plan_tc_launch
from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

E = 64
SEED = 43
ORACLE_RTOL = 2e-5
PAIR_RTOL = 4e-5


def _restriction(ndof: int, nfaces: int = 4, nfdof: int = 5):
    return ft.einsum("fji,ei->fej",
                     ft.array("R", (nfaces, nfdof, ndof), "float32"),
                     ft.array("u", ("E", ndof), "float32"))


# (einsum, space, knobs besides precision_3x)
DG_CASES = {
    "div_b3": (S.make_div(6), "dg_div_v0", {}),
    "grad": (S.make_grad(7), "dg_grad_v0", {}),
    "face_mass": (S.make_face_mass(8, 5), "face_mass_v0", {}),
    "mass": (S.make_mass(9), "mass_v0", {}),
    "matvec": (S.make_matvec(10), "mass_v0", {}),
    "restriction": (_restriction(7), "mass_v0", {}),
    "curl_prereduce": (S.make_curl(6), "curl_3d_v0", {"prereduce": True}),
}

# (subscripts, A shape, B shape), the JAX package's own small TC shapes
TC_EINSUMS = {
    "tccg35_small": ("dfgb,geac->abcdef", (6, 4, 5, 7), (5, 8, 9, 10)),
    "tccg02_small": ("dca,bd->abc", (6, 8, 4), (5, 6)),
}
# (einsum, space, params at bf16_3x)
TC_CASES = {
    "tccg35_small-tc_pallas_v1": ("tccg35_small", "tc_pallas_v1", dict(
        n_grid=2, blk0_idx=1, blk1_idx=0, m_pos=5, mstack=False,
        precision_idx=1, use_opt_path=False)),
    "tccg02_small-tc_pallas_v1": ("tccg02_small", "tc_pallas_v1", dict(
        n_grid=1, blk0_idx=1, blk1_idx=0, m_pos=2, mstack=False,
        precision_idx=1, use_opt_path=False)),
    "tccg35_small-tc_xla_v0": ("tccg35_small", "tc_xla_v0", dict(
        use_opt_path=True, precision_idx=2)),
}


def to_reference(e):
    def dim(d):
        return d.name if isinstance(d, ft.SizeParam) else d
    return fr.batched_einsum(e.get_subscripts(), [
        [fr.array(a.name, tuple(dim(d) for d in a.shape), a.dtype)
         for a in row] for row in e.args])


def _oracle(e, logical: dict) -> list:
    subs = e.get_subscripts().replace(" ", "")
    return [np.einsum(subs, *[logical[a.name].astype(np.float64)
                              for a in row]) for row in e.args]


def _hold(port: list, ref: list, oracle: list) -> None:
    assert len(port) == len(ref) == len(oracle)
    for got, want, exact in zip(port, ref, oracle):
        got = np.asarray(got, dtype=np.float64)
        want = np.asarray(want, dtype=np.float64)
        assert got.shape == want.shape == exact.shape
        scale = float(np.max(np.abs(exact)))
        assert float(np.max(np.abs(got - exact))) <= ORACLE_RTOL * scale
        assert float(np.max(np.abs(want - exact))) <= ORACLE_RTOL * scale
        assert float(np.max(np.abs(got - want))) <= PAIR_RTOL * scale


def _run_both(e, space: str, params: dict, ref_params: dict,
              length: int) -> tuple:
    """(port's program, port's logical outputs, reference's logical
    outputs, the float64 oracle's)."""
    r = to_reference(e)
    prog = get_transform_func_from_module_path(space).bind_args(
        e, **params)(ft.generate_program(e))
    ref_prog = ref_space(space).bind_args(r, **ref_params)(
        fr.generate_program(r))
    assert prog.descriptor.precision == ref_prog.descriptor.precision \
        == "bf16_3x"
    logical = generate_input_arrays(e, long_dim_length=length, seed=SEED,
                                    as_numpy=True)
    ref_logical = ref_generate_input_arrays(r, long_dim_length=length,
                                            seed=SEED, as_numpy=True)
    for name, arr in logical.items():
        np.testing.assert_array_equal(arr, np.asarray(ref_logical[name]))
    shape = tuple(int(d) if not isinstance(d, ft.SizeParam) else length
                  for d in e.shape)
    kernels.reset_launch_counts()
    outs = ft.build_executable(prog, long_dim_length=length, device="cpu")(
        apply_layouts(prog, generate_input_arrays(
            e, long_dim_length=length, seed=SEED, device="cpu")))
    assert not any(kernels.launch_counts.values())
    got = [ft.unpack_output(prog, o, shape).numpy() for o in outs]
    ref_outs = fr.build_executable(ref_prog, long_dim_length=length)(
        ref_apply_layouts(ref_prog, dict(ref_logical)))
    want = [np.asarray(ref_unpack_output(ref_prog, np.asarray(o), shape))
            for o in ref_outs]
    return prog, got, want, _oracle(e, logical)


@pytest.mark.parametrize("name", sorted(DG_CASES))
def test_dg_rows_match_reference_at_bf16_3x(name):
    e, space, knobs = DG_CASES[name]
    r = to_reference(e)
    params = S.space_point(space, e, log2_block=8, precision_3x=True,
                           **knobs)
    ref_params = {k: params.get(k, False)
                  for k in ref_space(space).get_param_space(r)}
    prog, got, want, oracle = _run_both(e, space, params, ref_params, E)
    assert prog.descriptor.block_long >= E
    assert plan_cuda_launch(prog, get_index_lengths(
        prog.einsum, E)).kernel == "dg_rows_3xtf32"
    _hold(got, want, oracle)


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tccg_rows_match_reference_at_bf16_3x(case):
    key, space, params = TC_CASES[case]
    subs, sa, sb = TC_EINSUMS[key]
    e = ft.einsum(subs, ft.array("A", sa, "float32"),
                  ft.array("B", sb, "float32"))
    prog, got, want, oracle = _run_both(e, space, params, params, 1)
    if space == "tc_pallas_v1":
        assert plan_tc_launch(prog, get_index_lengths(
            e, 1)).kernel == "tc_grid_3xtf32"
    _hold(got, want, oracle)


def test_the_split_is_finer_than_the_references():
    """Per product the TF32 split (10 explicit bits) keeps about 2**-21 of
    the f32 value, the reference's bf16 split (7 bits) about 2**-16: on the
    same inputs the port's 3x result lies closer to the float64 oracle."""
    e, space, _ = DG_CASES["mass"]
    params = S.space_point(space, e, log2_block=8, precision_3x=True)
    ref_params = {k: params.get(k, False) for k in ref_space(
        space).get_param_space(to_reference(e))}
    _, got, want, oracle = _run_both(e, space, params, ref_params, E)
    (got,), (want,), (exact,) = got, want, oracle
    assert np.abs(got - exact).max() < np.abs(want - exact).max()

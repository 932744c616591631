"""The port's main path as a whole, on CPU tensors: each of the six DG-suite
rows at full width (``feinsum_tpu_torch.suite``) goes through the port's
validate -> apply_layouts -> build_executable -> run, and its outputs are
held to the JAX package's outputs for the same seeded inputs.  The JAX
side runs its own built-in default program at one grid step (Pallas
interpret mode; ROADMAP fault F3)."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import feinsum_tpu as fr
import feinsum_tpu_torch as ft
from feinsum_tpu.measure import (
    apply_layouts as ref_apply_layouts,
    generate_input_arrays as ref_generate_input_arrays,
)
from feinsum_tpu.ops.layouts import dofmajor_layouts as ref_dofmajor_layouts
from feinsum_tpu_torch.interop import program_from_reference
from feinsum_tpu_torch.measure import apply_layouts, generate_input_arrays
from feinsum_tpu_torch.ops import kernels
from feinsum_tpu_torch.suite import default_transform, suite

E = 48
SEED = 7
RTOL = 2e-5
REPO = Path(__file__).resolve().parents[1]


def to_reference(e):
    def dim(d):
        return d.name if isinstance(d, ft.SizeParam) else d
    return fr.batched_einsum(e.get_subscripts(), [
        [fr.array(a.name, tuple(dim(d) for d in a.shape), a.dtype)
         for a in row] for row in e.args])


def reference_outputs(e):
    r = to_reference(e)
    layouts, out_perm = ref_dofmajor_layouts(r)
    prog = fr.generate_program_with_opt_einsum_schedule(r).with_descriptor(
        backend="pallas", block_long=E, dimension_semantics="parallel",
        arg_layouts=layouts, out_layout=out_perm)
    arrays = ref_apply_layouts(prog, ref_generate_input_arrays(
        r, long_dim_length=E, seed=SEED, as_numpy=True))
    fn = fr.build_executable(prog, long_dim_length=E)
    return prog, [np.asarray(o) for o in fn(arrays)]


@pytest.mark.parametrize("name", [name for name, _ in suite()])
def test_slice_matches_reference(name):
    e = dict(suite())[name]
    transform = default_transform(e)
    kernels.reset_launch_counts()

    # the main path, as a user drives it
    ft.validate_batched_einsum_transform(e, transform, long_dim_length=E,
                                         device="cpu")
    program = transform(ft.generate_program(e))
    arrays = apply_layouts(program, generate_input_arrays(
        e, long_dim_length=E, seed=SEED, device="cpu"))
    assert all(t.is_contiguous() for t in arrays.values())
    fn = ft.build_executable(program, long_dim_length=E, device="cpu")
    outs = fn(arrays)

    ref_prog, ref_outs = reference_outputs(e)
    # same schedule and storage contract as the reference's default
    carried = program_from_reference(ref_prog)
    assert program.schedule == carried.schedule
    assert program.descriptor == carried.descriptor.copy(
        block_long=program.descriptor.block_long)
    assert len(outs) == len(ref_outs) == e.b
    for got, ref in zip(outs, ref_outs):
        got = got.numpy()
        assert got.shape == ref.shape and np.all(np.isfinite(got))
        scale = float(np.max(np.abs(ref)))
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale)
    assert set(kernels.launch_counts) >= {"dg_rows_f32", "ew_product_f32",
                                          "dd_rows", "tc_grid_f32"}
    assert not any(kernels.launch_counts.values())


def test_unpack_output_recovers_the_logical_result():
    e = dict(suite())["dg_grad_ndof35"]
    program = default_transform(e)(ft.generate_program(e))
    np_arrays = generate_input_arrays(e, long_dim_length=E, seed=SEED,
                                      as_numpy=True)
    fn = ft.build_executable(program, long_dim_length=E)
    (out,) = fn(apply_layouts(program, generate_input_arrays(
        e, long_dim_length=E, seed=SEED)))
    logical = ft.unpack_output(program, out, (3, E, 35)).numpy()
    want = np.einsum("xre,rij,ej->xei", *[np_arrays[n]
                                           for n in ("J", "D", "u")])
    np.testing.assert_allclose(logical, want, rtol=RTOL,
                               atol=RTOL * float(np.max(np.abs(want))))


def test_port_imports_no_jax():
    """Importing every module of the port (the CUDA kernels are only
    built at first launch) loads neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import feinsum_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'feinsum_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"

"""The port's framework-free layers against the JAX package: the einsum IR,
the optimal-path schedule search, dof-major layouts and the flop and byte
models.  Both packages build the same einsums; nothing runs a device."""

from __future__ import annotations

import numpy as np
import pytest

import feinsum_tpu as fr
import feinsum_tpu_torch as ft
from feinsum_tpu.ops.layouts import dofmajor_layouts as ref_dofmajor_layouts
from feinsum_tpu_torch.contraction_schedule import optimal_contraction_list
from feinsum_tpu_torch.interop import einsum_from_reference
from feinsum_tpu_torch.measure import (
    evaluate_giga_op_map,
    get_write_gbytes,
)
from feinsum_tpu_torch.ops.layouts import dofmajor_layouts
from feinsum_tpu_torch.suite import extended_suite, suite

from testlib import generate_batched_einsum

ROWS = dict(suite() + extended_suite())


def to_reference(e: ft.BatchedEinsum) -> fr.BatchedEinsum:
    """The same einsum built through the JAX package's constructors."""
    def dim(d):
        return d.name if isinstance(d, ft.SizeParam) else d
    return fr.batched_einsum(e.get_subscripts(), [
        [fr.array(a.name, tuple(dim(d) for d in a.shape), a.dtype)
         for a in row] for row in e.args])


def _plain(lengths: dict) -> dict:
    return {ix: (ln.name if hasattr(ln, "name") else int(ln))
            for ix, ln in lengths.items()}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_ir_parity(name):
    e = ROWS[name]
    r = to_reference(e)
    assert e.out_idx_set == r.out_idx_set
    assert e.in_idx_sets == r.in_idx_sets
    assert (e.b, e.n, e.ndim) == (r.b, r.n, r.ndim)
    assert _plain(e.index_to_dim_length) == _plain(r.index_to_dim_length)
    assert e.arg_to_dtype == r.arg_to_dtype
    assert e.sum_indices == r.sum_indices
    assert e.get_subscripts() == r.get_subscripts()
    assert str(e) == str(r)
    assert ({p.name for p in e.all_size_params}
            == {p.name for p in r.all_size_params})
    # and back: the interop reader rebuilds the port's einsum exactly
    assert einsum_from_reference(r) == e


@pytest.mark.parametrize("subscripts", ["ij->ii", "ij,jk", "i,j->k",
                                        "A,B->AB", "i...->i"])
def test_constructor_errors_match(subscripts):
    def build(pkg):
        return pkg.batched_einsum(subscripts, [[pkg.array("a", (2, 2)),
                                                pkg.array("b", (2,))]])
    with pytest.raises(Exception) as ref_exc:
        build(fr)
    with pytest.raises(type(ref_exc.value)):
        build(ft)


@pytest.mark.parametrize("name", sorted(ROWS))
def test_schedule_matches_reference(name):
    e = ROWS[name]
    ours = ft.get_opt_einsum_contraction_schedule(e)
    ref = fr.get_opt_einsum_contraction_schedule(to_reference(e))
    assert ours.subscripts == ref.subscripts
    assert ours.result_names == ref.result_names
    assert ([[type(a).__name__ + str(vars(a)) for a in step]
             for step in ours.arguments]
            == [[type(a).__name__ + str(vars(a)) for a in step]
                for step in ref.arguments])


def test_suite_schedules_are_the_known_ones():
    want = {
        "dg_div_ndof35": ("ej,es->ejs", "ejs,sij->ei"),
        "dg_grad_ndof35": ("ej,rij->eri", "eri,xre->xei"),
        "dg_face_mass": ("fej,fe->fej", "fej,ifj->ei"),
        "dg_mass_ndof35": ("ej,e->ej", "ej,ij->ei"),
        "matvec_ndof20": ("ij,ej->ei",),
        "copy_ndof35": ("ij,ij->ij",),
    }
    for name, e in suite():
        assert ft.get_opt_einsum_contraction_schedule(e).subscripts \
            == want[name]


@pytest.mark.parametrize("seed", range(6))
def test_schedule_matches_reference_on_random_einsums(seed):
    """The path search against opt_einsum on the reference's fuzz einsums
    (up to four operands, where the exhaustive search is cheap)."""
    import opt_einsum

    rng = np.random.default_rng(seed)
    checked = 0
    while checked < 8:
        r = generate_batched_einsum(rng)
        if r.n > 4:
            continue
        e = einsum_from_reference(r)
        for long_len in (7, 1000):
            ours = ft.get_opt_einsum_contraction_schedule(
                e, long_dim_length=long_len)
            ref = fr.get_opt_einsum_contraction_schedule(
                r, long_dim_length=long_len)
            assert ours.subscripts == ref.subscripts
        sizes = {ix: int(ln) for ix, ln in e.index_to_dim_length.items()}
        subs = (",".join("".join(s) for s in e.in_idx_sets) + "->"
                + "".join(e.out_idx_set))
        _, info = opt_einsum.contract_path(
            subs, *[tuple(sizes[ix] for ix in s) for s in e.in_idx_sets],
            shapes=True, optimize="optimal", use_blas=False)
        assert optimal_contraction_list(subs, sizes) == [
            (tuple(c[0]), c[2]) for c in info.contraction_list]
        checked += 1


@pytest.mark.parametrize("name", sorted(ROWS))
def test_dofmajor_layouts_match(name):
    e = ROWS[name]
    assert dofmajor_layouts(e) == ref_dofmajor_layouts(to_reference(e))


@pytest.mark.parametrize("name", sorted(ROWS))
def test_op_counts_and_footprints_match(name):
    from feinsum_tpu import measure as rm

    e = ROWS[name]
    r = to_reference(e)
    ours = evaluate_giga_op_map(ft.get_giga_op_map(e), 1000)
    ref = rm.evaluate_giga_op_map(rm.get_giga_op_map(r), 1000)
    assert ours == pytest.approx(ref, rel=1e-12)
    assert ft.get_footprint_gbytes(e, long_dim_length=1000) == pytest.approx(
        rm.get_footprint_gbytes(r, long_dim_length=1000), rel=1e-12)
    assert get_write_gbytes(e, long_dim_length=1000) == pytest.approx(
        rm.get_write_gbytes(r, long_dim_length=1000), rel=1e-12)


def test_roofline_uses_the_h100_table():
    e = dict(suite())["dg_div_ndof35"]
    rate = ft.get_roofline_flop_rate(e, "NVIDIA H100 80GB HBM3",
                                     long_dim_length=1_000_000)
    gops = sum(evaluate_giga_op_map(ft.get_giga_op_map(e),
                                    1_000_000).values())
    t_mem = ft.get_footprint_gbytes(e, long_dim_length=1_000_000) / 3_350.0
    t_dot = gops / 67_000.0
    assert rate == pytest.approx(gops / max(t_mem, t_dot), rel=1e-12)
    with pytest.raises(ft.NoDevicePeaksInfoError):
        ft.get_roofline_flop_rate(e, "TPU v5 lite")
    with pytest.raises(ft.NoDevicePeaksInfoError):
        ft.get_roofline_flop_rate(e, "cpu")

"""The port's canonicalization (``feinsum_tpu_torch.canonicalization``) held
to the JAX package's: the same canonical einsum, entity for entity, on the
corpus of ``tests/test_canonicalization.py`` and on every einsum of the
shipped archive; the same substitution maps and operand positions; and the
port's pure-Python labeling against its native one.  Canonical forms are
compared exactly (names, index letters, shapes, dtypes): they are archive
keys, so there is no tolerance."""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import pytest

import feinsum_tpu as fr
import feinsum_tpu_torch as ft
from feinsum_tpu import sql_utils as ref_sql
from feinsum_tpu_torch.interop import einsum_from_reference
from testlib import (apply_renaming_to_batched_einsum, generate_batched_einsum,
                     make_dg_div)

SHIPPED = (Path(__file__).resolve().parents[1] / "feinsum_tpu" / "data"
           / "transform_archive_v1_tpu.sqlite")


def assert_same_canonical_form(ref_einsum):
    ours = ft.canonicalize_einsum(einsum_from_reference(ref_einsum))
    assert ours == einsum_from_reference(fr.canonicalize_einsum(ref_einsum))


def _dg_div_renamed(size="E"):
    return fr.batched_einsum(
        "td, dkl, tl -> tk",
        [[fr.array(j, (size, 3)), fr.array("ref_mat", (3, 35, 35)),
          fr.array(u, (size, 35))]
         for j, u in [("Jacx", "x_dofs"), ("Jacy", "y_dofs"),
                      ("Jacz", "z_dofs")]])


def _automorphic_corpus():
    """The einsums of test_canonicalization_with_automorphic_vertices."""
    A = fr.array
    return [
        fr.einsum("ij,ik->i", A("A", ("I", 10), np.float64),
                  A("B", ("I", 10), np.float32)),
        fr.einsum("ik,ij->i", A("C", ("J", 10), np.float32),
                  A("D", ("J", 10), np.float64)),
        fr.einsum("ijk,ij,ik->i", A("A", ("I", 10, 10), np.float64),
                  A("B", ("I", 10), np.float64),
                  A("C", ("I", 10), np.float32)),
        fr.einsum("ijk,ij,ik->i", A("A", ("I", 10, 10), np.float64),
                  A("B", ("I", 10), np.float32),
                  A("C", ("I", 10), np.float64)),
        fr.einsum("ijk,ik,ij->i", A("P", ("J", 10, 10), np.float64),
                  A("Q", ("J", 10), np.float64),
                  A("R", ("J", 10), np.float64)),
        fr.batched_einsum("ijk,ik,ij,ij->i", [
            [A("A", ("I", 10, 10)), A("B", ("I", 10)), A("C", ("I", 10)),
             A("D", ("I", 10))]]),
        fr.batched_einsum("ikj,ik,ij,ik->i", [
            [A("P", ("L", 10, 10)), A("Q", ("L", 10)), A("R", ("L", 10)),
             A("S", ("L", 10))]]),
        fr.batched_einsum("ijk,ik,ij,ij->i", [
            [A("A", ("I", 10, 10)), A("B", ("I", 10)), A("C", ("I", 10)),
             A("D", ("I", 10))],
            [A("A", ("I", 10, 10)), A("B", ("I", 10)), A("C", ("I", 10)),
             A("B", ("I", 10))]]),
        fr.batched_einsum("elm,em,el,el->e", [
            [A("P", ("J", 10, 10)), A("Q", ("J", 10)), A("R", ("J", 10)),
             A("Q", ("J", 10))],
            [A("P", ("J", 10, 10)), A("Q", ("J", 10)), A("R", ("J", 10)),
             A("S", ("J", 10))]]),
    ]


CORPUS = {
    "dg_div": make_dg_div,
    "dg_div_f32": lambda: make_dg_div(dtype="float32"),
    "dg_div_renamed": _dg_div_renamed,
    **{f"automorphic_{k}": (lambda k=k: _automorphic_corpus()[k])
       for k in range(9)},
}


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_corpus_canonical_forms_match(name):
    e = CORPUS[name]()
    assert_same_canonical_form(e)
    # idempotent in the port too
    once = ft.canonicalize_einsum(einsum_from_reference(e))
    assert ft.canonicalize_einsum(once) == once


def test_isomorphism_verdicts_match():
    corpus = _automorphic_corpus() + [make_dg_div(), _dg_div_renamed(),
                                      make_dg_div(dtype="float32")]
    for a in corpus:
        for b in corpus:
            assert ft.are_einsums_isomorphic(
                einsum_from_reference(a), einsum_from_reference(b)) == (
                fr.canonicalize_einsum(a) == fr.canonicalize_einsum(b))


def test_large_graph_canonical_forms_match():
    e = fr.batched_einsum(
        "ij,ej->ei",
        [[fr.array(f"u{i}", (35, 35)), fr.array(f"v{i}", ("E", 35))]
         for i in range(120)])
    assert_same_canonical_form(e)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_canonical_forms_match(seed):
    """Random einsums of the reference's fuzz generator and random
    renamings of them: the port's canonical form is the reference's."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(48):
        e = generate_batched_einsum(rng)
        arg_names = tuple(sorted(e.all_args))
        indices = tuple(sorted(e.all_indices))
        renamed = apply_renaming_to_batched_einsum(
            e, [int(x) for x in rng.permutation(e.b)],
            [int(x) for x in rng.permutation(e.n)],
            dict(zip(indices, (str(s) for s in rng.permutation(indices)))),
            dict(zip(arg_names, (str(s) for s in
                                 rng.permutation(arg_names)))))
        assert_same_canonical_form(e)
        assert ft.canonicalize_einsum(einsum_from_reference(e)) == \
            ft.canonicalize_einsum(einsum_from_reference(renamed))


def test_archive_einsums_canonical_forms_match(tmp_path):
    db = tmp_path / "archive.sqlite"
    shutil.copy(SHIPPED, db)
    ref_einsums = ref_sql.get_timed_einsums_in_db(db_path=str(db))
    assert len(ref_einsums) > 50
    for e in ref_einsums:
        assert_same_canonical_form(e)
    ours = ft.get_timed_einsums_in_db(db_path=str(db))
    assert ours == [einsum_from_reference(e) for e in ref_einsums]


def test_substitution_mapping_and_positions_match():
    e1, e2 = make_dg_div(), _dg_div_renamed("EL")
    p1, p2 = einsum_from_reference(e1), einsum_from_reference(e2)
    assert ft.get_substitution_mapping_between_isomorphic_batched_einsums(
        p1, p2) == \
        fr.get_substitution_mapping_between_isomorphic_batched_einsums(
            e1, e2)
    with pytest.raises(ValueError):
        ft.get_substitution_mapping_between_isomorphic_batched_einsums(
            p1, einsum_from_reference(make_dg_div(dtype="float32")))
    tccg = fr.einsum("dca,bd->abc", fr.array("A", (8, 9, 10)),
                     fr.array("B", (11, 8)))
    assert ft.canonical_operand_positions(einsum_from_reference(tccg)) \
        == fr.canonical_operand_positions(tccg)


def test_python_labeling_agrees_with_native():
    from feinsum_tpu_torch import canonicalization as canon
    from feinsum_tpu_torch.native.canon_py import canonical_labeling_py

    if canon._get_native() is None:
        pytest.skip("g++ unavailable: the native core cannot be built")
    rng = np.random.default_rng(17)
    for _ in range(25):
        g = canon._EinsumGraph(einsum_from_reference(
            generate_batched_einsum(rng)))

        def relabel(perm):
            cols = [None] * g.n
            for v in range(g.n):
                cols[perm[v]] = g.colors[v]
            return cols, sorted((perm[u], perm[v]) for u, v in g.edges)
        assert relabel(canon._canonical_labeling(g.n, g.colors, g.edges)) \
            == relabel(canonical_labeling_py(g.n, list(g.colors),
                                             list(g.edges)))


def test_native_library_builds_under_the_checkout():
    from feinsum_tpu_torch.native import build

    if build.load_canon() is None:
        pytest.skip("g++ unavailable: the native core cannot be built")
    assert build.BUILD_DIR.parts[-3:] == ("build", "feinsum_tpu_torch",
                                          "native")
    assert list(build.BUILD_DIR.glob("canon-*.so"))

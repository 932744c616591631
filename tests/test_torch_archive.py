"""The port's archive (``feinsum_tpu_torch.sql_utils``) held to the JAX
package's, on a copy of the shipped archive in a temporary directory (the
shipped file is only copied): the same rows for every einsum there,
the same ranking, a record -> query -> retrieve round trip that both
packages read alike, the non-destructive retire, and the shipped fp64 dd
fact replayed through the port's ``dd_pallas_v0`` and validated on CPU at the
float64 oracle's 1e-12."""

from __future__ import annotations

import shutil
import sqlite3
from pathlib import Path

import numpy as np
import pytest

import feinsum_tpu as fr
import feinsum_tpu_torch as ft
from feinsum_tpu import sql_utils as ref_sql
from feinsum_tpu_torch import sql_utils, suite as S
from feinsum_tpu_torch.interop import einsum_from_reference

SHIPPED = (Path(__file__).resolve().parents[1] / "feinsum_tpu" / "data"
           / "transform_archive_v1_tpu.sqlite")
TPU = "TPU_v5_lite"


def _to_reference(e):
    return fr.batched_einsum(e.get_subscripts(), [
        [fr.array(a.name, tuple(d.name if isinstance(d, ft.SizeParam)
                                else d for d in a.shape), a.dtype)
         for a in row] for row in e.args])


def _facts(qs):
    return [(q.transform_id, q.transform_params, q.runtime_in_sec,
             q.compiler_version, q.giga_op_info_json) for q in qs]


@pytest.fixture
def archive(tmp_path):
    db = tmp_path / "archive.sqlite"
    shutil.copy(SHIPPED, db)
    return str(db)


def test_query_returns_the_reference_rows(archive):
    ref_einsums = ref_sql.get_timed_einsums_in_db(db_path=archive)
    assert len(ref_einsums) > 50
    for e in ref_einsums:
        ours = sql_utils.query(einsum_from_reference(e), ft.FakeDevice(TPU),
                               db_path=archive)
        ref = ref_sql.query(e, fr.FakeDevice(TPU), db_path=archive)
        assert _facts(ours) == _facts(ref)
        assert {q.device_name for q in ours} == {TPU}
        assert [q.transform_id for q in
                sql_utils.aggregate_reconfirmations(ours)] == \
            [q.transform_id for q in ref_sql.aggregate_reconfirmations(ref)]
        assert _facts(sql_utils.aggregate_reconfirmations(ours)) == \
            _facts(ref_sql.aggregate_reconfirmations(ref))


def test_device_keys_select_rows(archive):
    div = S.make_div(35, "float64")
    assert sql_utils.query(div, "TPU v5 lite", db_path=archive)
    assert sql_utils.query(div, ft.FakeCLDevice(TPU), db_path=archive)
    assert not sql_utils.query(div, ft.FakeDevice("NVIDIA H100 80GB HBM3"),
                               db_path=archive, err_if_no_results=False)
    with pytest.raises(ft.NoFactInDatabaseError):
        sql_utils.query(div, "cpu", db_path=archive)


def test_missing_archive_holds_no_facts(tmp_path):
    db = tmp_path / "none.sqlite"
    assert sql_utils.query(S.make_mass(5, "float64"), "cpu", db_path=str(db),
                           err_if_no_results=False) == []
    assert sql_utils.get_timed_einsums_in_db(db_path=str(db)) == []
    assert not db.exists()


def test_record_query_retrieve_round_trip(tmp_path):
    """A fresh archive: the port records facts, reads them back and
    retrieves the faster configuration; the JAX package reads the same rows
    from the port-written file."""
    db = str(tmp_path / "fresh.sqlite")
    e = S.make_div(7, "float64")
    key = "NVIDIA_H100_80GB_HBM3"
    dev = ft.FakeDevice(key)
    for params, rt in (({"log2_block": 9, "blkc128": 0}, 2e-3),
                       ({"log2_block": 10, "blkc128": 0}, 1e-3),
                       ({"log2_block": 9, "blkc128": 0}, 4e-3)):
        sql_utils.record_facts(e, transform_id="dd_pallas_v0.py",
                               transform_params=params, runtime_in_sec=rt,
                               device=dev, db_path=db, long_dim_length=1000)
    qs = sql_utils.query(e, dev, db_path=db)
    assert [(dict(q.transform_params), q.runtime_in_sec) for q in qs] == [
        ({"log2_block": 9, "blkc128": 0}, 2e-3),
        ({"log2_block": 10, "blkc128": 0}, 1e-3),
        ({"log2_block": 9, "blkc128": 0}, 4e-3)]
    assert all(sql_utils.TIMING_PROTOCOL_TAG in q.compiler_version
               and q.compiler_version.startswith("torch-") for q in qs)
    gops = sum(ft.measure.evaluate_giga_op_map(
        ft.get_giga_op_map(e), 1000).values())
    assert qs[1].total_giga_op_rate == pytest.approx(gops / 1e-3, rel=1e-12)
    ranked = sql_utils.aggregate_reconfirmations(qs)
    # the config timed twice ranks by the slower of its two rows
    assert [(dict(q.transform_params), q.runtime_in_sec)
            for q in ranked] == [({"log2_block": 10, "blkc128": 0}, 1e-3),
                                 ({"log2_block": 9, "blkc128": 0}, 4e-3)]

    program = sql_utils.apply_best_transform(e, dev, db_path=db)
    assert program.descriptor.dd_pairs and \
        program.descriptor.block_long == 1024
    ft.validate_batched_einsum_transform(
        e, sql_utils.retrieve(e, dev, db_path=db), long_dim_length=300)

    ref_rows = ref_sql.query(_to_reference(e), fr.FakeDevice(key),
                             db_path=db)
    assert _facts(ref_rows) == _facts(qs)


def test_retire_is_non_destructive(archive):
    def count(table):
        with sqlite3.connect(archive) as conn:
            return conn.execute(f"SELECT COUNT(*) FROM {table}").fetchone()[0]
    total = count(sql_utils.TIMINGS_TABLENAME)
    moved = sql_utils.retire_rows_where(
        "transform_id = ?", ["xla_v0.py"], reason="test", db_path=archive)
    assert moved > 0
    assert count(sql_utils.TIMINGS_TABLENAME) == total - moved
    assert count(sql_utils.RETIRED_TABLENAME) == moved
    with sqlite3.connect(archive) as conn:
        assert {r[0] for r in conn.execute(
            f"SELECT retire_reason FROM {sql_utils.RETIRED_TABLENAME}")} \
            == {"test"}


def test_shipped_dd_fact_replays_through_the_port(archive):
    """The archived TPU fact (``ik,il,kjl -> ij``, ``dd_pallas_v0.py``,
    ``log2_block`` 12, ``vmem_idx`` 2) binds to the port's space and the
    program it gives validates on CPU (the kernel's plain version) at the
    float64 oracle's 1e-12."""
    div = S.make_div(35, "float64")
    assert ft.canonicalize_einsum(div).get_subscripts() == "ik,il,kjl -> ij"
    (fact,) = [q for q in sql_utils.query(div, ft.FakeDevice(TPU),
                                          db_path=archive)
               if q.transform_id == "dd_pallas_v0.py"]
    assert dict(fact.transform_params) == {
        "blkc128": 0, "log2_block": 12, "parallel_grid": True,
        "vmem_idx": 2}
    program = fact.transform(ft.generate_program(div))
    d = program.descriptor
    assert (d.backend, d.dd_pairs, d.block_long, d.dimension_semantics,
            d.vmem_limit_bytes) == ("pallas", True, 4096, "parallel", None)
    ft.validate_batched_einsum_transform(div, fact.transform,
                                         long_dim_length=1000, rtol=1e-12)


def test_fp64_ladder_over_the_shipped_facts(archive):
    """bench.py's ladder v3 on the TPU facts: the three fastest archived
    configurations, then the dd built-in (a dd fact exists), then the
    default."""
    div = S.make_div(35, "float64")
    dev = ft.FakeDevice(TPU)
    ladder = list(S.candidate_transforms("div", div, db_path=archive,
                                         device=dev))
    ref = ref_sql.aggregate_reconfirmations(ref_sql.query(
        _to_reference(div), fr.FakeDevice(TPU), db_path=archive))
    assert [c.fact.transform_id for c in ladder[:3]] == \
        [q.transform_id for q in ref[:3]]
    assert [c.label.split(": ")[1] for c in ladder[3:]] == [
        "built-in dd_pallas_v0", "built-in default"]
    assert ladder[3].fact is None
    builtin = ladder[3].transform(ft.generate_program(div)).descriptor
    assert builtin.dd_pairs and builtin.block_long == S.BLOCK_LONG
    # f32 rows get four archived rungs and no dd built-in
    f32 = list(S.candidate_transforms("div32", S.make_div(35), db_path=archive,
                                      device=dev))
    assert len(f32) == 5 and all(c.fact for c in f32[:4])


def test_ladder_without_facts_is_the_default(tmp_path):
    mass = S.make_mass(5, "float64")
    (only,) = S.candidate_transforms("mass", mass, device="cpu",
                                     db_path=str(tmp_path / "x.sqlite"))
    assert only.fact is None
    program = only.transform(ft.generate_program(mass))
    assert program.descriptor.backend == "xla"
    np.testing.assert_equal(program.descriptor.dd_pairs, False)

"""The port's tuner (``feinsum_tpu_torch.tuning``) held to the JAX
package's: the parameter DSL draws, mutates and checks alike for the same
seeds; the port's ``dd_pallas_v0`` binds every parameter set of the
reference's space into the reference's schedule (minus the TPU's VMEM cap);
and ``autotune`` on CPU (float64 rows at E = 1000, the ``dd_rows`` plain
version, host timings under the key ``"cpu"``) records its points, seeds a
second run from them and measures no configuration twice."""

from __future__ import annotations

import itertools
import sqlite3

import numpy as np
import pytest

import feinsum_tpu as fr
import feinsum_tpu.tuning as rt
import feinsum_tpu_torch as ft
import feinsum_tpu_torch.tuning as pt
from feinsum_tpu_torch import sql_utils, suite as S
from feinsum_tpu_torch.interop import program_from_reference

SPACES = {
    "int": ("IntParameter", (3, 40)),
    "bool": ("BoolParameter", ()),
    "perm": ("PermutationParameter", (5,)),
}


def _pair(kind):
    cls, args = SPACES[kind]
    return getattr(pt, cls)(*args), getattr(rt, cls)(*args)


@pytest.mark.parametrize("kind", sorted(SPACES) + ["tuple"])
def test_dsl_draws_and_mutates_alike(kind):
    if kind == "tuple":
        ours = pt.TupleParameter((pt.IntParameter(0, 9), pt.BoolParameter()))
        ref = rt.TupleParameter((rt.IntParameter(0, 9), rt.BoolParameter()))
    else:
        ours, ref = _pair(kind)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(50):
        a, b = ours.sample(r1), ref.sample(r2)
        assert a == b
        assert ours.mutate(a, r1) == ref.mutate(b, r2)
        assert ours.contains(a) and ref.contains(b)
    for bad in (-1, 41, (0, 1), "x", (1, 2, 3, 4, 9)):
        assert ours.contains(bad) == ref.contains(bad)


def test_space_flattening_matches():
    space = {"b": pt.TupleParameter((pt.IntParameter(0, 3),
                                     pt.BoolParameter())),
             "a": pt.IntParameter(1, 2)}
    ref_space = {"b": rt.TupleParameter((rt.IntParameter(0, 3),
                                         rt.BoolParameter())),
                 "a": rt.IntParameter(1, 2)}
    assert [k for k, _ in pt._flatten_space(space)] == \
        [k for k, _ in rt._flatten_space(ref_space)]
    params = {"a": 2, "b": (3, True)}
    cfg = pt._params_to_config(space, params)
    assert cfg == rt._params_to_config(ref_space, params)
    assert pt._config_to_params(space, cfg) == params
    assert pt.validate_params_in_space(space, params)
    assert not pt.validate_params_in_space(space, {"a": 2})


def test_decorators_build_a_parametrized_transform():
    @pt.einsum_arg("n_rows", lambda e: e.b)
    @pt.transform_param("k", lambda e: pt.IntParameter(1, e.b))
    def transform(program, n_rows, k):
        return program.with_descriptor(block_long=64 * n_rows * k)

    e = S.make_div(4, "float64")
    assert isinstance(transform, pt.ParametrizedTransform)
    assert transform.get_param_space(e) == {"k": pt.IntParameter(1, 3)}
    prog = transform(ft.generate_program(e), k=2)
    assert prog.descriptor.block_long == 64 * 3 * 2


def _reference_einsum(e):
    return fr.batched_einsum(e.get_subscripts(), [
        [fr.array(a.name, tuple(d.name if isinstance(d, ft.SizeParam) else d
                                for d in a.shape), a.dtype)
         for a in row] for row in e.args])


@pytest.mark.parametrize("name", ["dg_div_ndof35_fp64",
                                  "dg_face_mass_fp64"])
def test_dd_space_binds_every_reference_parameter_set(name):
    e = dict(S.fp64_suite())[name]
    r = _reference_einsum(e)
    ours = pt.get_transform_func_from_module_path("dd_pallas_v0")
    ref = rt.get_transform_func_from_module_path("dd_pallas_v0")
    ref_space = ref.get_param_space(r)
    # the port searches the two block parameters, with the reference's
    # ranges
    assert set(ours.get_param_space(e)) == {"log2_block", "blkc128"}
    for k, p in ours.get_param_space(e).items():
        assert (p.low, p.high) == (ref_space[k].low, ref_space[k].high)
    names = sorted(ref_space)
    values = [range(ref_space[k].low, ref_space[k].high + 1)
              if isinstance(ref_space[k], rt.IntParameter) else (False, True)
              for k in names]
    n_bound = n_compared = 0
    for combo in itertools.product(*values):
        params = dict(zip(names, combo))
        got = ours.bind_args(e, **params)(ft.generate_program(e))
        n_bound += 1
        try:
            want = ref.bind_args(r, **params)(fr.generate_program(r))
        except fr.InvalidParameterError as err:
            # the reference's TPU VMEM guard; a Hopper block's shared
            # memory does not depend on the block length
            assert "VMEM" in str(err)
            continue
        want = program_from_reference(want)
        assert got.descriptor == want.descriptor.copy(vmem_limit_bytes=None)
        assert got.schedule == want.schedule
        n_compared += 1
    assert n_bound == 8 * 17 * 2 * 3
    assert n_compared > n_bound // 2


def test_missing_space_raises():
    with pytest.raises(FileNotFoundError):
        pt.get_transform_func_from_module_path("no_such_space")


def _rows(db):
    with sqlite3.connect(db) as conn:
        return conn.execute(
            "SELECT device_name, transform_id, transform_params,"
            " runtime_in_sec FROM FEINSUM_TIMING_FACTS").fetchall()


@pytest.mark.parametrize("name", ["dg_div", "dg_grad"])
def test_autotune_on_cpu_records_and_resumes(tmp_path, name):
    e = {"dg_div": S.make_div(6, "float64"),
         "dg_grad": S.make_grad(5, "float64")}[name]
    db = str(tmp_path / "tune.sqlite")
    ft.autotune(e, "dd_pallas_v0", db_path=db, device="cpu",
                long_dim_length=1000, test_limit=3)
    first = _rows(db)
    assert len(first) == 3
    assert {r[0] for r in first} == {"cpu"}
    assert {r[1] for r in first} == {"dd_pallas_v0.py"}
    assert all(r[3] > 0 for r in first)
    facts = ft.query(e, "cpu", db_path=db)
    assert [dict(q.transform_params) for q in facts] == [
        sql_utils.load_transform_params(r[2]) for r in first]

    # a second run with the same seed seeds from the archive: it measures
    # three new configurations and none twice
    ft.autotune(e, "dd_pallas_v0", db_path=db, device="cpu",
                long_dim_length=1000, test_limit=3)
    both = _rows(db)
    assert both[:3] == first and len(both) == 6
    assert len({r[2] for r in both}) == 6


def test_autotune_seed_configs_come_first(tmp_path):
    e = S.make_mass(5, "float64")
    db = str(tmp_path / "tune.sqlite")
    seeds = [{"log2_block": 9, "blkc128": 0}, {"log2_block": 8, "blkc128": 0}]
    ft.autotune(e, "dd_pallas_v0", db_path=db, device="cpu",
                long_dim_length=500, test_limit=2, seed_configs=seeds)
    assert [dict(q.transform_params) for q in
            ft.query(e, "cpu", db_path=db)] == seeds


def test_autotune_shards_split_the_proposals(tmp_path):
    e = S.make_mass(4, "float64")
    db = str(tmp_path / "tune.sqlite")
    for shard in ((0, 2), (1, 2)):
        ft.autotune(e, "dd_pallas_v0", db_path=db, device="cpu",
                    long_dim_length=300, test_limit=2, shard=shard)
    params = [r[2] for r in _rows(db)]
    assert len(params) == len(set(params)) == 4


def test_autotune_scores_guard_rejections_without_recording(tmp_path):
    """A float32 einsum is outside the fp64 space: every point is a guard
    rejection, the run ends and records nothing."""
    db = tmp_path / "tune.sqlite"
    ft.autotune(S.make_matvec(6), "dd_pallas_v0", db_path=str(db),
                device="cpu", long_dim_length=200, test_limit=2)
    assert not db.exists()


def test_record_facts_times_when_no_runtime_is_given(tmp_path):
    """``record_facts`` with no runtime validates and times the
    configuration on the device it names (here the host, key ``"cpu"``)."""
    db = str(tmp_path / "facts.sqlite")
    e = S.make_mass(4, "float64")
    sql_utils.record_facts(e, transform_id="dd_pallas_v0.py",
                           transform_params={"log2_block": 9, "blkc128": 0},
                           runtime_in_sec=None, device="cpu", db_path=db,
                           long_dim_length=300)
    (row,) = _rows(db)
    assert row[0] == "cpu" and row[1] == "dd_pallas_v0.py" and row[3] > 0

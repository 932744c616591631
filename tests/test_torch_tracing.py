"""The port's spans and counters (``feinsum_tpu_torch/tracing.py``) on the
CPU: the spans a model's step records under the torch profiler, nothing
entered without one, the set-up counters, the launch counter, the pair
conversions of a float64 step (their spans inside the step's, their bytes
and the steps counted by hand), the hexahedral model's step (its spans,
``step_block_f32``'s launches counted by table mode through a stand-in
library), the ADER element's step (its predictor and corrector spans, the
predictor's launches counted), one launch span per launch under its
kernel's span and its executable's (named by the model's einsums), the
path counters against the spans, and the benchmark's readers of the spans
and counters (``benchmark_torch/metrics/``, ``launch_spans.py``) on
synthetic runs; the viscoelastic ADER element's step likewise, its
``feinsum.ader:anelastic`` spans and ``anelastic_launches``, and the
readers of them.  This file imports no JAX."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import feinsum_tpu_torch as ft
from feinsum_tpu_torch import sql_utils, tracing
from feinsum_tpu_torch.models.maxwell import make_maxwell_state
from feinsum_tpu_torch.models.wave import make_wave_state
from feinsum_tpu_torch.ops import kernels

BENCH = Path(__file__).resolve().parents[1] / "benchmark_torch"
E = 64
# each model, its input draw and its executables in the order a step calls
# them
MODELS = {"wave": (ft.WaveOperator3D, make_wave_state,
                   ("grad", "div", "restrict", "face")),
          "maxwell": (ft.MaxwellOperator3D, make_maxwell_state,
                      ("curl", "curl"))}


def _model(key):
    cls, make_state, execs = MODELS[key]
    op = cls()
    state, geom = make_state(E, seed=1, device="cpu")
    return op, op.make_step(E), state, geom


def _spans(prof, prefix):
    return [(ev.name, ev.time_range.start, ev.time_range.end)
            for ev in prof.events() if ev.name.startswith(prefix)]


@pytest.mark.parametrize("key", sorted(MODELS))
def test_a_step_records_its_step_and_executable_spans(key):
    op, step, state, geom = _model(key)
    step(state, geom)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, geom)
    (s_name, s_lo, s_hi), = _spans(prof, "feinsum.step:")
    assert s_name == f"feinsum.step:{type(op).__name__}"
    execs = sorted(_spans(prof, "feinsum.exec:"), key=lambda s: s[1])
    assert [name for name, _, _ in execs] == [
        f"feinsum.exec:{n}" for n in MODELS[key][2]]
    assert all(s_lo <= lo <= hi <= s_hi for _, lo, hi in execs)
    # CPU tensors take the kernels' plain versions: no wrapper or launch
    # span
    assert not _spans(prof, "feinsum.kernel:")
    assert not _spans(prof, "feinsum.launch:")


@pytest.mark.parametrize("key", sorted(MODELS))
def test_no_profiler_enters_no_span_and_changes_no_output(key, monkeypatch):
    _, step, state, geom = _model(key)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    untraced = step(state, geom)
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = step(state, geom)
    assert untraced.keys() == traced.keys()
    for k in untraced:
        assert torch.equal(untraced[k], traced[k])


@pytest.mark.parametrize("recording", [False, True])
def test_an_exception_passes_through_a_span(recording):
    with contextlib.ExitStack() as stack:
        if recording:
            stack.enter_context(profile(activities=[ProfilerActivity.CPU]))
        with pytest.raises(KeyError):
            with tracing.span("feinsum.kernel:dg_rows_f32"):
                raise KeyError("inside")


def test_build_and_lookup_counters(tmp_path):
    c = tracing.counters
    op = ft.WaveOperator3D()
    builds, seconds = c["executable_builds"], c["executable_build_s"]
    ft.build_executable(op.programs["grad"], long_dim_length=4321)
    assert c["executable_builds"] == builds + 1
    assert c["executable_build_s"] > seconds
    step = op.make_step(E)
    state, geom = make_wave_state(E, seed=2, device="cpu")
    after_setup = (c["executable_builds"], c["library_loads"])
    ft.build_executable(op.programs["grad"], long_dim_length=4321)
    step = op.make_step(E)
    for _ in range(10):
        state = step(state, geom)
    assert (c["executable_builds"], c["library_loads"]) == after_setup

    db = str(tmp_path / "archive.sqlite")
    sql_utils.record_facts(op.restrict_einsum, transform_id="t",
                           transform_params={}, runtime_in_sec=1e-3,
                           device="cpu", db_path=db)
    queries, seconds = c["archive_queries"], c["archive_query_s"]
    assert len(sql_utils.query(op.restrict_einsum, "cpu", db_path=db)) == 1
    assert c["archive_queries"] == queries + 1
    assert c["archive_query_s"] > seconds


@pytest.mark.parametrize("name", ["feinsum.executable.build",
                                  "feinsum.library.load",
                                  "feinsum.archive.query"])
def test_a_set_up_span_counts_and_times_itself(name):
    count, seconds = tracing._SETUP[name]
    c = tracing.counters
    before = c[count], c[seconds]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        with tracing.setup(name):
            time.sleep(0.01)
        took = time.perf_counter() - t0
    assert c[count] == before[0] + 1
    assert 0.01 <= c[seconds] - before[1] <= took
    (_, lo, hi), = _spans(prof, name)
    assert hi - lo >= 1e4                      # microseconds


def test_launch_counter_is_the_one_dict_and_resets():
    assert kernels.launch_counts is tracing.counters["launches"]
    saved = dict(kernels.launch_counts)
    try:
        for name in kernels.launch_counts:
            tracing.count_launch(name)
        assert all(n >= 1 for n in kernels.launch_counts.values())
        kernels.reset_launch_counts()
        assert set(kernels.launch_counts.values()) == {0}
    finally:
        kernels.launch_counts.update(saved)


@pytest.mark.parametrize("counter", ["dg_rows_f32_path", "dd_rows_path"])
def test_path_counters_reset_with_the_launches(counter):
    """Each kernel's launches by path, one count a path, zeroed with the
    launch counts."""
    paths = tracing.counters[counter]
    assert set(paths) == {"tiled", "general"}
    saved = dict(paths)
    try:
        for path in paths:
            paths[path] += 1
        kernels.reset_launch_counts()
        assert paths == {"tiled": 0, "general": 0}
    finally:
        paths.update(saved)


# {{{ pair conversions of a float64 step

P, PF, NF = 35, 15, 4
# entries a step converts, by hand, as (split, combined): wave splits u (P)
# and v (3P), and its update combines grad (3P), the three div rows (P
# each) and the lift (P); Maxwell splits E and H (3P each), and its updates
# combine the curl's six rows twice (P each)
STEP_ENTRIES = {"wave": (4 * P, 7 * P), "maxwell": (6 * P, 12 * P)}
# the geometry, split once: wave's J (9), Jx, Jy, Jz (3 each) and Fj (4)
# an element, D, L and Rface; Maxwell's Jx, Jy, Jz and D
GEOM_ENTRIES = {"wave": (22, 3 * P * P + 2 * NF * PF * P),
                "maxwell": (9, 3 * P * P)}


@pytest.mark.parametrize("key", sorted(MODELS))
def test_pair_spans_nest_in_the_step_and_their_bytes_count(key,
                                                           monkeypatch):
    """A float64 step on pair storage: every ``pairs_split`` wrapper span
    lies inside the ``feinsum.step`` span, one for each tensor split, no
    combine is a conversion of its own (the update reads the pairs), and
    ``pair_bytes`` / ``model_steps`` equal the hand count at E = 96 (16
    bytes an entry split, 8 an entry combined in the update); the geometry
    is split on the first step and again only for a tensor written in
    place or replaced.  The wrappers run their CUDA branch against a
    stand-in library (no kernel runs, so no value is checked)."""
    _stand_in(monkeypatch)
    n = 96
    cls, make_state, _ = MODELS[key]
    op = cls(dtype="float64")
    state, geom = make_state(n, dtype="float64", seed=4, device="cpu")
    step = op.make_step(n)
    c = tracing.counters
    start = c["pair_bytes"], c["model_steps"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = step(state, geom)
    (_, s_lo, s_hi), = _spans(prof, "feinsum.step:")
    pairs = _spans(prof, "feinsum.kernel:pairs_split")
    per_elem, fixed = GEOM_ENTRIES[key]
    n_geom = 8 if key == "wave" else 4
    assert len(pairs) == n_geom + 2
    assert not _spans(prof, "feinsum.pairs:")
    assert all(s_lo <= lo <= hi <= s_hi for _, lo, hi in pairs)
    split, combined = STEP_ENTRIES[key]
    step_bytes = (16 * split + 8 * combined) * n
    geom_bytes = 16 * (per_elem * n + fixed)
    assert c["pair_bytes"] - start[0] == geom_bytes + step_bytes
    assert c["model_steps"] - start[1] == 1
    state = step(state, geom)                  # the geometry's pairs held
    assert c["pair_bytes"] - start[0] == geom_bytes + 2 * step_bytes
    geom["Jx"].mul_(1.0)                       # written in place: split again
    geom = dict(geom, D=geom["D"].clone())     # another tensor: split again
    step(state, geom)
    assert c["pair_bytes"] - start[0] == geom_bytes + 3 * step_bytes \
        + 16 * (3 * n + 3 * P * P)
    assert c["model_steps"] - start[1] == 3


def test_a_float32_step_counts_steps_and_no_pair_bytes():
    op, step, state, geom = _model("wave")
    c = tracing.counters
    start = c["pair_bytes"], c["model_steps"]
    step(state, geom)
    assert (c["pair_bytes"], c["model_steps"]) == (start[0], start[1] + 1)

# }}}


# {{{ the benchmark's readers

def _reader(name):
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


HOST_READERS = ("glue_host_ms_per_step", "exec_host_ms_per_step",
                "kernel_host_ms_per_step")


def _step_spans(t0):
    """One step at *t0* (seconds): 10 ms, two executables of 3 and 2 ms
    holding kernel wrappers of 1 and 0.5 ms, a wrapper span outside any
    executable (glue), other host operations around."""
    return [("feinsum.step:Op", t0, t0 + 0.010),
            ("aten::add", t0 + 0.0005, t0 + 0.0006),
            ("feinsum.exec:a", t0 + 0.001, t0 + 0.004),
            ("feinsum.kernel:k", t0 + 0.002, t0 + 0.003),
            ("aten::empty", t0 + 0.0021, t0 + 0.0022),
            ("feinsum.exec:b", t0 + 0.005, t0 + 0.007),
            ("feinsum.kernel:k", t0 + 0.0055, t0 + 0.006),
            ("feinsum.kernel:k", t0 + 0.008, t0 + 0.0085)]


def _run(host, steps):
    return SimpleNamespace(trace=SimpleNamespace(host=host, steps=steps))


def test_host_readers_split_the_step_span():
    host = _step_spans(1.0) + _step_spans(2.0)
    # an executable outside any step (set-up) is no step's
    host += [("feinsum.exec:a", 3.0, 3.5), ("feinsum.kernel:k", 3.1, 3.2)]
    got = {name: _reader(name)(_run(host, 2)) for name in HOST_READERS}
    assert got["kernel_host_ms_per_step"] == pytest.approx(1.5)
    assert got["exec_host_ms_per_step"] == pytest.approx(2.0 + 1.5)
    assert got["glue_host_ms_per_step"] == pytest.approx(10 - 5)
    assert sum(got.values()) == pytest.approx(10.0)


@pytest.mark.parametrize("host,steps", [
    ([], 2),                                   # the parent: no spans
    ([("bench.step", 1.0, 1.01)], 1),
    (_step_spans(1.0), 2),                     # a count that does not match
    (_step_spans(1.0) + _step_spans(2.0), 1),
])
def test_host_readers_read_nothing_without_one_span_per_step(host, steps):
    for name in HOST_READERS:
        assert _reader(name)(_run(host, steps)) is None
        assert _reader(name)(SimpleNamespace(trace=None)) is None


def test_setup_program_s_reads_the_counters():
    c = tracing.counters
    want = c["executable_build_s"] + c["library_load_s"] + c["archive_query_s"]
    assert _reader("setup_program_s")(_run([], 1)) == want


def _f64_run(device, steps=4):
    """A synthetic traced run of the float64 cell at E = 1,000."""
    cfg = json.loads((BENCH / "configs" / "wave3d_p4_f64.json").read_text())
    peaks = {"flops": {"float32": 67e12, "float64": 34e12},
             "bytes_per_s": 3.35e12}
    return SimpleNamespace(cfg=cfg, n_elements=1000, peaks=peaks,
                           step_s=0.002, trace=SimpleNamespace(
                               device=device, steps=steps, host=[]))


DD = "void (anonymous namespace)::dd_rows_kernel<false, 3>(DDRows, int)"
ADD = "void at::native::vectorized_elementwise_kernel<4, add>(...)"


def test_fp64_readers_on_a_synthetic_trace():
    """``dd_rows_roofline`` (the einsums' float64 least time over the
    ``dd_rows`` device time per step), ``fp64_glue_ms_per_step`` (PyTorch's
    kernels), ``step_mfu_fp64`` (``step_mfu``'s arithmetic)."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    import yardstick
    run = _f64_run([(DD, 0.0, 0.004), (ADD, 0.004, 0.010),
                    ("memcpy HtoD", 0.010, 0.011), (DD, 0.011, 0.015)])
    least = yardstick.einsums_least_time(run.cfg, 1000, run.peaks)
    assert _reader("dd_rows_roofline")(run) == pytest.approx(
        100 * least / (0.008 / 4))
    assert _reader("fp64_glue_ms_per_step")(run) == pytest.approx(
        1e3 * 0.007 / 4)
    flops, nbytes = yardstick.step_counts(run.cfg, 1000)
    assert flops == 1000 * 38805 and nbytes == 8 * (
        2 * 140 * 1000 + 22 * 1000 + 3 * P * P + 2 * NF * PF * P)
    assert _reader("step_mfu_fp64")(run) == pytest.approx(
        100 * max(flops / 34e12, nbytes / 3.35e12) / 0.002)
    assert _reader("step_mfu_fp64")(run) == _reader("step_mfu")(run)
    no_dd = _f64_run([(ADD, 0.0, 0.001)])
    assert _reader("dd_rows_roofline")(no_dd) is None
    for name in ("dd_rows_roofline", "fp64_glue_ms_per_step",
                 "step_mfu_fp64"):
        assert _reader(name)(SimpleNamespace(trace=None, peaks=None)) is None


UPDATE = ("void (anonymous namespace)::step_update_kernel<double, 4, true>"
          "((anonymous namespace)::UpdateArgs, double)")
SPLIT = "void (anonymous namespace)::pairs_split_kernel<true>(double const*)"


def test_update_ms_per_step_reads_the_update_kernels():
    """``update_ms_per_step``: the device time per step of the
    ``step_update`` and ``pairs_split`` launches, no other kernel's and no
    span's shadow; nothing where neither ran (the parent)."""
    run = _f64_run([(DD, 0.0, 0.004), (UPDATE, 0.004, 0.006),
                    (SPLIT, 0.006, 0.0065), (ADD, 0.0065, 0.007),
                    (UPDATE, 0.007, 0.008)], steps=2)
    assert _reader("update_ms_per_step")(run) == pytest.approx(
        1e3 * 0.0035 / 2)
    assert _reader("update_ms_per_step")(_f64_run([(DD, 0.0, 0.004),
                                                   (ADD, 0.004, 0.01)])) \
        is None
    assert _reader("update_ms_per_step")(SimpleNamespace(trace=None)) \
        is None


def test_pair_bytes_per_step_reads_the_counters(monkeypatch):
    read = _reader("pair_bytes_per_step")
    monkeypatch.setattr(tracing, "counters",
                        {"pair_bytes": 6000, "model_steps": 3})
    assert read(_run([], 1)) == 2000
    # the parent: no such counters, or no step yet
    monkeypatch.setattr(tracing, "counters", {"launches": {}})
    assert read(_run([], 1)) is None
    monkeypatch.setattr(tracing, "counters",
                        {"pair_bytes": 0, "model_steps": 0})
    assert read(_run([], 1)) is None

# }}}


# {{{ the hexahedral model

HEX_EXECS = ("grad_axes", "grad_metric", "div_metric", "div_1", "div_2",
             "div_3")


def test_a_hex_step_nests_its_executable_spans_and_counts_itself():
    op = ft.HexWaveOperator3D()
    state, geom = ft.make_hexwave_state(E, seed=1, device="cpu")
    step = op.make_step(E)
    step(state, geom)
    c = tracing.counters
    steps = c["model_steps"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, geom)
    assert c["model_steps"] == steps + 1
    (s_name, s_lo, s_hi), = _spans(prof, "feinsum.step:")
    assert s_name == "feinsum.step:HexWaveOperator3D"
    execs = sorted(_spans(prof, "feinsum.exec:"), key=lambda s: s[1])
    assert [name for name, _, _ in execs] == [
        f"feinsum.exec:{n}" for n in HEX_EXECS]
    assert all(s_lo <= lo <= hi <= s_hi for _, lo, hi in execs)
    assert not _spans(prof, "feinsum.kernel:")


class _StandIn:
    """A stand-in kernel library whose every entry returns 0 (no kernel
    runs); it keeps ``step_block_f32``'s path codes and the lanes entry's
    calls in *paths*."""

    def __init__(self, paths):
        self.paths = paths

    def __getattr__(self, entry):
        if entry.endswith("_max_rows"):
            return lambda: 8
        if entry == "step_block_f32":
            return lambda *args: self.paths.append(args[16]) or 0
        if entry == "step_block_lanes_f32":
            return lambda *args: self.paths.append("lanes") or 0
        return lambda *args: 0


def _keep_launch_counts(monkeypatch):
    """Restore the launch and path counts when the test ends."""
    for key in ("launches", *tracing.PATH_COUNTERS.values()):
        for name, count in tracing.counters[key].items():
            monkeypatch.setitem(tracing.counters[key], name, count)


def _stand_in(monkeypatch):
    """Run every kernel wrapper's CUDA branch on CPU tensors against
    :class:`_StandIn`, inside the wrapper's span as ``launch_frame`` does
    and through its ``launch`` (``kernels.launcher``: the launch span, the
    counts), no stream; the list that keeps the path codes.  The launch
    and path counts are restored when the test ends."""
    paths = []
    _keep_launch_counts(monkeypatch)

    def frame(name, device, plain, body):
        with tracing.span(f"feinsum.kernel:{name}"):
            return body(_StandIn(paths), kernels.launcher(name, device))
    monkeypatch.setattr(kernels, "launch_frame", frame)
    monkeypatch.setattr(kernels, "_stream_of", lambda device: None)
    return paths


def test_step_block_mode_counts_one_entry_per_launch(monkeypatch):
    """Each ``step_block_f32`` launch counts once under its path: the
    hexahedral step's six, its two metric products on the stream path
    (path code 1 to the C entry) and four on the lanes path (the lanes
    entry), beside its two ``step_update`` launches; a table with a
    general step counts as general.  The wrappers run their CUDA branch on
    CPU tensors against a stand-in library whose every entry returns 0 (no
    kernel runs)."""
    from feinsum_tpu_torch.ops.step_block import plan_step_block
    paths = _stand_in(monkeypatch)
    modes = tracing.counters["step_block_mode"]
    kernels.reset_launch_counts()
    op = ft.HexWaveOperator3D()
    state, geom = ft.make_hexwave_state(E, seed=2, device="cpu")
    op.make_step(E)(state, geom)
    assert modes == {"dense": 0, "general": 0, "stream": 2, "lanes": 4}
    assert paths == ["lanes", 1, 1, "lanes", "lanes", "lanes"]
    assert kernels.launch_counts["step_block_f32"] == 6
    assert kernels.launch_counts["step_update"] == 2
    # three operands in one step (the trivial schedule): general
    e = ft.einsum("ai,bj,eab->eij", ft.array("X", (3, 4), "float32"),
                  ft.array("Y", (3, 5), "float32"),
                  ft.array("U", ("E", 3, 3), "float32"))
    program = ft.generate_program(e).with_descriptor(backend="pallas")
    table = plan_step_block(program, {"a": 3, "b": 3, "i": 4, "j": 5,
                                      "e": 16})
    assert table.mode == "general"
    kernels.step_block_f32([[torch.rand(3, 4), torch.rand(3, 5),
                             torch.rand(16, 3, 3)]], table, block_long=8)
    assert modes == {"dense": 0, "general": 1, "stream": 2, "lanes": 4}
    kernels.reset_launch_counts()
    assert modes == {"dense": 0, "general": 0, "stream": 0, "lanes": 0}


def test_step_block_mode_counts_the_ader_step_on_the_lanes_path(
        monkeypatch):
    """An ADER step planned on the CPU: its six ``step_block_f32``
    launches count under ``"lanes"``, each through the lanes entry, beside
    six ``step_update`` launches; at a long axis that is not a multiple of
    4 all six keep the block kernel (``"dense"``, path code 0)."""
    paths = _stand_in(monkeypatch)
    modes = tracing.counters["step_block_mode"]
    op = ft.AderElasticOperator3D(device="cpu")
    for n, want in ((E, "lanes"), (E - 2, 0)):
        kernels.reset_launch_counts()
        paths.clear()
        state, geom = ft.make_ader_state(n, seed=3, device="cpu")
        op.make_step(n)(state, geom)
        key = "lanes" if want == "lanes" else "dense"
        assert modes == {**dict.fromkeys(modes, 0), key: 6}
        assert paths == [want] * 6
        assert kernels.launch_counts["step_block_f32"] == 6
        assert kernels.launch_counts["step_update"] == 6


@pytest.mark.parametrize("model", ["ader", "hex", "visco"])
def test_lane_chains_count_the_chained_pairs_of_a_step(monkeypatch, model):
    """``lane_chains`` grows at each lanes launch by the pairs its plan
    chains: 5 an ADER step (the four derivatives' and the flux's first two
    steps), 0 a hexahedral step (no pair of its lanes tables chains), 1 a
    viscoelastic ADER step (the flux's last two steps)."""
    _stand_in(monkeypatch)
    monkeypatch.setitem(tracing.counters, "lane_chains", 0)
    if model == "ader":
        op = ft.AderElasticOperator3D(device="cpu")
        state, geom = ft.make_ader_state(E, seed=3, device="cpu")
    elif model == "visco":
        op = ft.AderViscoelasticOperator3D(device="cpu")
        state, geom = ft.make_ader_visco_state(E, seed=3, device="cpu")
    else:
        op = ft.HexWaveOperator3D()
        state, geom = ft.make_hexwave_state(E, seed=2, device="cpu")
    step = op.make_step(E)
    for steps in (1, 2):
        step(state, geom)
        assert tracing.counters["lane_chains"] == steps * {
            "ader": 5, "hex": 0, "visco": 1}[model]

# }}}


# {{{ the hexahedral cell's readers

# the readers the hexahedral cell reports: its own roofline share, and the
# shared ones it is listed under
HEX_READERS = ("sumfact_roofline", "step_mfu", "launches_per_step",
               "update_ms_per_step", "device_idle_pct", "host_ms_per_step")
SB = ("void (anonymous namespace)::step_block_kernel<true>"
      "((anonymous namespace)::Plan)")
UPDATE32 = ("void (anonymous namespace)::step_update_kernel<float, 3, false>"
            "((anonymous namespace)::UpdateArgs, float)")


def _hex_run(device, steps=4, launches=32):
    """A synthetic traced run of the hexahedral cell at E = 1,000."""
    cfg = json.loads((BENCH / "configs" / "hexwave3d_q4.json").read_text())
    peaks = {"flops": {"float32": 67e12}, "bytes_per_s": 3.35e12}
    return SimpleNamespace(cfg=cfg, n_elements=1000, peaks=peaks,
                           step_s=0.002, trace=SimpleNamespace(
                               device=device, steps=steps, host=[],
                               launches=launches, window_s=0.01,
                               host_calls_s=[0.001, 0.003]))


def test_hex_readers_on_a_synthetic_trace():
    """The hexahedral cell's readers on a synthetic traced run:
    ``sumfact_roofline``, the step's least time (12,000 operations and
    8,500 bytes an element, D's 100 bytes once) over the device time per
    step of the program's launches but ``step_update``; ``step_mfu``, the
    same least time over the untraced time per step; ``launches_per_step``,
    the launch counter per traced step; ``update_ms_per_step``, the
    ``step_update`` launches per step; ``device_idle_pct`` and
    ``host_ms_per_step`` as in every cell."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    import yardstick
    run = _hex_run([(SB, 0.0, 0.003), (UPDATE32, 0.003, 0.004),
                    (ADD, 0.004, 0.005), ("memset", 0.005, 0.0051),
                    (SB, 0.006, 0.007)])
    flops, nbytes = yardstick.step_counts(run.cfg, 1000)
    assert (flops, nbytes) == (12000 * 1000, 8500 * 1000 + 100)
    least = nbytes / 3.35e12
    assert _reader("sumfact_roofline")(run) == pytest.approx(
        100 * least / (0.004 / 4))
    assert _reader("step_mfu")(run) == pytest.approx(100 * least / 0.002)
    assert _reader("launches_per_step")(run) == 8
    assert _reader("update_ms_per_step")(run) == pytest.approx(1e3 * 0.001
                                                               / 4)
    assert _reader("device_idle_pct")(run) == pytest.approx(
        100 * (1 - 0.0061 / 0.01))
    assert _reader("host_ms_per_step")(run) == pytest.approx(2.0)
    # nothing it reads: no trace, no peaks, or no launch but the update's
    only_update = _hex_run([(UPDATE32, 0.0, 0.001), (ADD, 0.001, 0.002)])
    assert _reader("sumfact_roofline")(only_update) is None
    for name in HEX_READERS:
        assert _reader(name)(SimpleNamespace(trace=None, peaks=None)) \
            is None
    for name in ("sumfact_roofline", "step_mfu"):
        assert _reader(name)(SimpleNamespace(
            trace=run.trace, peaks=None)) is None

# }}}


# {{{ the ADER element

# the ADER step's launches: its predictor's four derivatives and five bands
# of the time integral, then the volume and flux terms and the update
ADER_PREDICTOR = 9
ADER_LAUNCHES = {"step_block_f32": 6, "step_update": 6}


def test_an_ader_step_records_its_spans_and_counts_itself():
    """One step records ``feinsum.step:AderElasticOperator3D`` around its
    two halves, ``feinsum.ader:predictor`` (the four derivatives' executable
    spans) then ``feinsum.ader:corrector`` (the volume and flux terms'),
    and counts one model step."""
    op = ft.AderElasticOperator3D()
    state, geom = ft.make_ader_state(E, seed=1, device="cpu")
    step = op.make_step(E)
    step(state, geom)
    c = tracing.counters
    steps = c["model_steps"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, geom)
    assert c["model_steps"] == steps + 1
    (s_name, s_lo, s_hi), = _spans(prof, "feinsum.step:")
    assert s_name == "feinsum.step:AderElasticOperator3D"
    halves = sorted(_spans(prof, "feinsum.ader:"), key=lambda s: s[1])
    assert [name for name, _, _ in halves] == [
        "feinsum.ader:predictor", "feinsum.ader:corrector"]
    assert all(s_lo <= lo <= hi <= s_hi for _, lo, hi in halves)
    execs = sorted(_spans(prof, "feinsum.exec:"), key=lambda s: s[1])
    for (_, lo, hi), names in zip(halves, [
            [f"derivative_{d}" for d in range(4)], ["volume", "flux"]]):
        inside = [name for name, a, b in execs if lo <= a <= b <= hi]
        assert inside == [f"feinsum.exec:{n}" for n in names]
    assert len(execs) == 6


def test_ader_predictor_launches_count_the_predictors_launches(monkeypatch):
    """``ader_predictor_launches`` grows by the launches issued inside the
    predictor's span, 9 a step (four ``step_block_f32``, five
    ``step_update`` bands), of the step's 12.  The wrappers run their CUDA
    branch on CPU tensors against a stand-in library whose every entry
    returns 0 (no kernel runs)."""
    _stand_in(monkeypatch)
    for key in ("ader_predictor_launches", "model_steps"):
        monkeypatch.setitem(tracing.counters, key, tracing.counters[key])
    kernels.reset_launch_counts()
    op = ft.AderElasticOperator3D()
    state, geom = ft.make_ader_state(E, seed=2, device="cpu")
    step = op.make_step(E)
    before = tracing.counters["ader_predictor_launches"]
    for k in range(1, 3):
        step(state, geom)
        assert tracing.counters["ader_predictor_launches"] \
            == before + k * ADER_PREDICTOR
        assert {n: c for n, c in kernels.launch_counts.items() if c} \
            == {n: k * c for n, c in ADER_LAUNCHES.items()}


SB_ADER = ("void (anonymous namespace)::step_block_kernel<false>"
           "((anonymous namespace)::Plan)")


def _ader_trace(steps, per_step, extra=()):
    """A synthetic trace of *steps* ADER steps: each step's program
    launches (the predictor's 9 at 1 ms each, the corrector's 3 at 2 ms
    each, every other one a ``step_update``), and *extra* operations."""
    device, t = list(extra), 0.0
    for _ in range(steps):
        for k in range(per_step):
            length = 0.001 if k < ADER_PREDICTOR else 0.002
            device.append((SB_ADER if k % 2 else UPDATE32, t, t + length))
            t += length + 0.0001
    return device


def test_predictor_ms_per_step_reads_the_predictors_launches(monkeypatch):
    """``predictor_ms_per_step``: the program's device operations in start
    order (PyTorch's left out), cut into steps at the launches per step,
    the first ``ader_predictor_launches / model_steps`` of each summed per
    step; nothing where a step's operations are not as many as its
    launches, where the program lacks the counter or counts none, or
    without a trace."""
    read = _reader("predictor_ms_per_step")
    monkeypatch.setattr(tracing, "counters",
                        {"model_steps": 10, "ader_predictor_launches": 90})
    # a PyTorch kernel and a copy among them count for nothing
    device = _ader_trace(3, 12, extra=[(ADD, 0.0005, 0.0006),
                                       ("Memcpy DtoD", 0.02, 0.021)])
    run = SimpleNamespace(trace=SimpleNamespace(device=device, steps=3,
                                                launches=36))
    assert read(run) == pytest.approx(9 * 1.0)
    # one operation lost: the steps' operations are not their launches
    run.trace.device = device[:-1]
    assert read(run) is None
    run.trace.device, run.trace.launches = device, 35
    assert read(run) is None
    run.trace.launches = 36
    # the parent, or a model without a predictor: no such counter
    monkeypatch.setattr(tracing, "counters", {"model_steps": 10})
    assert read(run) is None
    monkeypatch.setattr(tracing, "counters",
                        {"model_steps": 0, "ader_predictor_launches": 0})
    assert read(run) is None
    assert read(SimpleNamespace(trace=None)) is None


def test_the_ader_cell_feeds_the_accepted_generic_readers():
    """The readers that the ADER cell shares with the tetrahedral cells
    read its step: the host readers split a profiled step's spans (the
    ``feinsum.ader:*`` halves belong to no layer of theirs), summing to
    the step span; ``glue_ms_per_step`` reads 0 ms where every device
    operation is the program's; ``kernels_roofline`` reads the sum of
    the six einsums' least times over the program's device time per step
    (the step counting 200,826 operations and 4,788 bytes an element);
    ``setup_program_s``
    reads the program's counters."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    import yardstick
    step = ft.AderElasticOperator3D().make_step(E)
    state, geom = ft.make_ader_state(E, seed=4, device="cpu")
    step(state, geom)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, geom)
    host = [(name, lo / 1e6, hi / 1e6)
            for name, lo, hi in _spans(prof, "feinsum.")]
    (_, s_lo, s_hi), = [s for s in host if s[0].startswith("feinsum.step:")]
    got = {name: _reader(name)(_run(host, 1)) for name in HOST_READERS}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert sum(got.values()) == pytest.approx(1e3 * (s_hi - s_lo))
    cfg = json.loads((BENCH / "configs"
                      / "seissol_elastic_o5.json").read_text())
    peaks = {"flops": {"float32": 67e12}, "bytes_per_s": 3.35e12}
    flops, nbytes = yardstick.step_counts(cfg, 1000)
    # the reference matrices' 9,132 floats once
    assert (flops, nbytes) == (200826 * 1000, 4788 * 1000 + 4 * 9132)
    device = _ader_trace(3, 12)
    run = SimpleNamespace(cfg=cfg, n_elements=1000, peaks=peaks,
                          trace=SimpleNamespace(device=device, steps=3))
    assert _reader("glue_ms_per_step")(run) == 0.0
    program = sum(hi - lo for _, lo, hi in device) / 3
    least = yardstick.einsums_least_time(cfg, 1000, peaks)
    assert _reader("kernels_roofline")(run) == pytest.approx(
        100 * least / program)
    assert _reader("setup_program_s")(run) >= 0

# }}}


# {{{ launch spans

ADER_EXECS = ("derivative_0", "derivative_1", "derivative_2", "derivative_3",
              "volume", "flux")
# the viscoelastic step's executables in launch order: each derivative,
# its source and its relaxation, then the corrector's
VISCO_EXECS = (*(f"{kind}_{d}" for d in range(4)
                 for kind in ("derivative", "source", "relax")),
               "volume", "flux", "source_4")
# each model's constructor and state arguments, the executables its
# launches lie in (in launch order), and its launches a step by span name
# at E = 64 (every einsum launch on its tiled or lanes path)
LAUNCH_MODELS = {
    "wave": (ft.WaveOperator3D, make_wave_state, {}, MODELS["wave"][2],
             {"dg_rows_f32.tiled": 4, "step_update": 2}),
    "maxwell": (ft.MaxwellOperator3D, make_maxwell_state, {},
                MODELS["maxwell"][2],
                {"dg_rows_f32.tiled": 2, "step_update": 2}),
    "wave_f64": (ft.WaveOperator3D, make_wave_state, {"dtype": "float64"},
                 MODELS["wave"][2], {"dd_rows.tiled": 4, "step_update": 2,
                                     "pairs_split": 2}),
    "hex": (ft.HexWaveOperator3D, ft.make_hexwave_state, {}, HEX_EXECS,
            {"step_block_f32.lanes": 4, "step_block_f32.stream": 2,
             "step_update": 2}),
    "ader": (ft.AderElasticOperator3D, ft.make_ader_state, {}, ADER_EXECS,
             {"step_block_f32.lanes": 6, "step_update": 6}),
    "visco": (ft.AderViscoelasticOperator3D, ft.make_ader_visco_state, {},
              VISCO_EXECS, {"step_block_f32.lanes": 15, "step_update": 12}),
}
# the kernels a step launches outside any executable
UPDATES = ("step_update", "pairs_split")


def _holder(spans, lo, hi):
    """The innermost of *spans* that holds ``[lo, hi]``, or ``None``."""
    held = [s for s in spans if s[1] <= lo and hi <= s[2]]
    return max(held, key=lambda s: (s[1], -s[2])) if held else None


def _launch_spans():
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    import launch_spans
    return launch_spans


@pytest.mark.parametrize("key", sorted(LAUNCH_MODELS))
def test_a_step_records_one_launch_span_per_launch(key, monkeypatch):
    """A step whose wrappers run their CUDA branch against a stand-in
    library records one ``feinsum.launch`` span per counted launch, named
    by its kernel and, for the kernels that choose one, its path; each
    lies in its kernel's ``feinsum.kernel`` span inside the step, an
    einsum's launch in the executable span that the model names, the
    update's in none; the path counters grow by the launch spans of each
    path.  ``launch_spans.pair`` finds the same spans around each launch
    in the profiled host spans, a device operation laid after each."""
    cls, make_state, kwargs, execs, per_step = LAUNCH_MODELS[key]
    _stand_in(monkeypatch)
    state, geom = make_state(E, seed=5, device="cpu", **kwargs)
    step = cls(**kwargs).make_step(E)
    step(state, geom)                          # the geometry derived once
    c = tracing.counters
    keys = ("launches", *tracing.PATH_COUNTERS.values())
    before = {k: dict(c[k]) for k in keys}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, geom)
    grown = {k: {n: v - before[k][n] for n, v in c[k].items()
                 if v != before[k][n]} for k in keys}
    launches = sorted(_spans(prof, "feinsum.launch:"), key=lambda s: s[1])
    kernel_spans = _spans(prof, "feinsum.kernel:")
    exec_spans = _spans(prof, "feinsum.exec:")
    (step_span,) = _spans(prof, "feinsum.step:")
    names, held = {}, []
    for name, lo, hi in launches:
        short = name.removeprefix("feinsum.launch:")
        names[short] = names.get(short, 0) + 1
        kernel, _, path = short.partition(".")
        assert bool(path) == (kernel in tracing.PATH_COUNTERS)
        assert _holder(kernel_spans, lo, hi)[0] == f"feinsum.kernel:{kernel}"
        assert step_span[1] <= lo and hi <= step_span[2]
        ex = _holder(exec_spans, lo, hi)
        assert (ex is None) == (kernel in UPDATES)
        held.append(ex)
    assert names == per_step
    assert grown["launches"] == {
        k: sum(n for s, n in names.items() if s.partition(".")[0] == k)
        for k in {s.partition(".")[0] for s in names}}
    for kernel, counter in tracing.PATH_COUNTERS.items():
        assert grown[counter] == {
            s.partition(".")[2]: n for s, n in names.items()
            if s.partition(".")[0] == kernel}
    execs_seen = [ex for k, ex in enumerate(held)
                  if ex is not None and ex not in held[:k]]
    assert [n for n, _, _ in execs_seen] == [f"feinsum.exec:{n}"
                                             for n in execs]

    # the benchmark's reader, on the same host spans (seconds) and one
    # device operation a launch, 1 us after its span ends
    host = [(n, lo / 1e6, hi / 1e6) for n, lo, hi in _spans(prof, "")]
    device = [(SB, hi / 1e6 + 1e-6, hi / 1e6 + 2e-6)
              for _, _, hi in launches]
    trace = SimpleNamespace(host=host, device=device, steps=1,
                            launches=len(launches))
    prefixes = ("feinsum.step:", "feinsum.exec:", "feinsum.kernel:")
    paired = _launch_spans().pair(trace, prefixes)
    assert [launch[0] for _, launch, _ in paired] == [
        n for n, _, _ in launches]
    for (_, (_, lo, hi), holders), ex in zip(paired, held):
        assert holders["feinsum.step:"][0] == step_span[0]
        assert holders["feinsum.exec:"] == (ex and (ex[0], ex[1] / 1e6,
                                                    ex[2] / 1e6))
        kernel = _holder(kernel_spans, 1e6 * lo, 1e6 * hi)
        assert holders["feinsum.kernel:"][0] == kernel[0]


@pytest.mark.parametrize("recording", [False, True])
def test_a_launch_span_is_named_by_its_kernel_and_path(recording,
                                                      monkeypatch):
    """``tracing.launch_span``: ``feinsum.launch:<kernel>.<path>``, or
    ``feinsum.launch:<kernel>`` without a path, while a profiler records;
    otherwise the span that does nothing, with no ``record_function``
    entered (and no name built)."""
    if not recording:
        def refuse(name):
            raise AssertionError(f"record_function({name!r}) entered")
        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        assert tracing.launch_span("dd_rows", "tiled") is tracing._OFF
        with tracing.launch_span("step_update"):
            pass
        return
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.launch_span("step_block_f32", "lanes"):
            pass
        with tracing.launch_span("step_update"):
            pass
    assert [n for n, _, _ in sorted(_spans(prof, "feinsum.launch:"),
                                    key=lambda s: s[1])] == [
        "feinsum.launch:step_block_f32.lanes", "feinsum.launch:step_update"]


def test_count_launch_counts_the_path_it_is_given(monkeypatch):
    """``tracing.count_launch`` counts the launch under its kernel and,
    given a path, under that path in the kernel's path counter."""
    _keep_launch_counts(monkeypatch)
    c = tracing.counters
    kernels.reset_launch_counts()
    tracing.count_launch("dd_rows", "general")
    tracing.count_launch("step_block_f32", "stream")
    tracing.count_launch("step_update")
    assert {k: n for k, n in c["launches"].items() if n} == {
        "dd_rows": 1, "step_block_f32": 1, "step_update": 1}
    assert c["dd_rows_path"] == {"tiled": 0, "general": 1}
    assert c["step_block_mode"] == {"dense": 0, "general": 0, "stream": 1,
                                    "lanes": 0}
    assert set(c["dg_rows_f32_path"].values()) == {0}

# }}}


# {{{ launch_spans and its readers

MS = 1e-3


def _one_step(t):
    """The host spans of one synthetic step at *t* (seconds), ms from t: a
    step span 0-10 holding an executable ``a`` (1-4) whose wrapper (1.5-
    3.5) launches at 2-2.1, the update's wrapper (5-6) launching at
    5.2-5.3, and the executable ``flux`` (6.5-8) whose wrapper (7-7.8)
    launches at 7.1-7.2; and the device operations those launches issue:
    2.5-5.25, 5.4-7.5, 7.6-9.9."""
    def at(lo, hi):
        return t + lo * MS, t + hi * MS
    host = [("feinsum.step:Op", *at(0, 10)),
            ("feinsum.exec:a", *at(1, 4)),
            ("feinsum.kernel:step_block_f32", *at(1.5, 3.5)),
            ("feinsum.launch:step_block_f32.lanes", *at(2, 2.1)),
            ("aten::empty", *at(3.6, 3.7)),
            ("feinsum.kernel:step_update", *at(5, 6)),
            ("feinsum.launch:step_update", *at(5.2, 5.3)),
            ("feinsum.exec:flux", *at(6.5, 8)),
            ("feinsum.kernel:step_block_f32", *at(7, 7.8)),
            ("feinsum.launch:step_block_f32.lanes", *at(7.1, 7.2))]
    device = [(SB, *at(2.5, 5.25)), (UPDATE32, *at(5.4, 7.5)),
              (SB, *at(7.6, 9.9))]
    return host, device


def _launch_run(steps=2, device_extra=(), launches=None):
    """A synthetic traced run of the wave cell's configuration at E =
    1,000: *steps* of :func:`_one_step`, 10 ms apart, in a window of
    ``10 * steps`` ms."""
    host, device = [], list(device_extra)
    for k in range(steps):
        h, d = _one_step(1.0 + k * 10 * MS)
        host += h
        device += d
    cfg = json.loads((BENCH / "configs" / "wave3d_p4.json").read_text())
    peaks = {"flops": {"float32": 67e12}, "bytes_per_s": 3.35e12}
    return SimpleNamespace(cfg=cfg, n_elements=1000, peaks=peaks,
                           trace=SimpleNamespace(
                               host=host, device=device, steps=steps,
                               launches=(3 * steps if launches is None
                                         else launches),
                               window_s=10 * steps * MS))


def test_launch_spans_pairs_each_operation_with_its_launch():
    """Each of the program's device operations, in start order, with the
    launch span in the same place of the launch spans' order, and the
    innermost step, executable and kernel span around that launch (none
    where no span holds it); PyTorch's operations are no launch's."""
    ls = _launch_spans()
    run = _launch_run(device_extra=[(ADD, 1.0095, 1.0096)])
    prefixes = ("feinsum.step:", "feinsum.exec:", "feinsum.kernel:")
    paired = ls.pair(run.trace, prefixes)
    assert [(op[0], launch[0]) for op, launch, _ in paired] == [
        (SB, "feinsum.launch:step_block_f32.lanes"),
        (UPDATE32, "feinsum.launch:step_update"),
        (SB, "feinsum.launch:step_block_f32.lanes")] * 2
    assert [h["feinsum.exec:"] and h["feinsum.exec:"][0]
            for _, _, h in paired] == [
        "feinsum.exec:a", None, "feinsum.exec:flux"] * 2
    assert [h["feinsum.kernel:"][0] for _, _, h in paired] == [
        "feinsum.kernel:step_block_f32", "feinsum.kernel:step_update",
        "feinsum.kernel:step_block_f32"] * 2
    steps = [h["feinsum.step:"] for _, _, h in paired]
    assert steps[0] == steps[2] != steps[3] == steps[5]
    assert steps[0][1] == pytest.approx(1.0)
    assert steps[3][1] == pytest.approx(1.01)
    assert ls.seconds_per_step(run.trace, "feinsum.exec:") == \
        pytest.approx((2.75 + 2.3) * MS)
    assert ls.seconds_per_step(run.trace, "feinsum.exec:",
                               "feinsum.exec:flux") == pytest.approx(2.3 * MS)
    assert ls.seconds_per_step(run.trace, "feinsum.exec:",
                               "feinsum.exec:none") is None


def test_launch_spans_splits_each_gap_at_its_launch():
    """An idle gap before an operation whose launch span ended inside it is
    host-late up to that end and queued after it; one whose launch had
    ended before the gap opened is all queued; a gap that one of PyTorch's
    operations ends counts in neither."""
    ls = _launch_spans()

    def split(run):
        gaps = ls.idle_gaps(run.trace)
        late = sum(g[2] for g in gaps)
        return late, sum(hi - lo for lo, hi, _ in gaps) - late, gaps
    host_late, queued, gaps = split(_launch_run())
    # each step: 5.25-5.4 (launch ended 5.3: 0.05 late, 0.1 queued) and
    # 7.5-7.6 (ended 7.2: queued); between the steps 9.9-12.5 (the next
    # step's first launch ended at 12.1: 2.2 late, 0.4 queued)
    assert host_late == pytest.approx((0.05 + 2.2 + 0.05) * MS)
    assert queued == pytest.approx((0.1 + 0.1 + 0.4 + 0.1 + 0.1) * MS)
    assert len(gaps) == 5
    assert max(gaps, key=lambda g: g[2])[:2] == pytest.approx(
        (1.0099, 1.0125))
    # PyTorch's add at 9.95-9.97 ends the gap 9.9-9.95 and opens the next
    host_late, queued, gaps = split(
        _launch_run(device_extra=[(ADD, 1.00995, 1.00997)]))
    assert host_late == pytest.approx((0.05 + 2.13 + 0.05) * MS)
    assert queued == pytest.approx((0.1 + 0.1 + 0.4 + 0.1 + 0.1) * MS)
    assert len(gaps) == 5


def _refusals():
    """Runs ``launch_spans`` refuses: one operation lost, the program's
    count off, an operation before its launch span, no launch spans (the
    parent), no trace."""
    lost = _launch_run()
    lost.trace.device = lost.trace.device[:-1]
    off = _launch_run(launches=5)
    early = _launch_run()
    name, _, hi = early.trace.device[0]
    early.trace.device[0] = (name, 1.0019, hi)
    parent = _launch_run()
    parent.trace.host = [s for s in parent.trace.host
                         if not s[0].startswith("feinsum.launch:")]
    none = _launch_run()
    none.trace = None
    return {"lost": lost, "count": off, "early": early, "parent": parent,
            "no trace": none}


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_launch_spans_refuses_what_it_cannot_pair(case):
    ls = _launch_spans()
    run = _refusals()[case]
    assert ls.pair(run.trace) is None
    assert ls.idle_gaps(run.trace) is None
    assert ls.seconds_per_step(run.trace, "feinsum.exec:") is None
    for name in ("einsums_roofline", "host_late_idle_pct",
                 "flux_ms_per_step"):
        assert _reader(name)(run) is None


def test_the_launch_readers_on_a_synthetic_trace():
    """``einsums_roofline``: the einsums' least time over the device time
    per step of the launches in executable spans (the update's left out);
    ``flux_ms_per_step``: the launches in ``feinsum.exec:flux``;
    ``host_late_idle_pct``: the host-late idle over the window, at most
    ``device_idle_pct``."""
    import yardstick
    run = _launch_run()
    least = yardstick.einsums_least_time(run.cfg, 1000, run.peaks)
    assert _reader("einsums_roofline")(run) == pytest.approx(
        100 * least / ((2.75 + 2.3) * MS))
    assert _reader("flux_ms_per_step")(run) == pytest.approx(2.3)
    late = _reader("host_late_idle_pct")(run)
    assert late == pytest.approx(100 * 2.3 / 20)
    assert late <= _reader("device_idle_pct")(run)
    run.peaks = None
    assert _reader("einsums_roofline")(run) is None
    # a run whose executables are named by their subscripts: no flux
    for s in range(len(run.trace.host)):
        name, lo, hi = run.trace.host[s]
        run.trace.host[s] = (name.replace("flux", "fkm,fmn->kn"), lo, hi)
    assert _reader("flux_ms_per_step")(run) is None

# }}}


# {{{ the viscoelastic ADER element

# a step's launches: 15 einsums (four derivatives, five sources, four
# relaxations, the volume and flux terms), 12 updates; the predictor's 22
# of them (each derivative's five, the two time integrals); the anelastic
# products' 9
VISCO_LAUNCHES = {"step_block_f32": 15, "step_update": 12}
VISCO_PREDICTOR = 22
VISCO_ANELASTIC = 9


def test_a_visco_step_records_its_spans_and_counts_itself():
    """One step records ``feinsum.step:AderViscoelasticOperator3D`` around
    ``feinsum.ader:predictor`` (the derivatives', sources' and
    relaxations' executable spans) then ``feinsum.ader:corrector`` (the
    volume, flux and last source's); each source and relaxation executable
    lies in a ``feinsum.ader:anelastic`` span of its own, and no other."""
    op = ft.AderViscoelasticOperator3D()
    state, geom = ft.make_ader_visco_state(E, seed=1, device="cpu")
    step = op.make_step(E)
    step(state, geom)
    c = tracing.counters
    steps = c["model_steps"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, geom)
    assert c["model_steps"] == steps + 1
    (s_name, s_lo, s_hi), = _spans(prof, "feinsum.step:")
    assert s_name == "feinsum.step:AderViscoelasticOperator3D"
    halves = sorted((s for s in _spans(prof, "feinsum.ader:")
                     if not s[0].endswith("anelastic")), key=lambda s: s[1])
    assert [name for name, _, _ in halves] == [
        "feinsum.ader:predictor", "feinsum.ader:corrector"]
    assert all(s_lo <= lo <= hi <= s_hi for _, lo, hi in halves)
    execs = sorted(_spans(prof, "feinsum.exec:"), key=lambda s: s[1])
    assert [n.removeprefix("feinsum.exec:") for n, _, _ in execs] \
        == list(VISCO_EXECS)
    for (_, lo, hi), names in zip(halves, [VISCO_EXECS[:12],
                                           VISCO_EXECS[12:]]):
        inside = [n for n, a, b in execs if lo <= a <= b <= hi]
        assert inside == [f"feinsum.exec:{n}" for n in names]
    anelastic = _spans(prof, "feinsum.ader:anelastic")
    assert len(anelastic) == VISCO_ANELASTIC
    held = [n.removeprefix("feinsum.exec:") for n, a, b in execs
            if any(lo <= a <= b <= hi for _, lo, hi in anelastic)]
    assert held == [n for n in VISCO_EXECS
                    if n.startswith(("source", "relax"))]


def test_visco_launch_counters_count_the_steps_launches(monkeypatch):
    """``ader_predictor_launches`` grows by the predictor's 22 launches a
    step and ``anelastic_launches`` by the anelastic products' 9, of the
    step's 27; the wrappers run their CUDA branch on CPU tensors against a
    stand-in library whose every entry returns 0 (no kernel runs), and
    the step's einsums count 15 lanes launches (the flux's among them)
    and none on the block kernel."""
    _stand_in(monkeypatch)
    for key in ("ader_predictor_launches", "anelastic_launches",
                "model_steps"):
        monkeypatch.setitem(tracing.counters, key, tracing.counters[key])
    kernels.reset_launch_counts()
    op = ft.AderViscoelasticOperator3D()
    state, geom = ft.make_ader_visco_state(E, seed=2, device="cpu")
    step = op.make_step(E)
    c = tracing.counters
    before = (c["ader_predictor_launches"], c["anelastic_launches"])
    for k in range(1, 3):
        step(state, geom)
        assert (c["ader_predictor_launches"], c["anelastic_launches"]) \
            == (before[0] + k * VISCO_PREDICTOR,
                before[1] + k * VISCO_ANELASTIC)
        assert {n: v for n, v in kernels.launch_counts.items() if v} \
            == {n: k * v for n, v in VISCO_LAUNCHES.items()}
        assert c["step_block_mode"] == {"dense": 0, "general": 0,
                                        "stream": 0, "lanes": 15 * k}


def _visco_cfg():
    return json.loads((BENCH / "configs"
                       / "seissol_viscoelastic_o5.json").read_text())


def _anelastic_run(steps=2, anelastic=True):
    """A synthetic traced run of the viscoelastic configuration at E =
    1,000: each step (10 ms) launches a derivative (1 ms on the device), a
    source and a relaxation, each in a ``feinsum.ader:anelastic`` span
    (unless not *anelastic*; 2 and 0.5 ms), and an update (0.25 ms)."""
    host, device = [], []
    for k in range(steps):
        t = 1.0 + k * 10 * MS

        def at(lo, hi, t=t):
            return t + lo * MS, t + hi * MS
        host += [("feinsum.step:Op", *at(0, 10)),
                 ("feinsum.exec:derivative_0", *at(0.1, 0.4)),
                 ("feinsum.launch:step_block_f32.lanes", *at(0.2, 0.3))]
        for name, lo in (("source_0", 1.0), ("relax_0", 2.0)):
            if anelastic:
                host.append(("feinsum.ader:anelastic", *at(lo, lo + 0.5)))
            host += [(f"feinsum.exec:{name}", *at(lo + 0.1, lo + 0.4)),
                     ("feinsum.launch:step_block_f32.lanes",
                      *at(lo + 0.2, lo + 0.3))]
        host += [("feinsum.launch:step_update", *at(3.0, 3.1))]
        device += [(SB, *at(0.5, 1.5)), (SB, *at(1.5, 3.5)),
                   (SB, *at(3.5, 4.0)), (UPDATE32, *at(4.0, 4.25))]
    peaks = {"flops": {"float32": 67e12}, "bytes_per_s": 3.35e12}
    return SimpleNamespace(cfg=_visco_cfg(), n_elements=1000, peaks=peaks,
                           trace=SimpleNamespace(
                               host=host, device=device, steps=steps,
                               launches=4 * steps, window_s=10 * steps * MS))


def test_the_anelastic_readers_on_a_synthetic_trace():
    """``anelastic_ms_per_step``: the device time per step of the launches
    inside ``feinsum.ader:anelastic`` spans (the source's 2 ms and the
    relaxation's 0.5); ``anelastic_roofline``: the least time of the
    configuration's anelastic einsums (five sources, four relaxations)
    over it; both nothing where no launch lies in such a span, as in the
    parent, whose program has no such span, or without a trace."""
    import yardstick
    run = _anelastic_run()
    assert _reader("anelastic_ms_per_step")(run) == pytest.approx(2.5)
    cfg = run.cfg
    specs = [s for s in cfg["einsums"] if s.get("part") == "anelastic"]
    assert [s["name"] for s in specs] == [
        *(f"source_{d}" for d in range(5)), *(f"relax_{d}" for d in range(4))]
    least = sum(yardstick.least_time(*yardstick.einsum_counts(
        s, cfg, 1000), run.peaks, "float32")[0] for s in specs)
    assert _reader("anelastic_roofline")(run) == pytest.approx(
        100 * least / (2.5 * MS))
    for bare in (_anelastic_run(anelastic=False), SimpleNamespace(
            trace=None, peaks=run.peaks, cfg=cfg, n_elements=1000)):
        assert _reader("anelastic_ms_per_step")(bare) is None
        assert _reader("anelastic_roofline")(bare) is None
    run.peaks = None
    assert _reader("anelastic_roofline")(run) is None


def test_the_visco_cell_feeds_the_generic_readers(monkeypatch):
    """The readers the viscoelastic cell is listed under read its step:
    the host readers split a profiled step's spans, summing to the step
    span; the step counts 454,770 operations and 12,000 bytes an element
    (the reference matrices' 8,400 floats once); on a synthetic trace of
    its 27 launches a step, ``glue_ms_per_step`` reads 0, the update's,
    the predictor's (its first 22 launches), the roofline and the launch
    readers read, and ``setup_program_s`` reads the counters."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    import yardstick
    step = ft.AderViscoelasticOperator3D().make_step(E)
    state, geom = ft.make_ader_visco_state(E, seed=4, device="cpu")
    step(state, geom)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, geom)
    host = [(name, lo / 1e6, hi / 1e6)
            for name, lo, hi in _spans(prof, "feinsum.")]
    (_, s_lo, s_hi), = [s for s in host if s[0].startswith("feinsum.step:")]
    got = {name: _reader(name)(_run(host, 1)) for name in HOST_READERS}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert sum(got.values()) == pytest.approx(1e3 * (s_hi - s_lo))
    cfg = _visco_cfg()
    flops, nbytes = yardstick.step_counts(cfg, 1000)
    assert (flops, nbytes) == (454770 * 1000, 12000 * 1000 + 4 * 8400)
    # 3 steps of 27 launches, the first 22 the predictor's (1 ms each), the
    # corrector's 2 ms; every launch paired with a launch span in an
    # executable but the updates (every other one)
    device, launch_host, t = [], [], 1.0
    for _ in range(3):
        launch_host.append(("feinsum.step:Op", t, t + 0.1))
        for k in range(27):
            length = 0.001 if k < VISCO_PREDICTOR else 0.002
            name = SB_ADER if k % 2 else UPDATE32
            launch_host.append(("feinsum.launch:x", t, t + 1e-5))
            if k % 2:
                launch_host.append(("feinsum.exec:e", t, t + 2e-5))
            device.append((name, t + 5e-5, t + 5e-5 + length))
            t += length + 0.0001
    monkeypatch.setattr(tracing, "counters", {
        **tracing.counters, "model_steps": 5,
        "ader_predictor_launches": 5 * VISCO_PREDICTOR})
    peaks = {"flops": {"float32": 67e12}, "bytes_per_s": 3.35e12}
    run = SimpleNamespace(cfg=cfg, n_elements=1000, peaks=peaks, step_s=0.05,
                          trace=SimpleNamespace(
                              device=device, host=launch_host, steps=3,
                              launches=81, window_s=t - 1.0))
    assert _reader("glue_ms_per_step")(run) == 0.0
    assert _reader("predictor_ms_per_step")(run) == pytest.approx(22.0)
    updates = sum(hi - lo for n, lo, hi in device if n == UPDATE32) / 3
    assert _reader("update_ms_per_step")(run) == pytest.approx(1e3 * updates)
    least, _ = yardstick.least_time(flops, nbytes, peaks, "float32")
    einsums = sum(hi - lo for n, lo, hi in device if n == SB_ADER) / 3
    assert _reader("sumfact_roofline")(run) == pytest.approx(
        100 * least / einsums)
    assert _reader("step_mfu")(run) == pytest.approx(100 * least / 0.05)
    assert _reader("einsums_roofline")(run) == pytest.approx(
        100 * yardstick.einsums_least_time(cfg, 1000, peaks) / einsums)
    assert _reader("launches_per_step")(run) == 27
    assert 0 <= _reader("host_late_idle_pct")(run) \
        <= _reader("device_idle_pct")(run)
    assert _reader("setup_program_s")(run) >= 0

# }}}

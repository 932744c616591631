"""The harness's own tests, on the CPU at small sizes:

    python -m pytest benchmark_torch/tests -q

The count arithmetic against hand counts; the plain references against the
models' per-step route; the control, which has to fail the check while
the program passes it; and whole runs with the timed path broken
underneath, which have to come out not correct.
"""

import json
import math
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import calibrate  # noqa: E402
import traffic  # noqa: E402
import run  # noqa: E402
import yardstick  # noqa: E402

torch.set_num_threads(1)
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# one cell of each configuration
BY_CONFIG = {w["config"]: w["name"] for w in BENCH["workloads"]}

# operations per element by hand, each einsum along its cheapest order:
# grad (rij,ej->rei: 3*35*35*2) + (xre,rei->xei: 3*3*35*2);
# div, each of 3 rows, (es,ej->esj: 3*35, no sum) + (sij,esj->ei:
# 3*35*35*2); face (fe,fej->fej: 4*15) + (ifj,fej->ei: 35*4*15*2);
# restrict 4*15*35*2; a curl six div-class rows
WAVE_FLOPS = {"grad": 7350 + 630, "div": 3 * (105 + 7350),
              "face": 60 + 4200, "restrict": 4200}
CURL_FLOPS = 6 * (105 + 7350)


def test_operations_and_bytes_by_hand():
    wave = run.Cell(BY_CONFIG["wave3d_p4"]).cfg
    E = 1000
    got = {s["name"]: yardstick.einsum_counts(s, wave, E)
           for s in wave["einsums"]}
    assert {k: f for k, (f, _) in got.items()} == {
        k: E * f for k, f in WAVE_FLOPS.items()}
    D, L, R = 3 * 35 * 35, 35 * 4 * 15, 4 * 15 * 35
    assert got["grad"][1] == 4 * ((9 + 35 + 3 * 35) * E + D)
    assert got["div"][1] == 4 * ((3 * 3 + 3 * 35 + 3 * 35) * E + D)
    assert got["face"][1] == 4 * ((4 + 60 + 35) * E + L)
    assert got["restrict"][1] == 4 * ((35 + 60) * E + R)
    flops, nbytes = yardstick.step_counts(wave, E)
    assert flops == E * sum(WAVE_FLOPS.values()) == E * 38805
    # state u, v read and written; J, Jx, Jy, Jz, Fj read; D, L, R read
    assert nbytes == 4 * (2 * 140 * E + (9 + 9 + 4) * E + D + L + R)

    maxwell = run.Cell(BY_CONFIG["maxwell3d_p4"]).cfg
    flops, nbytes = yardstick.step_counts(maxwell, E)
    assert flops == 2 * CURL_FLOPS * E
    assert nbytes == 4 * (2 * 210 * E + 9 * E + D)


def test_least_time_and_busy_union():
    peaks = {"flops": {"float32": 67e12}, "bytes_per_s": 3.35e12}
    assert yardstick.least_time(67e9, 1e6, peaks, "float32") == (
        1e-3, "flops")
    assert yardstick.least_time(1.0, 3.35e9, peaks, "float32") == (
        pytest.approx(1e-3), "bytes")
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.8)]
    assert yardstick.busy_seconds(spans) == 4.0
    assert yardstick.idle_gaps(spans) == [(3.0, 5.0)]
    assert yardstick.is_pytorch_kernel(
        "void at::native::vectorized_elementwise_kernel<4, ...>")
    assert not yardstick.is_pytorch_kernel("void dg_rows_kernel<3, 35>()")


def test_every_name_in_the_benchmark_has_its_file():
    for w in BENCH["workloads"]:
        cell = run.Cell(w["name"])
        assert cell.elements() >= 1
        assert cell.per_layer and cell.end_to_end
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for c in BENCH["configs"]:
        assert (HERE.parent / c["file"]).is_file()
        assert (HERE / "configs" / f"{c['name']}.py").is_file()


@pytest.mark.parametrize("config", sorted(BY_CONFIG))
def test_reference_matches_the_models_plain_route(config):
    cell = run.Cell(BY_CONFIG[config])
    n = 96
    state, geom = cell.ref.make_inputs(
        cell.cfg, n, run.make_generator(3, torch.device("cpu")), "cpu")
    step = run.program_step(cell.cfg, n, use_pallas=False)
    new = step(state, geom)
    inc = cell.ref.increments(cell.cfg, state, geom)
    assert run.increment_gap(state, new, inc) < 1e-5


@pytest.mark.parametrize("config", sorted(BY_CONFIG))
def test_the_control_fails_where_the_program_passes(config):
    cell = run.Cell(BY_CONFIG[config])
    limit = cell.cfg["check"]["increment_gap_limit"]
    for seed in (1, 2 ** 31 + 5, 12345678901):
        r = calibrate.readings(cell, seed, 16, "cpu", n_elements=384)
        assert r["program"] <= limit < r["control"], r
        for fault in calibrate.FAULTS:
            assert r[fault] > limit, (fault, r)


@pytest.mark.parametrize("fault", [None, *calibrate.FAULTS])
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_broken_step_makes_the_run_incorrect(cell_name, fault):
    cell = run.Cell(cell_name)
    result, notes = run.run_cell(
        cell, 2 ** 31 + 77, 0.3, False, device="cpu", n_elements=256,
        break_step=None if fault is None else calibrate.FAULTS[fault])
    assert result["correct"] is (fault is None), notes
    assert list(result)[-1] == "checks"
    gap = result["checks"]["increment_gap"]
    assert gap["limit"] == cell.cfg["check"]["increment_gap_limit"]
    assert notes[-1].startswith("increment_gap")
    names = {m["name"] for m in cell.end_to_end}
    assert set(result["metrics"]) == names
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in result["metrics"].values())


def test_the_same_seed_draws_the_same_inputs():
    cell = run.Cell(BY_CONFIG["wave3d_p4"])
    cpu = torch.device("cpu")
    a = cell.ref.make_inputs(cell.cfg, 64, run.make_generator(2 ** 33, cpu),
                             cpu)
    b = cell.ref.make_inputs(cell.cfg, 64, run.make_generator(2 ** 33, cpu),
                             cpu)
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_trace_without_device_operations_fails():
    cell = run.Cell(CELLS[0])
    n = 64
    state, geom = cell.ref.make_inputs(
        cell.cfg, n, run.make_generator(1, torch.device("cpu")), "cpu")
    step = run.program_step(cell.cfg, n)
    with pytest.raises(RuntimeError, match="no device operation"):
        run.traced_segment(step, state, geom, 3, torch.device("cpu"))


def test_checked_steps_and_sample_are_drawn_from_the_seed():
    steps = traffic.checked_steps(2 ** 33 + 1, 1000)
    assert 0 in steps and len(steps) == traffic.CHECKED_STEPS
    assert steps == traffic.checked_steps(2 ** 33 + 1, 1000)
    assert traffic.checked_steps(5, 10) == set(range(10))
    sample = traffic.sample_elements(2 ** 33 + 1, 10 ** 7)
    assert len(sample) == traffic.SAMPLE_ELEMENTS == len(set(sample))
    assert sample == sorted(sample) == traffic.sample_elements(2 ** 33 + 1,
                                                               10 ** 7)
    assert traffic.sample_elements(5, 100) == list(range(100))


def test_a_fault_outside_the_sample_is_caught_on_the_last_step():
    cell = run.Cell(BY_CONFIG["wave3d_p4"])
    seed, n = 2 ** 31 + 9, traffic.SAMPLE_ELEMENTS + 808
    outside = sorted(set(range(n)) - set(traffic.sample_elements(seed, n)))
    e = outside[len(outside) // 2]

    def altered(step):
        def broken(state, geom):
            new = dict(step(state, geom))
            u = new["u"].clone()
            u[:, e] = u[:, e + 1]
            new["u"] = u
            return new
        return broken

    result, notes = run.run_cell(cell, seed, 0.2, False, device="cpu",
                                 n_elements=n, break_step=altered)
    assert result["correct"] is False, notes
    assert result["failed"] == 1, notes


def test_host_calls_end():
    cell = run.Cell(CELLS[0])
    state, geom = cell.ref.make_inputs(
        cell.cfg, 64, run.make_generator(1, torch.device("cpu")), "cpu")
    step = run.program_step(cell.cfg, 64)
    calls = run.host_calls(step, state, geom, torch.device("cpu"))
    assert len(calls) >= run.HOST_MIN_CALLS
    assert all(t > 0 for t in calls)

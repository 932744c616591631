"""One run of one cell of the port's benchmark.

    python3 benchmark_torch/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, whose sizes are ``configs/<config>.json`` and whose plain
reference and input draw are ``configs/<config>.py``, and a traffic mix,
``workloads/<traffic>.json``, read by ``traffic.py``.  The run draws the
state and geometry on the card from ``--seed``, builds the configuration's
operator through the program's public entry point (``<Operator>(...)
.make_step(E)``), warms every shape up, then chains time steps
free-running for ``--seconds`` with one synchronise at each end and a CUDA
event at every step boundary.  Set-up is counted from the start of this
process to the first timed step.

With ``--trace 1`` the same window is followed by a traced segment under
``torch.profiler`` and by bursts of a few steps after a synchronise, timed
on the host; the cell's per-layer metrics are read from those.  Every
metric is a reader of its own, ``metrics/<name>.py``, whose ``read(run)``
returns a number or ``None`` (nothing to read: the metric is left out).

Once the window has closed and the memory peak is read, the run compares
the window's steps with the configuration's plain reference: up to
``traffic.CHECKED_STEPS`` of them on a sample of elements drawn from the
seed, and the last step on every element.  The number compared is the
widest gap between a new state and the old state plus the reference's
increment, beyond the half unit in the last place that storing the new
state may cost, as a share of the largest increment (``increment_gap``).
It prints that number beside its limit as the last lines on standard
error, and the result as one JSON line, last on standard output.  Without
a CUDA card, or with fewer cards than the cell asks for, it exits with 2
and prints no result.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the CUDA driver's kernel cache stays inside the checkout, at a fixed path
os.environ.setdefault("CUDA_CACHE_PATH",
                      str(ROOT / "build" / "benchmark_torch" / "nv_cache"))
if __name__ == "__main__":
    # Python compiles every module it imports from source where it finds no
    # bytecode, and an environment may forbid writing it: the bytecode of
    # every module imported from here on, torch's among them, is cached
    # inside the checkout, at a fixed path, so that a checkout's later runs
    # import it without compiling
    sys.pycache_prefix = str(ROOT / "build" / "benchmark_torch" / "pycache")
    sys.dont_write_bytecode = False
sys.path.insert(1, str(ROOT))

import torch  # noqa: E402

T_IMPORTED = time.perf_counter()

import traffic as traffic_gen  # noqa: E402
import yardstick  # noqa: E402

# the window holds the host at most this many steps ahead of the device, so
# that it closes within a few steps of ``--seconds``
AHEAD_STEPS = 8
# the traced segment: steps to cover about this long, within these counts
TRACE_SECONDS = 0.5
TRACE_STEPS = (20, 1500)
# host time per call: bursts of this many steps right after a synchronise,
# for at least this long and this many calls
HOST_BURST = 4
HOST_SECONDS = 0.5
HOST_MIN_CALLS = 16
# elements per block of the reference where it runs over a whole mesh
REF_BLOCK = 1 << 20
# entries of each list in the breakdown, and characters of a name there
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, reference,
    traffic and metrics, each found by its name."""

    def __init__(self, name: str) -> None:
        bench = load_json(ROOT / "BENCHMARK.json")
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise SystemExit(f"no cell {name!r} in BENCHMARK.json; cells:"
                             f" {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        config = self.entry["config"]
        self.cfg = load_json(HERE / "configs" / f"{config}.json")
        self.ref = load_module(HERE / "configs" / f"{config}.py",
                               f"reference_{config}")
        self.traffic = load_json(
            HERE / "workloads" / f"{self.entry['traffic']}.json")
        # an end-to-end metric without ``workloads`` is every cell's
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m["workloads"]]

    def elements(self) -> int:
        return self.cfg["n_elements"]


def program_step(cfg: dict, n_elements: int, **overrides):
    """The system under test: the configuration's operator, built through
    the program's public entry point, and its step at *n_elements*."""
    import feinsum_tpu_torch

    spec = cfg["operator"]
    operator = getattr(feinsum_tpu_torch, spec["class"])(
        **{**spec["kwargs"], **overrides})
    return operator.make_step(n_elements, dt=cfg["dt"])


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 64)
    return gen


def gap_terms(old: dict, new: dict, increments: dict) -> dict:
    """``{field: (widest excess, largest |increment|)}``: the excess of
    *new* over ``old + increment`` (exact, in float64) beyond the half unit
    in the last place that rounding the new state to float32 may cost;
    infinite where a value is not finite."""
    terms = {}
    for field, inc in increments.items():
        n = new[field]
        if not bool(torch.isfinite(n).all()):
            terms[field] = (math.inf, 1.0)
            continue
        target = old[field].double() + inc.double()
        half_ulp = 0.5 * (torch.nextafter(n.abs(), torch.tensor(
            math.inf, device=n.device)) - n.abs()).double()
        excess = ((n.double() - target).abs() - half_ulp).clamp_min(0)
        terms[field] = (float(excess.max()), float(inc.abs().max()))
    return terms


def gap_of(terms: list) -> float:
    """``increment_gap`` from the terms of the blocks of one step: over
    every field, its widest excess over its largest increment."""
    worst = 0.0
    for field in terms[0]:
        excess = max(t[field][0] for t in terms)
        scale = max(t[field][1] for t in terms)
        gap = excess / scale if scale > 0 else (0.0 if excess == 0
                                                else math.inf)
        worst = max(worst, gap if gap == gap else math.inf)
    return worst


def increment_gap(old: dict, new: dict, increments: dict) -> float:
    """The widest gap, over every field and entry, between *new* and
    ``old + increment``, as a share of the field's largest increment."""
    return gap_of([gap_terms(old, new, increments)])


def cut(tensors: dict, shapes: dict, index) -> dict:
    """*tensors* with their element axis (the last, ``"E"`` in *shapes*)
    cut to *index*: a slice, or a tensor of elements."""
    out = {}
    for k, t in tensors.items():
        if shapes[k][-1] != "E":
            out[k] = t
        elif isinstance(index, slice):
            out[k] = t[..., index]
        else:
            out[k] = t.index_select(-1, index)
    return out


def element_blocks(n_elements: int):
    return (slice(a, a + REF_BLOCK) for a in range(0, n_elements, REF_BLOCK))


def full_gap(cell, old: dict, new: dict, geom: dict) -> float:
    """``increment_gap`` of one step over every element, the reference run
    in blocks of ``REF_BLOCK`` elements."""
    cfg = cell.cfg
    n = next(iter(old.values())).shape[-1]
    terms = []
    for block in element_blocks(n):
        o = cut(old, cfg["state"], block)
        inc = cell.ref.increments(cfg, o, cut(geom, cfg["geometry"], block))
        terms.append(gap_terms(o, cut(new, cfg["state"], block), inc))
    return gap_of(terms)


def chain(step, state: dict, geom: dict, steps: int, checked: set,
          sample, shapes: dict) -> tuple:
    """Run *steps* chained steps; ``(samples, last)``: ``(k, old, new)``
    cut to the elements *sample* for each step in *checked*, and in full
    for the last step."""
    samples, prev = [], None
    for k in range(steps):
        new = step(state, geom)
        if k in checked:
            samples.append((k, cut(state, shapes, sample),
                            cut(new, shapes, sample)))
        prev, state = state, new
    return samples, (steps - 1, prev, state)


def check(cell: Cell, geom: dict, sample, samples: list, last: tuple
          ) -> list:
    """``(k, increment_gap)`` of each sampled step against the plain
    reference on the sample of elements, then of the last step over every
    element."""
    cfg = cell.cfg
    g = cut(geom, cfg["geometry"], sample)
    gaps = [(k, increment_gap(old, new, cell.ref.increments(cfg, old, g)))
            for k, old, new in samples]
    k, old, new = last
    return gaps + [(k, full_gap(cell, old, new, geom))]


def warm_up(step, state: dict, geom: dict, sample, shapes: dict,
            device: torch.device) -> tuple:
    """Run ``WARMUP_STEPS`` steps, then as many more in the window's own
    loop (the previous state held, a sample cut); ``(state, seconds per
    step of the second half)``."""
    for _ in range(traffic_gen.WARMUP_STEPS):
        state = step(state, geom)
    synchronize(device)
    t0 = time.perf_counter()
    prev = None
    for _ in range(traffic_gen.WARMUP_STEPS):
        new = step(state, geom)
        cut(new, shapes, sample)
        prev, state = state, new
    del prev
    synchronize(device)
    return state, (time.perf_counter() - t0) / traffic_gen.WARMUP_STEPS


def timed_window(step, state: dict, geom: dict, seconds: float,
                 checked: set, sample, shapes: dict, steps_expected: int,
                 device: torch.device) -> SimpleNamespace:
    """Chained steps, free-running for *seconds* from one synchronise to
    the next, a CUDA event at each step boundary, the host waiting on the
    event ``AHEAD_STEPS`` steps back (the device is never drained); the
    checked steps cut to the elements *sample*, and the last step in
    full."""
    cuda = device.type == "cuda"
    events = ([torch.cuda.Event(enable_timing=True)
               for _ in range(int(1.5 * steps_expected) + 16)]
              if cuda else [])

    def mark(k: int):
        if not cuda:
            return time.perf_counter()
        if k == len(events):
            events.append(torch.cuda.Event(enable_timing=True))
        events[k].record()
        return events[k]

    samples, marks, prev, k = [], [], None, 0
    synchronize(device)
    t_start = time.perf_counter()
    marks.append(mark(0))
    while time.perf_counter() - t_start < seconds:
        if cuda and k >= AHEAD_STEPS:
            marks[k + 1 - AHEAD_STEPS].synchronize()
        new = step(state, geom)
        marks.append(mark(k + 1))
        if k in checked:
            samples.append((k, cut(state, shapes, sample),
                            cut(new, shapes, sample)))
        prev, state = state, new
        k += 1
    synchronize(device)
    t_end = time.perf_counter()
    if cuda:
        intervals = [1e-3 * marks[i].elapsed_time(marks[i + 1])
                     for i in range(k)]
    else:
        intervals = [marks[i + 1] - marks[i] for i in range(k)]
    return SimpleNamespace(t_start=t_start, seconds=t_end - t_start,
                           steps=k, intervals=intervals, samples=samples,
                           last=(k - 1, prev, state))


def traced_segment(step, state: dict, geom: dict, steps: int,
                   device: torch.device) -> SimpleNamespace:
    """*steps* chained steps under ``torch.profiler``, each in a span
    ``bench.step``; the device's and the host's operations, the launches
    the program counted, and the window from one synchronise to the
    next."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from feinsum_tpu_torch.ops.kernels import launch_counts

    synchronize(device)
    launched = sum(launch_counts.values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function("bench.step"):
                state = step(state, geom)
        synchronize(device)
        window_s = time.perf_counter() - t0
    launches = sum(launch_counts.values()) - launched
    dev, host = [], []
    for ev in prof.events():
        span = (ev.name, 1e-6 * ev.time_range.start,
                1e-6 * ev.time_range.end)
        if ev.device_type != DeviceType.CUDA:
            host.append(span)
        elif not (getattr(ev, "is_user_annotation", False)
                  or ev.name == "bench.step"):
            # a span's shadow on the device timeline is no operation
            dev.append(span)
    if not dev:
        raise RuntimeError("the profiler saw no device operation in the"
                           " traced window; nothing is reported from it")
    return SimpleNamespace(steps=steps, window_s=window_s, device=dev,
                           host=host, launches=launches, state=state)


def host_calls(step, state: dict, geom: dict, device: torch.device) -> list:
    """Host seconds of each ``step()`` call, issued in bursts of
    ``HOST_BURST`` right after a synchronise, so the launch queue never
    fills (before any profiling, which would slow the host)."""
    times, t_begin = [], time.perf_counter()
    while (len(times) < HOST_MIN_CALLS
           or time.perf_counter() - t_begin < HOST_SECONDS):
        synchronize(device)
        for _ in range(HOST_BURST):
            t0 = time.perf_counter()
            state = step(state, geom)
            times.append(time.perf_counter() - t0)
    synchronize(device)
    return times


def breakdown(trace: SimpleNamespace) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost host operation running at its
    start."""
    by_name: dict = {}
    for name, lo, hi in trace.device:
        by_name[name] = by_name.get(name, 0.0) + hi - lo
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    gaps = sorted(yardstick.idle_gaps((lo, hi) for _, lo, hi in
                                      trace.device),
                  key=lambda g: g[0] - g[1])[:BREAKDOWN_ENTRIES]
    named = []
    for lo, hi in gaps:
        around = [(h_hi - h_lo, name) for name, h_lo, h_hi in trace.host
                  if h_lo <= lo < h_hi]
        named.append([min(around)[1][:NAME_CHARS] if around
                      else "no host operation", hi - lo])
    return {"device_ops": [[n[:NAME_CHARS], s]
                           for n, s in ops[:BREAKDOWN_ENTRIES]],
            "idle_gaps": named}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"not read (rc {out.returncode})"


def read_metrics(specs: list, run: SimpleNamespace) -> dict:
    """Each metric's reader, ``metrics/<name>.py``, on *run*; a reader
    that returns ``None`` leaves its metric out."""
    out = {}
    for spec in specs:
        reader = load_module(HERE / "metrics" / f"{spec['name']}.py",
                             f"metric_{spec['name']}")
        value = reader.read(run)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", n_elements=None, break_step=None) -> tuple:
    """One run of *cell*; ``(result, notes)``: the result line's object
    and the lines for standard error.  *n_elements* and *break_step* (a
    function of the step that returns a broken one) serve the harness's
    own tests on the CPU."""
    device = torch.device(device)
    cfg, traffic = cell.cfg, cell.traffic
    n = n_elements or cell.elements()
    marks = [("torch imported", T_IMPORTED)]
    state, geom = cell.ref.make_inputs(cfg, n, make_generator(seed, device),
                                       device)
    synchronize(device)
    marks.append(("inputs drawn", time.perf_counter()))
    step = program_step(cfg, n)
    if break_step is not None:
        step = break_step(step)
    marks.append(("operator and executables built", time.perf_counter()))
    shapes = cfg["state"]
    sample = torch.tensor(traffic_gen.sample_elements(seed, n),
                          device=device)
    state, warm_s = warm_up(step, state, geom, sample, shapes, device)
    expected = max(1, int(seconds / warm_s))
    checked = traffic_gen.checked_steps(seed, expected)
    window = timed_window(step, state, geom, seconds, checked, sample,
                          shapes, expected, device)
    run = SimpleNamespace(
        cfg=cfg, traffic=traffic, n_elements=n,
        setup_s=window.t_start - T_PROCESS, window_s=window.seconds,
        steps=window.steps, step_s=window.seconds / window.steps,
        intervals_s=window.intervals, trace=None,
        peaks=(yardstick.device_peaks(torch.cuda.get_device_name(device))
               if device.type == "cuda" else None))
    marks.append(("warmed up", window.t_start))
    prior = T_PROCESS
    split = []
    for what, t in marks:
        split.append(f"{what} +{t - prior:.6f} s")
        prior = t
    notes = [f"cell {cell.name}: E = {n}, seed {seed}, {window.steps} steps"
             f" in {window.seconds:.6f} s, set-up {run.setup_s:.6f} s"
             f" ({', '.join(split)})"]
    samples, last = window.samples, window.last
    state = last[2]
    del window
    if trace:
        calls = host_calls(step, state, geom, device)
        n_trace = min(max(math.ceil(TRACE_SECONDS / run.step_s),
                          TRACE_STEPS[0]), TRACE_STEPS[1])
        run.trace = traced_segment(step, state, geom, n_trace, device)
        run.trace.host_calls_s = calls
        step_flops, step_bytes = yardstick.step_counts(cfg, n)
        if run.peaks is not None:
            bound = yardstick.least_time(step_flops, step_bytes, run.peaks,
                                         cfg["dtype"])
            notes.append(f"step's least time {bound[0]:.9f} s, bound by"
                         f" {bound[1]} ({step_flops} operations,"
                         f" {step_bytes} bytes)")
        del run.trace.state
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    largest = max(float(t.abs().max()) for t in state.values())
    notes.append(f"largest magnitude of the state at the window's end:"
                 f" {largest!r}")
    del state, step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gaps = check(cell, geom, sample, samples, last)
    limit = cfg["check"]["increment_gap_limit"]
    failed = sum(not g <= limit for _, g in gaps)
    k_worst, gap = max(gaps[:-1] or gaps, key=lambda kg: kg[1])
    notes.append(f"{len(samples)} of {run.steps} steps checked on"
                 f" {sample.numel()} elements drawn from the seed: widest"
                 f" {gap!r} at step {k_worst}; the last step, {last[0]},"
                 f" on all {n} elements: {gaps[-1][1]!r}")
    gap = max(g for _, g in gaps)
    specs = cell.per_layer if trace else cell.end_to_end
    result = {
        "correct": failed == 0,
        "attempted": run.steps,
        "failed": failed,
        "metrics": read_metrics(specs, run),
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1,
            "memory_peak_bytes": memory_peak,
        },
    }
    if trace:
        busy = yardstick.busy_seconds((lo, hi) for _, lo, hi in
                                      run.trace.device)
        result["device"].update(busy_s=busy, window_s=run.trace.window_s)
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = {"increment_gap": {"value": gap, "limit": limit}}
    notes.append(f"increment_gap {gap!r} limit {limit!r}")
    return result, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.entry["chips"]:
        print(f"{cell.name} needs {cell.entry['chips']} CUDA card(s);"
              f" this machine has"
              f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}:"
              " nothing is measured", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    result, notes = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace))
    card = power_limit()
    result["device"]["power_limit"] = card
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "feinsum_tpu"))
    if leaked:
        raise RuntimeError(f"the benchmark imported {leaked[:5]}")
    for line in [f"card: {card}"] + notes:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

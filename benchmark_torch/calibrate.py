"""The readings that the limit of ``increment_gap`` is set from, at a cell's
own size, over many seeds in one process.

    python3 benchmark_torch/calibrate.py --workload <cell> --seeds <first> \\
        <count> [--out <file.json>]

For each seed it draws the cell's inputs, chains ``STEPS`` steps from
them and checks them as a run checks its window (up to
``traffic.CHECKED_STEPS`` steps on a sample of elements drawn from the
seed, the last step on every element) against the plain reference, for

* ``program``: the program's step, as a run drives it (the lower reading);
* ``control``: the plain reference with every product's operands in TF32,
  put in the program's place (the upper reading: it has to fail);
* the faults a time step can have, each planted under the program's step:
  ``unchanged`` (the state comes back unchanged), ``half_left_out`` (the
  second half of the elements keeps its old state) and ``answer_altered``
  (one element's new state is its neighbour's: an index off by one).

The program runs on every seed, the control and the faults on the first
``CONTROL_SEEDS`` of them.  The benchmark's own runs never run this.  It
needs a CUDA card, unless ``--device cpu`` (a rehearsal at a small
``--elements``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

import run as harness
import traffic as traffic_gen

# steps chained from each seed's inputs
STEPS = 32
# seeds, the first of a call's, on which the control and the faults run
CONTROL_SEEDS = 3


def control_step(cell):
    """The control: the plain reference at TF32, in the program's place,
    in blocks of ``REF_BLOCK`` elements."""
    cfg = cell.cfg

    def step(state, geom):
        new = {f: torch.empty_like(t) for f, t in state.items()}
        for block in harness.element_blocks(next(iter(state.values()))
                                            .shape[-1]):
            old = harness.cut(state, cfg["state"], block)
            inc = cell.ref.increments(
                cfg, old, harness.cut(geom, cfg["geometry"], block),
                tf32=True)
            for f in new:
                new[f][..., block] = old[f] + inc[f]
        return new
    return step


def unchanged(step):
    return lambda state, geom: dict(state)


def half_left_out(step):
    def broken(state, geom):
        new = step(state, geom)
        out = {}
        for f, t in new.items():
            t = t.clone()
            half = t.shape[-1] // 2
            t[..., half:] = state[f][..., half:]
            out[f] = t
        return out
    return broken


def answer_altered(step):
    def broken(state, geom):
        new = step(state, geom)
        field = next(iter(new))
        t = new[field].clone()
        e = t.shape[-1] // 3
        t[..., e] = t[..., e + 1]
        return {**new, field: t}
    return broken


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out,
          "answer_altered": answer_altered}


def readings(cell, seed: int, steps: int, device, n_elements=None,
             all_variants: bool = True) -> dict:
    """``{variant: widest increment_gap over the checked steps}`` for the
    program and, with *all_variants*, the control and each fault, from the
    same inputs."""
    device = torch.device(device)
    n = n_elements or cell.elements()
    program = harness.program_step(cell.cfg, n)
    variants = {"program": program}
    if all_variants:
        variants["control"] = control_step(cell)
        variants.update({name: fault(program)
                         for name, fault in FAULTS.items()})
    checked = traffic_gen.checked_steps(seed, steps)
    sample = torch.tensor(traffic_gen.sample_elements(seed, n),
                          device=device)
    out = {}
    for name, step in variants.items():
        state, geom = cell.ref.make_inputs(
            cell.cfg, n, harness.make_generator(seed, device), device)
        samples, last = harness.chain(step, state, geom, steps, checked,
                                      sample, cell.cfg["state"])
        del state
        gaps = harness.check(cell, geom, sample, samples, last)
        out[name] = max(g for _, g in gaps)
        out[f"{name}_last"] = gaps[-1][1]
        del samples, last
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs=2, required=True,
                    metavar=("FIRST", "COUNT"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--elements", type=int, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card: nothing is read", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell(args.workload)
    rows = []
    for i, seed in enumerate(range(args.seeds[0],
                                   args.seeds[0] + args.seeds[1])):
        t0 = time.perf_counter()
        r = readings(cell, seed, STEPS, args.device, args.elements,
                     all_variants=i < CONTROL_SEEDS)
        r.update(seed=seed, seconds=time.perf_counter() - t0)
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": cell.name, "steps": STEPS,
               "elements": args.elements or cell.elements(),
               "device": (torch.cuda.get_device_name()
                          if args.device == "cuda" else args.device),
               "card": harness.power_limit() if args.device == "cuda"
               else None,
               "lower": max(r["program"] for r in rows),
               "upper": min(r["control"] for r in rows if "control" in r),
               "faults": {f: min(r[f] for r in rows if f in r)
                          for f in FAULTS},
               "rows": rows}
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}),
          flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

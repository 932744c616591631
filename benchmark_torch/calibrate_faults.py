"""The readings of the faults of the mathematics that a configuration's plain
reference can plant, at a cell's own size, beside ``calibrate.py``'s.

    python3 benchmark_torch/calibrate_faults.py --workload <cell> \\
        --seeds <first> <count> [--out <file.json>]

A reference that lists ``FAULTS`` takes ``increments(..., fault=name)``:
the step with that fault of its mathematics planted (for the viscoelastic
ADER element: the derivatives cut to the elastic element's degree boxes,
the anelastic source zeroed, the relaxation left out).  For each seed and
fault, that step is put in the program's place, as ``calibrate.py`` puts
the control, chained ``calibrate.STEPS`` steps from the seed's inputs, and
checked against the sound reference as a run checks its window; the
widest ``increment_gap`` is the fault's reading.  The benchmark's own runs
never run this.  It needs a CUDA card, unless ``--device cpu`` (a
rehearsal at a small ``--elements``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

import calibrate
import run as harness
import traffic as traffic_gen


def faulty_step(cell, fault: str):
    """The reference with *fault* planted, in the program's place, in
    blocks of ``REF_BLOCK`` elements."""
    cfg = cell.cfg

    def step(state, geom):
        new = {f: torch.empty_like(t) for f, t in state.items()}
        for block in harness.element_blocks(next(iter(state.values()))
                                            .shape[-1]):
            old = harness.cut(state, cfg["state"], block)
            inc = cell.ref.increments(
                cfg, old, harness.cut(geom, cfg["geometry"], block),
                fault=fault)
            for f in new:
                new[f][..., block] = old[f] + inc[f]
        return new
    return step


def readings(cell, seed: int, steps: int, device, n_elements=None) -> dict:
    """``{fault: widest increment_gap over the checked steps}``, each from
    the same inputs."""
    device = torch.device(device)
    n = n_elements or cell.elements()
    checked = traffic_gen.checked_steps(seed, steps)
    sample = torch.tensor(traffic_gen.sample_elements(seed, n),
                          device=device)
    out = {}
    for fault in cell.ref.FAULTS:
        state, geom = cell.ref.make_inputs(
            cell.cfg, n, harness.make_generator(seed, device), device)
        samples, last = harness.chain(faulty_step(cell, fault), state, geom,
                                      steps, checked, sample,
                                      cell.cfg["state"])
        del state
        gaps = harness.check(cell, geom, sample, samples, last)
        out[fault] = max(g for _, g in gaps)
        del samples, last, geom
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
    if not getattr(cell.ref, "FAULTS", ()):
        print(f"{cell.name}'s reference plants no fault", file=sys.stderr)
        return 2
    rows = []
    for seed in range(args.seeds[0], args.seeds[0] + args.seeds[1]):
        t0 = time.perf_counter()
        r = readings(cell, seed, calibrate.STEPS, args.device, args.elements)
        r.update(seed=seed, seconds=time.perf_counter() - t0)
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": cell.name, "steps": calibrate.STEPS,
               "elements": args.elements or cell.elements(),
               "device": (torch.cuda.get_device_name()
                          if args.device == "cuda" else args.device),
               "card": harness.power_limit() if args.device == "cuda"
               else None,
               "faults": {f: min(r[f] for r in rows)
                          for f in cell.ref.FAULTS},
               "rows": rows}
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}),
          flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

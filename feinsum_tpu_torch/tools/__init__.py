"""Measurement scripts for the port on an NVIDIA card, run from the root of
a checkout as ``python -m feinsum_tpu_torch.tools.<name>``:

* ``sweep_block_long``: kernel-route time of each suite row at E = 1M for
  a range of ``block_long`` values (how ``suite.BLOCK_LONG`` was chosen;
  with the argument ``bf16_3x``, at that precision);
* ``profile_suite``: per suite row and route, device busy time from the
  profiler's kernel events against host wall time, hence the device's idle
  share;
* ``sweep_tc_grid``: ``tc_grid_f32``'s time on the rank >= 3 TCCG rows over
  a grid of ``tc_pallas_v1`` points (how ``chip_smoke.py``'s tuner seeds
  were chosen).

Each prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess

LONG_DIM_LENGTH = 1_000_000


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def suite_inputs(device):
    """``(name, einsum, program, stored arrays)`` of each suite row at
    ``LONG_DIM_LENGTH`` under the default transform, made one row at a
    time so that only one row's arrays live on the card."""
    from ..codegen.program import generate_program
    from ..measure import apply_layouts, generate_input_arrays
    from ..suite import default_transform, suite

    for name, e in suite():
        program = default_transform(e)(generate_program(e))
        arrays = apply_layouts(program, generate_input_arrays(
            e, long_dim_length=LONG_DIM_LENGTH, device=device))
        yield name, e, program, arrays

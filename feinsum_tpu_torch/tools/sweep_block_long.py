"""Kernel-route time of each DG-suite row at E = 1M against ``block_long``
(elements of E per thread block), on one NVIDIA card:

    python -m feinsum_tpu_torch.tools.sweep_block_long [bf16_3x]

With ``bf16_3x`` the rows run at that precision (``dg_rows_3xtf32``).
Every value is timed twice, once in ascending and once in descending order
of ``block_long``, and the mean of the two medians is printed.
"""

from __future__ import annotations

import sys

import torch

from ..codegen.program import build_executable
from ..measure import timeit_cuda
from . import LONG_DIM_LENGTH, card_line, suite_inputs

BLOCKS = (128, 256, 512, 1024, 2048, 4096, 8192)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    precision = sys.argv[1] if len(sys.argv) > 1 else "default"
    print(card_line(), f"precision {precision}", flush=True)
    for name, _, program, arrays in suite_inputs(dev):
        program = program.with_descriptor(precision=precision)
        times = {b: [] for b in BLOCKS}
        for order in (BLOCKS, BLOCKS[::-1]):
            for b in order:
                fn = build_executable(program.with_descriptor(block_long=b),
                                      long_dim_length=LONG_DIM_LENGTH,
                                      device=dev)
                times[b].append(timeit_cuda(fn, arrays))
        print(f"[sweep] {name} ms:", " ".join(
            f"{b}:{sum(ts) / len(ts):.4f}" for b, ts in times.items()),
            flush=True)
        del arrays
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

"""
Minimal demo of the decorator protocol (``feinsum_tpu``'s
``tuning/impls/demo_transform_space.py``, the example of
doc/perf_engg_tutorial.md): a batched matmul whose only knob is the
long-axis block size, on the fused route.

On the card the demo ``ij,ejk->eik`` runs on ``step_block_f32``: its output
(e, i, k) is outside the DG row families, so the kernel runs the trivial
schedule's one step, ``out[e, i, k] = Σ_j A[i, j] B[e, j, k]``, with A
staged in shared memory (``ops/step_block.py``).  The file name and the
parameter are the reference's, so an archived fact of this space binds
here.

Run ``python -m feinsum_tpu_torch.tuning.impls.demo_transform_space`` to
tune the demo on the current card into the default archive (``--cpu``:
host timings, small sizes).  The einsum is float32: the fused route takes
float32 only, and the reference's own ``__main__``, though it declares
float64, runs float32 by default, since its ``generate_input_arrays``
downcasts float64 until JAX's x64 mode is on.
"""

from __future__ import annotations

from feinsum_tpu_torch.tuning import IntParameter, einsum_arg, transform_param
from feinsum_tpu_torch.tuning.impls._common import fused_pallas_program, \
    long_axis_of


@transform_param("log2_block", lambda e: IntParameter(8, 13))
@einsum_arg("long_axis", long_axis_of)
def transform(program, long_axis, log2_block):
    return fused_pallas_program(
        program, block_long=2 ** log2_block, hoist=False,
        grid_index=long_axis)


if __name__ == "__main__":
    import sys

    import feinsum_tpu_torch as f
    from feinsum_tpu_torch.tuning import autotune

    einsum = f.einsum("ij,ejk->eik",
                      f.array("A", (35, 35), "float32"),
                      f.array("B", ("E", 35, 35), "float32"))
    if "--cpu" in sys.argv[1:]:
        autotune(einsum, __file__, device="cpu", long_dim_length=1000,
                 stop_after=60)
    else:
        autotune(einsum, __file__, stop_after=60)

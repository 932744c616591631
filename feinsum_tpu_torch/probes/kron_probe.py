"""The kron matvec, a two-stream copy and a profile
(``scripts/tpu_kron_probe.py`` on the H100):

    python -m feinsum_tpu_torch.probes.kron_probe [--cpu]

E = 1,000,000 (the script's), F = 8, C = E / 8:

* ``kron_matvec`` (``:22-110``, its ``pallas_call`` ``:62``):
  ``out[(i, f), c] = Σ_j (M kron I_8)[(i, f), (j, f)] u[(j, f), c]``,
  optionally times ``jac[f, c]``, with u folded (ndof, 8, C) viewed (8 ndof,
  C), on ``probe_apply_f32`` ("HI", the TPU's ``HIGHEST``) and
  ``probe_apply_3xtf32`` ("3x", the TPU's bf16 split): mvec20 3x and HI at
  blk 4096, mvec20 3x at 8192, mass35 (with jac) 3x and HI at 4096
  elements of C per thread block; each also against float64.  The script's
  small-scale ``s_call`` (``:90``) is built and never called; it has no
  case here;
* the two-stream copy ``j,ej->ej`` (x resident, u (E, 35)) through the
  port's own route: ``fused_pallas_program(block_long=16384, hoist=False,
  dofmajor=True)`` -> ``apply_layouts`` -> ``build_executable``;
* the profile of ``xre,ei->xei`` (``fused_pallas_program(block_long=8192,
  ...)``) as ``tools/profile_suite`` takes it: device busy time and idle
  share per call.
"""

from __future__ import annotations

import numpy as np
import torch

from . import (ApplyRow, Case, F, apply_case, cli, draw, fold, kron_eye,
               oracle_error, default_device)

E_KRON = 1_000_000
E_KRON_CPU = 4000
# (label, ndof, blk_c, TPU precision, jac), the script's run_kron calls
KRON_RUNS = (("kron mvec20 3x  blk4096", 20, 4096, "3x", False),
             ("kron mvec20 HI  blk4096", 20, 4096, "hi", False),
             ("kron mvec20 3x  blk8192", 20, 8192, "3x", False),
             ("kron mass35 3x  blk4096", 35, 4096, "3x", True),
             ("kron mass35 HI  blk4096", 35, 4096, "hi", True))


def kron_case(run: int, device=None, seed: int = 0, *, E: int = E_KRON,
              block: int = -1):
    """``KRON_RUNS[run]`` with *block* elements of C per thread block (-1:
    the script's blk_c; 0: the kernel's default)."""
    device = default_device(device, caller="kron_probe.kron_case")
    label, ndof, blk_c, prec, jac = KRON_RUNS[run]
    block = blk_c if block < 0 else block
    C = E // F
    rng = np.random.default_rng(seed)
    arrays = {"u": draw(rng, (ndof, E), device),
              "R": kron_eye(draw(rng, (ndof, ndof), device))[None]}
    if jac:
        arrays["jac"] = draw(rng, (F, C), device)

    def rows(a):
        u = fold(a["u"]).reshape(ndof * F, C)
        sigma = (a["jac"][None].expand(ndof, F, C) if "jac" in a else None)
        return [ApplyRow(u=u, sigma=sigma)]

    def library(a):
        mk = a["R"][0].view(ndof, F, ndof * F)
        u = fold(a["u"]).reshape(ndof * F, C)
        if "jac" in a:
            return torch.einsum("ifj,jc,fc->ifc", mk, u, a["jac"])
        return torch.einsum("ifj,jc->ifc", mk, u)
    precision = "3x" if prec == "3x" else "f32"
    route = "3xTF32" if prec == "3x" else "f32"
    tail = "" if block == blk_c else f" (blk {block or 'default'})"
    return apply_case(
        f"{label} -> {route}{tail}", rows, arrays,
        gbytes=(2 * ndof * 4 + (4 if jac else 0)) * E / 1e9,
        precision=precision, block_elems=block, library=library,
        family="P-kron")


def kron_oracle(run: int, device=None, seed: int = 0, *,
                E: int = E_KRON) -> float:
    """``KRON_RUNS[run]`` against float64 (the script's relerr)."""
    case = kron_case(run, device, seed, E=E)
    got = case.fn(case.arrays)[0]
    a = {k: v.double() for k, v in case.arrays.items()}
    ndof = KRON_RUNS[run][1]
    want = a["R"][0] @ fold(a["u"]).reshape(ndof * F, E // F)
    if "jac" in a:
        want = (want.view(ndof, F, E // F) * a["jac"]).view_as(want)
    return oracle_error(KRON_RUNS[run][0], got, want)


def two_stream_case(device=None, seed: int = 0, *, E: int = E_KRON):
    """``j,ej->ej`` on the port's own route (``:130-145``)."""
    from .. import array, build_executable, einsum, generate_program
    from ..codegen.program import get_index_lengths
    from ..measure import (apply_layouts, generate_input_arrays,
                           get_footprint_gbytes)
    from ..ops.cuda_emitter import plan_cuda_launch
    from ..tuning.impls._common import fused_pallas_program
    device = default_device(device, caller="kron_probe.two_stream_case")
    two = einsum("j,ej->ej", array("x", (35,), "float32"),
                 array("u", ("E", 35), "float32"))
    p = fused_pallas_program(generate_program(two), block_long=16384,
                             hoist=False, dofmajor=True)
    arrays = apply_layouts(p, generate_input_arrays(
        two, long_dim_length=E, seed=seed, device=device))
    fn = build_executable(p, long_dim_length=E, device=device)
    xla = build_executable(p.with_descriptor(backend="xla"),
                           long_dim_length=E, device=device)
    kernel = plan_cuda_launch(p, get_index_lengths(two, E)).kernel
    gb = get_footprint_gbytes(two, long_dim_length=E)
    assert arrays["u"].shape == (35, E)          # dof-major storage
    return Case(
        label="2stream copy b16384", kernel=kernel, fn=fn, plain=xla,
        library=lambda a: a["u"] * a["x"][:, None], arrays=arrays,
        gbytes=gb, nbytes=gb * 1e9, family="route")


def gstream_profile(device=None, seed: int = 0, *, E: int = E_KRON):
    """``xre,ei->xei`` on the port's route (``:147-158``): on the card the
    device busy time and idle share per call (``tools/profile_suite``); on
    the CPU its output against the plain per-step route."""
    from .. import array, build_executable, einsum, generate_program
    from ..measure import apply_layouts, generate_input_arrays
    from ..tuning.impls._common import fused_pallas_program
    device = default_device(device, caller="kron_probe.gstream_profile")
    gstream = einsum("xre,ei->xei", array("J", (3, 3, "E"), "float32"),
                     array("u", ("E", 35), "float32"))
    p = fused_pallas_program(generate_program(gstream), block_long=8192,
                             hoist=False, dofmajor=True)
    arrays = apply_layouts(p, generate_input_arrays(
        gstream, long_dim_length=E, seed=seed, device=device))
    fn = build_executable(p, long_dim_length=E, device=device)
    if device.type == "cuda":
        from ..tools.profile_suite import report
        report("gstream xre,ei->xei", "kernel", fn, arrays)
        return None
    xla = build_executable(p.with_descriptor(backend="xla"),
                           long_dim_length=E, device=device)
    (got,), (want,) = fn(arrays), xla(arrays)
    err = float((got - want).abs().max() / want.abs().max())
    print(f"[probe] gstream xre,ei->xei: route against the per-step route"
          f" {err:.2e} (not profiled on the CPU)", flush=True)
    if err > 2e-5:
        raise AssertionError(f"gstream: {err:.2e}")
    return None


def cases(device=None, seed: int = 0, *, cpu: bool = False,
          first_block_only: bool = False):
    device = default_device(device, caller="kron_probe.cases")
    E = E_KRON_CPU if cpu else E_KRON
    for run in range(len(KRON_RUNS)):
        yield kron_case(run, device, seed, E=E)
        if not first_block_only:
            yield lambda run=run: kron_oracle(run, device, seed, E=E)
    yield two_stream_case(device, seed, E=E)
    yield lambda: gstream_profile(device, seed, E=E)


def main() -> None:
    cli(cases, "kron_probe")


if __name__ == "__main__":
    main()

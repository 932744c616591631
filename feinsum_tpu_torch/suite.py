"""
The DG benchmark suite, its built-in default transform and the candidate
ladder that replays archived facts, shared by the tests and
``chip_smoke.py``.

The einsums are those of ``bench.py``'s ``suite()`` (the reference's
archived rows): div, grad, face-mass and mass at ndof 35, matvec at ndof 20
and a copy, each over a long element axis ``E``; its extended rows
(:func:`extended_suite`); a 1-D product for K3's flatten route
(:func:`make_scale_flat`); ``bench.py``'s fp64 rows (:func:`fp64_suite`);
and ``bench.py``'s TCCG sample of dense tensor contractions
(:func:`tccg_suite`).  :data:`F32_SPACES` names the space that tunes each
float32 row, and :func:`f32_seed_configs` the tuner's first points.

The consumer flow of ``examples/compile_user_rhs.py`` is here in torch
(:func:`user_rhs`, :func:`user_rhs_limited`, :func:`consumer_args`) with
the einsums its instructions match (:func:`consumer_rows`) and their spaces
(:data:`CONSUMER_SPACES`), and the models' full sizes (:data:`MODEL_SIZES`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from . import sql_utils
from .codegen.program import generate_program_with_opt_einsum_schedule
from .make_einsum import array, batched_einsum, einsum
from .ops.layouts import dofmajor_layouts

# Elements of E per CUDA thread block (descriptor.block_long).  A block of
# dg_rows_f32 holds about 33 KB of shared memory at ndof 35, so six blocks
# share an SM: 792 block slots on the H100's 132 SMs.  At E = 1M, 512
# elements per block give 1954 blocks per row, about 2.5 waves, where 1024
# gives 1.2 waves and a long idle tail, and 8192 (the TPU value) gives 122
# blocks per row, fewer than the SMs.  Measured on an H100 SXM (700 W
# limit), 256 and 512 are the fastest for all five DG rows and 1024 is up
# to 26% slower (grad); 512 is the faster of the two for div and face-mass.
BLOCK_LONG = 512


def make_div(ndof: int, dtype: str = "float32"):
    return batched_einsum(
        "es,sij,ej->ei",
        [[array(jn, ("E", 3), dtype),
          array("R", (3, ndof, ndof), dtype),
          array(un, ("E", ndof), dtype)]
         for jn, un in [("Jx", "ux"), ("Jy", "uy"), ("Jz", "uz")]])


def make_grad(ndof: int, dtype: str = "float32"):
    return einsum("xre,rij,ej->xei",
                  array("J", (3, 3, "E"), dtype),
                  array("D", (3, ndof, ndof), dtype),
                  array("u", ("E", ndof), dtype))


def make_face_mass(ndof: int = 35, nface_dof: int = 15,
                   dtype: str = "float32"):
    return einsum("ifj,fe,fej->ei",
                  array("L", (ndof, 4, nface_dof), dtype),
                  array("Fj", (4, "E"), dtype),
                  array("flux", (4, "E", nface_dof), dtype))


def make_mass(ndof: int, dtype: str = "float32"):
    return einsum("e,ij,ej->ei",
                  array("jac", ("E",), dtype),
                  array("M", (ndof, ndof), dtype),
                  array("u", ("E", ndof), dtype))


def make_matvec(ndof: int, dtype: str = "float32"):
    return einsum("ej,ij->ei",
                  array("u", ("E", ndof), dtype),
                  array("D", (ndof, ndof), dtype))


def make_copy(ndof: int, dtype: str = "float32"):
    return einsum("ij,ij->ij",
                  array("A", ("E", ndof), dtype),
                  array("B", ("E", ndof), dtype))


def make_curl(ndof: int = 35, dtype: str = "float32"):
    return batched_einsum(
        "e,rij,ej->ei",
        [[array(j, ("E",), dtype),
          array("D", (3, ndof, ndof), dtype),
          array(u, ("E", ndof), dtype)]
         for j, u in [("Jy", "uz"), ("Jz", "ux"), ("Jx", "uy")]])


def make_scale_flat(dtype: str = "float32"):
    """A 1-D product over the long axis, ``e,e->e``: the row K3's flatten
    route takes."""
    return einsum("e,e->e", array("a", ("E",), dtype),
                  array("s", ("E",), dtype))


# scale_flat's length: 35 * 2**20 elements, the copy row's bytes at E = 1M
SCALE_FLAT_LENGTH = 36_700_160


def suite() -> list:
    """``(name, einsum)`` of the six headline rows."""
    return [
        ("dg_div_ndof35", make_div(35)),
        ("dg_grad_ndof35", make_grad(35)),
        ("dg_face_mass", make_face_mass()),
        ("dg_mass_ndof35", make_mass(35)),
        ("matvec_ndof20", make_matvec(20)),
        ("copy_ndof35", make_copy(35)),
    ]


def extended_suite() -> list:
    """``(name, einsum)`` of ``bench.py``'s evidence rows: the P1-P3 DG
    sizes, curl, and two bandwidth-bound rows."""
    return [
        ("dg_div_single_ndof35", einsum(
            "es,sij,ej->ei", array("J", ("E", 3), "float32"),
            array("R", (3, 35, 35), "float32"),
            array("u", ("E", 35), "float32"))),
        ("dg_div_ndof20_P3", make_div(20)),
        ("dg_div_ndof10_P2", make_div(10)),
        ("dg_div_ndof4_P1", make_div(4)),
        ("dg_grad_ndof20_P3", make_grad(20)),
        ("dg_grad_ndof10_P2", make_grad(10)),
        ("dg_grad_ndof4_P1", make_grad(4)),
        ("dg_curl_ndof35", make_curl(35)),
        ("vecmat_ndof35", einsum("ej,j->e", array("A", ("E", 35), "float32"),
                                 array("x", (35,), "float32"))),
        ("rowsum_ndof35", einsum("ej->e", array("A", ("E", 35), "float32"))),
    ]


# the space that tunes each float32 row of suite(), extended_suite() and
# scale_flat (the reference's transform ids)
F32_SPACES = {
    "dg_div_ndof35": "dg_div_v0",
    "dg_grad_ndof35": "dg_grad_v0",
    "dg_face_mass": "face_mass_v0",
    "dg_mass_ndof35": "mass_v0",
    "matvec_ndof20": "mass_v0",
    "copy_ndof35": "elementwise_v1",
    "dg_div_single_ndof35": "dg_div_v0",
    "dg_div_ndof20_P3": "dg_div_v0",
    "dg_div_ndof10_P2": "dg_div_v0",
    "dg_div_ndof4_P1": "dg_div_v0",
    "dg_grad_ndof20_P3": "dg_grad_v0",
    "dg_grad_ndof10_P2": "dg_grad_v0",
    "dg_grad_ndof4_P1": "dg_grad_v0",
    "dg_curl_ndof35": "curl_3d_v0",
    "vecmat_ndof35": "mass_v0",
    "rowsum_ndof35": "mass_v0",
    "scale_flat": "elementwise_v1",
}

# the knobs of each row's first tuner points, before the default point;
# scale_flat's three are flatten points (K3's route) at three block lengths
F32_SEEDS = {
    "dg_curl_ndof35": [{"prereduce": True}],
    "dg_div_ndof35": [{"rowcat": True}],
    "scale_flat": [{"flatten": True}, {"flatten": True, "log2_block": 13},
                   {"flatten": True, "log2_block": 16}],
}


def f32_rows() -> list:
    """``(name, einsum)`` of every row of :data:`F32_SPACES`."""
    return suite() + extended_suite() + [("scale_flat", make_scale_flat())]


def space_point(space: str, einsum, **overrides) -> dict:
    """A whole point of the transform space *space* on *einsum*: each
    pinned knob at its one value, ``log2_block`` at ``BLOCK_LONG`` where it
    is searched, ``dofmajor`` on where it is searched, the other searched
    knobs off; then *overrides*."""
    from .tuning import BoolParameter, get_transform_func_from_module_path
    params = {}
    for name, p in get_transform_func_from_module_path(
            space).get_param_space(einsum).items():
        if isinstance(p, BoolParameter):
            params[name] = name == "dofmajor"
        elif name == "log2_block" and p.low < p.high:
            params[name] = BLOCK_LONG.bit_length() - 1
        else:
            params[name] = p.low
    params.update(overrides)
    return params


def f32_seed_configs(name: str, einsum) -> list:
    """The tuner's first points for the float32 row *name*: the row's own
    seeds of :data:`F32_SEEDS` (curl's ``prereduce``, div's ``rowcat``,
    scale_flat's ``flatten``), then the default point."""
    space = F32_SPACES[name]
    return [space_point(space, einsum, **knobs)
            for knobs in F32_SEEDS.get(name, []) + [{}]]


def make_energy(ndof: int, dtype: str = "float32"):
    """The energy diagnostic ``ej,ej->``: one operand read twice (the
    canonical form of ``einsum("ej,ej->", u, u)``), its long axis
    contracted."""
    return einsum("ej,ej->", array("u", ("E", ndof), dtype),
                  array("u", ("E", ndof), dtype))


# examples/compile_user_rhs.py's sizes: E, ndof, faces, face dofs
CONSUMER_SIZES = {"E": 100_000, "ndof": 35, "nf": 4, "nfdof": 15}


def user_rhs(dt, Jx, Jy, Jz, R, ux, uy, uz, L, Fj, flux):
    """``examples/compile_user_rhs.py``'s DG right-hand side in torch: a
    componentwise divergence (three einsums, one negated, the last over the
    affine-rescaled Jacobian ``2 Jz + 1``), a face lift and a traced time
    step factor."""
    div = (torch.einsum("es,sij,ej->ei", Jx, R, ux)
           + torch.einsum("es,sij,ej->ei", Jy, R, uy)
           - torch.einsum("es,sij,ej->ei", 2.0 * Jz + 1.0, R, uz))
    lift = torch.einsum("ifj,fe,fej->ei", L, Fj, flux)
    return dt * (div - 0.5 * lift)


def user_rhs_limited(dt, Jx, Jy, Jz, R, ux, uy, uz, L, Fj, flux):
    """:func:`user_rhs` inside a limiter-style ``tanh``, with the energy
    diagnostic ``sqrt(Σ u²)``: the einsums sit inside non-grammar
    epilogues."""
    r = user_rhs(dt, Jx, Jy, Jz, R, ux, uy, uz, L, Fj, flux)
    energy = torch.sqrt(torch.einsum("ej,ej->", ux, ux))
    return torch.tanh(r), energy


def consumer_args(*, E: int = CONSUMER_SIZES["E"],
                  ndof: int = CONSUMER_SIZES["ndof"],
                  nf: int = CONSUMER_SIZES["nf"],
                  nfdof: int = CONSUMER_SIZES["nfdof"], seed: int = 0,
                  device=None) -> list:
    """The arguments of :func:`user_rhs`, drawn as
    ``examples/compile_user_rhs.py`` draws them (numpy's
    ``default_rng(seed)``, float32, in its order) with ``dt`` = 0.125, on
    *device* (default: the current CUDA card)."""
    from .cl_utils import default_device
    device = default_device(device, caller="consumer_args")
    rng = np.random.default_rng(seed)
    shapes = [(E, 3), (E, 3), (E, 3), (3, ndof, ndof), (E, ndof), (E, ndof),
              (E, ndof), (ndof, nf, nfdof), (nf, E), (nf, E, nfdof)]
    arrays = [rng.random(shape, np.float32) for shape in shapes]
    return [torch.tensor(0.125, dtype=torch.float32, device=device)] + [
        torch.from_numpy(a).to(device) for a in arrays]


def consumer_rows(ndof: int = CONSUMER_SIZES["ndof"],
                  nf: int = CONSUMER_SIZES["nf"],
                  nfdof: int = CONSUMER_SIZES["nfdof"]) -> list:
    """``(name, einsum)`` of the archive classes :func:`user_rhs_limited`'s
    instructions match: the b = 3 divergence, the face lift and the
    energy."""
    return [("consumer_div", make_div(ndof)),
            ("consumer_lift", make_face_mass(ndof, nfdof)),
            ("consumer_energy", make_energy(ndof))]


# the space that tunes each consumer row: elementwise_v1 gives the energy
# the reference's reduction grid (parallel_grid 0, "arbitrary")
CONSUMER_SPACES = {"consumer_div": "dg_div_v0",
                   "consumer_lift": "face_mass_v0",
                   "consumer_energy": "elementwise_v1"}

# the models at full width: wave as examples/wave_3d_p4_auto.py runs it on
# the accelerator, Maxwell as examples/maxwell_3d.py does
MODEL_SIZES = {"wave": {"n_elements": 500_000, "ndof": 35, "nfaces": 4,
                        "nfacedof": 15},
               "maxwell": {"n_elements": 65_536, "ndof": 35}}


def fp64_suite() -> list:
    """``(name, einsum)`` of ``bench.py``'s fp64 rows: grad, div (b = 3),
    mass and face-mass at ndof 35, in float64.  ``bench.py`` runs mass and
    face-mass only when the archive already holds a fact for them, because
    on the TPU a fresh float64 compile could disable the remote compile
    service for every row after it; no such hazard exists on the card, so
    all four rows are here."""
    return [
        ("dg_grad_ndof35_fp64", make_grad(35, "float64")),
        ("dg_div_ndof35_fp64", make_div(35, "float64")),
        ("dg_mass_ndof35_fp64", make_mass(35, "float64")),
        ("dg_face_mass_fp64", make_face_mass(dtype="float64")),
    ]


# bench.py's TCCG sample: one contraction per structural family of the 48
TCCG_SAMPLE = (2, 5, 12, 21, 35, 43)


# the tuner's first two tc_pallas_v1 points per rank >= 3 TCCG row (among
# the fastest of tools/sweep_tc_grid on an H100 SXM, 700 W); chip_smoke.py
# seeds autotune with them
TCCG_SEEDS = {
    "tccg_02": [dict(n_grid=1, blk0_idx=9, blk1_idx=0, m_pos=2),
                dict(n_grid=1, blk0_idx=9, blk1_idx=0, m_pos=1)],
    "tccg_05": [dict(n_grid=1, blk0_idx=4, blk1_idx=0, m_pos=3),
                dict(n_grid=1, blk0_idx=0, blk1_idx=0, m_pos=3)],
    "tccg_21": [dict(n_grid=2, blk0_idx=9, blk1_idx=9, m_pos=3),
                dict(n_grid=1, blk0_idx=9, blk1_idx=0, m_pos=3)],
    "tccg_35": [dict(n_grid=2, blk0_idx=9, blk1_idx=0, m_pos=5),
                dict(n_grid=1, blk0_idx=0, blk1_idx=0, m_pos=5)],
    "tccg_43": [dict(n_grid=2, blk0_idx=0, blk1_idx=9, m_pos=5),
                dict(n_grid=2, blk0_idx=9, blk1_idx=0, m_pos=5)],
}


def tccg_suite() -> list:
    """``(name, einsum)`` of ``bench.py``'s TCCG sample at the published
    sizes, in float32: ``tccg_02`` ``dca,bd->abc``, ``tccg_05``
    ``ebad,ce->abcd``, ``tccg_12`` ``ac,cb->ab`` (a rank-2 GEMM), ``tccg_21``
    ``aebf,fdec->abcd``, ``tccg_35`` ``dfgb,geac->abcdef`` and ``tccg_43``
    ``geab,dfgc->abcdef``."""
    from .utils import get_tccg_benchmark
    return [(f"tccg_{i:02d}", get_tccg_benchmark(i, dtype="float32"))
            for i in TCCG_SAMPLE]


def default_transform(einsum):
    """The built-in default schedule of ``bench.py``: the optimal-path
    schedule on the fused kernels (``backend="pallas"``) with dof-major
    layouts and ``BLOCK_LONG``; float64 einsums take the plain route."""
    is_f64 = _is_f64(einsum)

    def tr(program):
        e = program.einsum
        if is_f64:
            return generate_program_with_opt_einsum_schedule(
                e).with_descriptor(backend="xla", precision="highest")
        layouts, out_perm = dofmajor_layouts(e)
        return generate_program_with_opt_einsum_schedule(e).with_descriptor(
            backend="pallas", block_long=BLOCK_LONG,
            dimension_semantics="parallel",
            arg_layouts=layouts, out_layout=out_perm)
    return tr


def _is_f64(einsum) -> bool:
    return any(a.dtype == "float64" for row in einsum.args for a in row)


@dataclass(frozen=True)
class Candidate:
    """One rung of the ladder: a label, and the archived fact it replays or
    the built-in transform."""

    label: str
    fact: Optional[sql_utils.QueryInfo] = None
    builtin: Optional[Callable] = None

    @property
    def transform(self) -> Callable:
        """The rung's transform.  A fact binds its space here, when the
        rung is tried: one whose space this package does not carry raises
        ``FileNotFoundError``."""
        return self.fact.transform if self.fact is not None \
            else self.builtin


def _dd_builtin(program):
    """``dd_pallas_v0`` at ``BLOCK_LONG`` elements per thread block."""
    from .tuning import get_transform_func_from_module_path
    sp = get_transform_func_from_module_path("dd_pallas_v0")
    return sp.bind_args(program.einsum,
                        log2_block=BLOCK_LONG.bit_length() - 1)(program)


def candidate_transforms(name: str, einsum, *, db_path=None,
                         device=None) -> Iterator[Candidate]:
    """The candidates for *einsum*, best first, as ``bench.py`` tries them
    (its ladder v3): the archived configurations for *device*, collapsed
    over re-timings and ranked by measured rate
    (:func:`~feinsum_tpu_torch.sql_utils.aggregate_reconfirmations`) —
    the best three for float64, four otherwise — then, for float64 and
    only when the archive holds a ``dd_`` fact for the einsum, the dd
    built-in, then the built-in default (:func:`default_transform`).  A
    caller takes the first candidate that builds.  *name* labels the
    rungs.  On a dense tensor contraction (no long axis) the built-in
    default does not build: the fused DG kernels need a long axis and raise
    :class:`~feinsum_tpu_torch.diagnostics.InvalidParameterError`, as the
    reference's default raises there, so such an einsum runs only from an
    archived fact (``tc_pallas_v1`` and the other TC spaces)."""
    distinct = sql_utils.aggregate_reconfirmations(sql_utils.query(
        einsum, device, db_path=db_path, err_if_no_results=False))
    f64 = _is_f64(einsum)
    for rank, q in enumerate(distinct[:3 if f64 else 4]):
        yield Candidate(
            f"{name}: archive[{rank}] {q.transform_id}"
            f" {dict(q.transform_params)} ({q.total_giga_op_rate:.1f}"
            f" GOp/s)", fact=q)
    if f64 and any("dd_" in q.transform_id for q in distinct):
        yield Candidate(f"{name}: built-in dd_pallas_v0",
                        builtin=_dd_builtin)
    yield Candidate(f"{name}: built-in default",
                    builtin=default_transform(einsum))

"""The port's probes (``feinsum_tpu_torch/probes/``) against the TPU probes
they replace (``scripts/tpu_{layout,fold,fold2-5,kron,lane_reshape}_probe
.py``), on the CPU.

Each of the 28 ``pl.pallas_call`` sites of those scripts is restated here
(its kernel body, cited by file and line) at one grid step in Pallas
interpret mode (interpret mode breaks at a grid of 2 or more), on the
inputs that the port's probe case draws at a small size (E = 2**12, C =
512; the kron probe's E = 4000).  The port's case, whose wrapper runs the
plain version on CPU tensors, is held to it within 2e-5 of max|ref|.  A
site's 3x variant is a bf16 split on the TPU; the port's is three TF32
passes, so its plain version is held to the float64 oracle within
``split_tolerance(K)`` of the sum of the terms' magnitudes instead (on the
CPU the Pallas body's ``X3`` and ``bfloat16_3x`` precisions run f32, and
the f32 comparison covers them).

The rest: the plans of the kernels (the stream's merged axes, paths and
strides, emulated; every element of a probe_apply launch taken exactly
once), the folded storage as a view, the wrappers' refusals, that no probe
module runs anything at import, and the default device.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from feinsum_tpu_torch import probes
from feinsum_tpu_torch.diagnostics import InvalidParameterError
from feinsum_tpu_torch.ops import kernels
from feinsum_tpu_torch.ops import probe_kernels as pk
from feinsum_tpu_torch.probes import (fold_probe, fold_probe2, fold_probe3,
                                      fold_probe4, fold_probe5, kron_probe,
                                      lane_reshape_probe, layout_probe)

REPO = Path(__file__).resolve().parents[1]
E = probes.E_CPU
C = E // probes.F
RTOL = 2e-5
HI = jax.lax.Precision.HIGHEST
DIMS = (((1,), (0,)), ((), ()))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _close(got, ref, rtol=RTOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max()) or 1.0
    err = float(np.abs(got - ref).max()) / scale
    assert err <= rtol, err


def _pallas(kernel, arrays, out_shapes):
    """*kernel* at one grid step over whole arrays, in interpret mode."""
    def spec(shape):
        return pl.BlockSpec(tuple(shape), lambda g, n=len(shape): (0,) * n)
    multi = isinstance(out_shapes, list)
    shapes = out_shapes if multi else [out_shapes]
    call = pl.pallas_call(
        kernel, grid=(1,), in_specs=[spec(a.shape) for a in arrays],
        out_specs=tuple(spec(s) for s in shapes) if multi else spec(
            shapes[0]),
        out_shape=tuple(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes)
        if multi else jax.ShapeDtypeStruct(shapes[0], jnp.float32),
        interpret=True)
    out = call(*[jnp.asarray(a) for a in arrays])
    return [np.asarray(o) for o in out] if multi else np.asarray(out)


def _dot(a, b, dims=DIMS, precision=HI):
    return jax.lax.dot_general(a, b, dims, precision=precision,
                               preferred_element_type=jnp.float32)


def _check_3x(case3x, oracle):
    """The port's 3x plain version against the float64 *oracle* (a function
    of float64 numpy arrays, also run on their magnitudes for the terms)
    within split_tolerance(K) of the sum of the terms' magnitudes."""
    arrays = {k: _np(v).astype(np.float64) for k, v in case3x.arrays.items()}
    got = [_np(g) for g in probes._as_list(case3x.plain(case3x.arrays))]
    want = probes._as_list(oracle(arrays))
    terms = probes._as_list(oracle({k: np.abs(v)
                                    for k, v in arrays.items()}))
    for g, w, t in zip(got, want, terms, strict=True):
        over = float((np.abs(g - w) / np.maximum(t, 1e-300)).max())
        assert over <= probes.split_tolerance(case3x.K), over


def _mv_oracle(a):
    return a["R"][0] @ a["u"]


def _div_oracle(a):
    return np.einsum("sij,je,se->ie", a["R"], a["u"], a["J"])


def _div3_oracle(a):
    return [np.einsum("sij,je,se->ie", a["R"], a[f"u{b}"], a[f"J{b}"])
            for b in range(3)]


# {{{ the 28 sites

def site_layout_75():
    """tpu_layout_probe.py:60-61, :75: copy y = a * b, D (35, E)."""
    case = layout_probe.copy_case(3, "cpu", E=E)

    def copy_kernel(a_ref, b_ref, o_ref):
        o_ref[...] = a_ref[...] * b_ref[...]
    a, b = _np(case.arrays["a"]), _np(case.arrays["b"])
    _close(_np(case.fn(case.arrays)), _pallas(copy_kernel, [a, b], a.shape))


def site_layout_101():
    """tpu_layout_probe.py:97-101: matvec E, u (E, 35) . D^T."""
    case = layout_probe.matvec_case(True, "cpu", E=E)

    def kern(u_ref, d_ref, o_ref):
        o_ref[...] = jax.lax.dot_general(
            u_ref[...], d_ref[...], (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
    u, D = _np(case.arrays["u"]), _np(case.arrays["R"][0])
    (got,) = case.fn(case.arrays)
    _close(_np(got).T, _pallas(kern, [u, D], u.shape))


def site_layout_119():
    """tpu_layout_probe.py:114-119: matvec F, D @ u (35, E)."""
    case = layout_probe.matvec_case(False, "cpu", E=E)

    def kern(u_ref, d_ref, o_ref):
        o_ref[...] = jax.lax.dot_general(
            d_ref[...], u_ref[...], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
    u, D = _np(case.arrays["u"]), _np(case.arrays["R"][0])
    (got,) = case.fn(case.arrays)
    _close(_np(got), _pallas(kern, [u, D], u.shape))


def _fold_copy(folded):
    case = fold_probe.copy_case(folded, "cpu", E=E)

    def copy_kernel(a_ref, b_ref, o_ref):
        o_ref[...] = a_ref[...] * b_ref[...]
    a, b = _np(case.arrays["a"]), _np(case.arrays["b"])
    shape = (35, 8, C) if folded else a.shape
    ref = _pallas(copy_kernel, [a.reshape(shape), b.reshape(shape)], shape)
    _close(_np(case.fn(case.arrays)).reshape(shape), ref)


def site_fold_84():
    """tpu_fold_probe.py:71-72, :84: copy dof-major (35, E)."""
    _fold_copy(False)


def site_fold_96():
    """tpu_fold_probe.py:71-72, :96: copy folded (35, 8, E / 8)."""
    _fold_copy(True)


def site_fold_117():
    """tpu_fold_probe.py:111-117: matvec C, D @ u."""
    case = fold_probe.matvec_case("cpu", E=E)

    def mv_kern(d_ref, u_ref, o_ref):
        o_ref[...] = jax.lax.dot_general(
            d_ref[...], u_ref[...], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
    D, u = _np(case.arrays["R"][0]), _np(case.arrays["u"])
    (got,) = case.fn(case.arrays)
    _close(_np(got), _pallas(mv_kern, [D, u], u.shape))


def _kron_oracle(nd, jac=False):
    def oracle(a):
        out = a["R"][0] @ a["u"].reshape(nd, 8, -1).reshape(nd * 8, -1)
        if jac:
            out = (out.reshape(nd, 8, -1) * a["jac"]).reshape(nd * 8, -1)
        return out
    return oracle


def _kron_body(nd, blkC):
    """tpu_fold_probe.py:152-160 (make_folded_mv's kernel)."""
    def kern(dp_ref, u_ref, o_ref):
        um = u_ref[...].reshape(nd * 8, blkC)
        out = jax.lax.dot_general(dp_ref[...], um, DIMS,
                                  preferred_element_type=jnp.float32)
        o_ref[...] = out.reshape(nd, 8, blkC)
    return kern


def site_fold_162():
    """tpu_fold_probe.py:151-168: the kron matvec (D kron I_8) @ u folded;
    its 3x variant held to float64."""
    case = fold_probe.kron_case("f32", "cpu", E=E)
    Dp, u = _np(case.arrays["R"][0]), _np(case.arrays["u"])
    ref = _pallas(_kron_body(35, C), [Dp, u.reshape(35, 8, C)], (35, 8, C))
    (got,) = case.fn(case.arrays)
    _close(_np(got).reshape(35, 8, C), ref)
    # the script's kron_interleave is the port's kron_eye
    D = _np(fold_probe.kron_case("f32", "cpu", E=E).arrays["R"][0])
    np.testing.assert_array_equal(Dp, D)
    _check_3x(fold_probe.kron_case("3x", "cpu", E=E), _kron_oracle(35))


def site_fold2_102():
    """tpu_fold_probe2.py:281-299: mapping I, the merged (35, 8 blkC)
    view; its 3x variant held to float64."""
    case = fold_probe2.matvec_case("I", "f32", "cpu", E=E)

    def kern(d_ref, u_ref, o_ref):
        um = u_ref[...].reshape(35, 8 * C)
        o_ref[...] = _dot(d_ref[...], um, precision=None).reshape(35, 8, C)
    D, u = _np(case.arrays["R"][0]), _np(case.arrays["u"])
    (got,) = case.fn(case.arrays)
    _close(_np(got).reshape(35, 8, C),
           _pallas(kern, [D, u.reshape(35, 8, C)], (35, 8, C)))
    _check_3x(fold_probe2.matvec_case("I", "3x", "cpu", E=E), _mv_oracle)


def site_fold2_123():
    """tpu_fold_probe2.py:302-320: mapping III, per-run slices; its 3x
    variant held to float64."""
    case = fold_probe2.matvec_case("III", "f32", "cpu", E=E)

    def kern(d_ref, u_ref, o_ref):
        d = d_ref[...]
        for s in range(8):
            o_ref[:, s, :] = _dot(d, u_ref[:, s, :], precision=None)
    D, u = _np(case.arrays["R"][0]), _np(case.arrays["u"])
    (got,) = case.fn(case.arrays)
    _close(_np(got).reshape(35, 8, C),
           _pallas(kern, [D, u.reshape(35, 8, C)], (35, 8, C)))
    _check_3x(fold_probe2.matvec_case("III", "3x", "cpu", E=E), _mv_oracle)


def site_fold2_191():
    """tpu_fold_probe2.py:355-389: the div on folded storage, per-run
    slices; its 3x variant held to float64."""
    case = fold_probe2.div_case("f32", "cpu", E=E)

    def kern(dr_ref, j_ref, u_ref, o_ref):
        for s in range(8):
            us = u_ref[:, s, :]
            acc = None
            for r in range(3):
                t = _dot(dr_ref[r], us, precision=None)
                w = j_ref[r, s, :][None, :] * t
                acc = w if acc is None else acc + w
            o_ref[:, s, :] = acc
    R, J, u = (_np(case.arrays[k]) for k in ("R", "J", "u"))
    (got,) = case.fn(case.arrays)
    _close(_np(got).reshape(35, 8, C),
           _pallas(kern, [R, J.reshape(3, 8, C), u.reshape(35, 8, C)],
                   (35, 8, C)))
    _check_3x(fold_probe2.div_case("3x", "cpu", E=E), _div_oracle)


def _fold3_mv(variant, nd):
    case = fold_probe3.matvec_case(variant, nd, "cpu", E=E)
    u = _np(case.arrays["u"])
    (got,) = case.fn(case.arrays)
    if variant == "base":
        def kern(d, uu, o):
            o[...] = _dot(d[...], uu[...])
        ref = _pallas(kern, [_np(case.arrays["R"][0]), u], u.shape)
    elif variant == "fold-I":
        def kern(d_ref, u_ref, o_ref):
            um = u_ref[...].reshape(nd, 8 * C)
            o_ref[...] = _dot(d_ref[...], um).reshape(nd, 8, C)
        ref = _pallas(kern, [_np(case.arrays["R"][0]), u.reshape(nd, 8, C)],
                      (nd, 8, C)).reshape(nd, E)
    else:
        def kern(dp_ref, u_ref, o_ref):
            um = u_ref[...].reshape(nd * 8, C)
            o_ref[...] = _dot(dp_ref[...], um).reshape(nd, 8, C)

        def kron_fn(D, u3):
            eye = jnp.eye(8, dtype=D.dtype)
            Dp = jnp.einsum("ij,st->isjt", D, eye).reshape(nd * 8, nd * 8)
            return _pallas(kern, [np.asarray(Dp), u3], (nd, 8, C))
        # the script's kron_fn (:130-133) builds D' from D; the port's case
        # holds D' itself: recover D from its (0, 0) sub-blocks
        D = _np(case.arrays["R"][0])[::8, ::8]
        ref = kron_fn(jnp.asarray(D), u.reshape(nd, 8, C)).reshape(nd * 8, C)
    _close(_np(got), ref.reshape(_np(got).shape))


def site_fold3_95():
    """tpu_fold_probe3.py:95-103: base matvec at HIGHEST, nd 20 and 35."""
    for nd in (20, 35):
        _fold3_mv("base", nd)


def site_fold3_109():
    """tpu_fold_probe3.py:105-116: fold-I matvec, nd 20 and 35."""
    for nd in (20, 35):
        _fold3_mv("fold-I", nd)


def site_fold3_122():
    """tpu_fold_probe3.py:118-134: kron matvec, nd 20 and 35."""
    for nd in (20, 35):
        _fold3_mv("kron", nd)


def _div_body(folded):
    """tpu_fold_probe3.py:148-155 (base) and :172-180 (fold-I)."""
    def div_base(r_ref, j_ref, u_ref, o_ref):
        u = u_ref[...]
        acc = None
        for s in range(3):
            t = _dot(r_ref[s], u)
            t = t * j_ref[s, :][None, :]
            acc = t if acc is None else acc + t
        o_ref[...] = acc

    def div_fold(r_ref, j_ref, u_ref, o_ref):
        u = u_ref[...].reshape(35, 8 * C)
        j = j_ref[...].reshape(3, 8 * C)
        acc = None
        for s in range(3):
            t = _dot(r_ref[s], u)
            t = t * j[s, :][None, :]
            acc = t if acc is None else acc + t
        o_ref[...] = acc.reshape(35, 8, C)
    return div_fold if folded else div_base


def _fold3_div(folded):
    case = fold_probe3.div_case(folded, "cpu", E=E)
    R, J, u = (_np(case.arrays[k]) for k in ("R", "J", "u"))
    if folded:
        ref = _pallas(_div_body(True), [R, J.reshape(3, 8, C),
                                        u.reshape(35, 8, C)], (35, 8, C))
    else:
        ref = _pallas(_div_body(False), [R, J, u], u.shape)
    (got,) = case.fn(case.arrays)
    _close(_np(got), ref.reshape(35, E))


def site_fold3_158():
    """tpu_fold_probe3.py:158-166: the div, dof-major."""
    _fold3_div(False)


def site_fold3_183():
    """tpu_fold_probe3.py:183-191: the div, fold-I."""
    _fold3_div(True)


def _prec_mv(module, per_run_or_folded, tpu_prec, precision, body):
    for nd in (20, 35):
        case = module.matvec_case(per_run_or_folded, nd, "HIGHEST" if
                                  tpu_prec is None else tpu_prec, "cpu", E=E)
        D, u = _np(case.arrays["R"][0]), _np(case.arrays["u"])
        shape = (nd, 8, C) if body != "base" else u.shape
        if body == "base":
            def kern(d, uu, o):
                o[...] = _dot(d[...], uu[...], precision=precision)
        elif body == "fold":
            def kern(d, uu, o, nd=nd):
                um = uu[...].reshape(nd, 8 * C)
                o[...] = _dot(d[...], um,
                              precision=precision).reshape(nd, 8, C)
        else:
            def kern(d, uu, o):
                dd = d[...]
                for s in range(8):
                    o[:, s, :] = _dot(dd, uu[:, s, :], precision=precision)
        ref = _pallas(kern, [D, u.reshape(shape)], shape)
        (got,) = case.fn(case.arrays)
        _close(_np(got), ref.reshape(nd, E))
        split = {fold_probe4: "X3", fold_probe5: "n3x"}[module]
        _check_3x(module.matvec_case(per_run_or_folded, nd, split, "cpu",
                                     E=E), _mv_oracle)


def site_fold4_95():
    """tpu_fold_probe4.py:91-102: base matvec at HIGHEST (f32); X3 -> 3x
    held to float64."""
    _prec_mv(fold_probe4, False, "HIGHEST", HI, "base")


def site_fold4_110():
    """tpu_fold_probe4.py:104-117: fold matvec (mapping I)."""
    _prec_mv(fold_probe4, True, "HIGHEST", HI, "fold")


def _rowcore_kernel(folded, per_run):
    """tpu_fold_probe4.py:128-170 (div_rowcore, make_div_base/_fold) and
    tpu_fold_probe5.py:119-158 (rowcore, make_div_base/_fIII)."""
    def rowcore(Rcat, u, J):
        tmp = jnp.concatenate([u * J[s, :][None, :] for s in range(3)],
                              axis=0)
        return _dot(Rcat, tmp)

    def kern(r_ref, jx, ux, jy, uy, jz, uz, ox, oy, oz):
        Rcat = jnp.concatenate([r_ref[s] for s in range(3)], axis=1)
        for (j, u, o) in ((jx, ux, ox), (jy, uy, oy), (jz, uz, oz)):
            if per_run:
                for s in range(8):
                    o[:, s, :] = rowcore(Rcat, u[:, s, :], j[:, s, :])
            elif folded:
                um = u[...].reshape(35, 8 * C)
                jm = j[...].reshape(3, 8 * C)
                o[...] = rowcore(Rcat, um, jm).reshape(35, 8, C)
            else:
                o[...] = rowcore(Rcat, u[...], j[...])
    return kern


def _div3(module, folded, split):
    case = module.div_case(folded, "HIGHEST", "cpu", E=E)
    a = {k: _np(v) for k, v in case.arrays.items()}
    ushape, jshape = ((35, 8, C), (3, 8, C)) if folded else ((35, E),
                                                            (3, E))
    args = [a["R"]]
    for b in range(3):
        args += [a[f"J{b}"].reshape(jshape), a[f"u{b}"].reshape(ushape)]
    refs = _pallas(_rowcore_kernel(folded and module is fold_probe4,
                                   folded and module is fold_probe5),
                   args, [ushape] * 3)
    for got, ref in zip(case.fn(case.arrays), refs, strict=True):
        _close(_np(got), ref.reshape(35, E))
    _check_3x(module.div_case(folded, split, "cpu", E=E), _div3_oracle)


def site_fold4_144():
    """tpu_fold_probe4.py:136-151: the div, b = 3 rows, base."""
    _div3(fold_probe4, False, "X3")


def site_fold4_163():
    """tpu_fold_probe4.py:154-170: the div, b = 3 rows, fold."""
    _div3(fold_probe4, True, "X3")


def site_fold4_201():
    """tpu_fold_probe4.py:192-207: the X3 accuracy call (X3 runs f32 on
    the CPU); its port route, 3xTF32, held to float64."""
    case = fold_probe4.matvec_case(True, 35, "HIGHEST", "cpu", E=E)

    def mvx3(d, u, o):
        um = u[...].reshape(35, 8 * C)
        r = _dot(d[...], um,
                 precision=jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3)
        o[...] = r.reshape(35, 8, C)
    D, u = _np(case.arrays["R"][0]), _np(case.arrays["u"])
    (got,) = case.fn(case.arrays)
    _close(_np(got), _pallas(mvx3, [D, u.reshape(35, 8, C)],
                             (35, 8, C)).reshape(35, E))
    _check_3x(fold_probe4.matvec_case(True, 35, "X3", "cpu", E=E),
              _mv_oracle)


def site_fold5_87():
    """tpu_fold_probe5.py:83-94: base matvec (HIGHEST); n3x held to
    float64."""
    _prec_mv(fold_probe5, False, "HIGHEST", HI, "base")


def site_fold5_102():
    """tpu_fold_probe5.py:96-109: fIII, per-run slices."""
    _prec_mv(fold_probe5, True, "HIGHEST", HI, "fIII")


def site_fold5_133():
    """tpu_fold_probe5.py:126-140: the div, b = 3, base."""
    _div3(fold_probe5, False, "n3x")


def site_fold5_151():
    """tpu_fold_probe5.py:143-158: the div, b = 3, fIII."""
    _div3(fold_probe5, True, "n3x")


def site_fold5_187():
    """tpu_fold_probe5.py:180-193: the native-3x accuracy call
    (``bfloat16_3x`` runs f32 on the CPU); its port route held to float64."""
    case = fold_probe5.matvec_case(False, 35, "HIGHEST", "cpu", E=E)

    def acc_k(d, u, o):
        o[...] = _dot(d[...], u[...], precision="bfloat16_3x")
    D, u = _np(case.arrays["R"][0]), _np(case.arrays["u"])
    (got,) = case.fn(case.arrays)
    _close(_np(got), _pallas(acc_k, [D, u], u.shape))
    _check_3x(fold_probe5.matvec_case(False, 35, "n3x", "cpu", E=E),
              _mv_oracle)


def _kron_matvec_body(ndof, blk_c, jac):
    """tpu_kron_probe.py:39-55, the "hi" branch."""
    def kernel(*refs):
        if jac:
            u_ref, mk_ref, j_ref, o_ref = refs
        else:
            u_ref, mk_ref, o_ref = refs
        ub = u_ref[...].reshape(ndof * 8, blk_c)
        core = _dot(mk_ref[...], ub)
        core = core.reshape(ndof, 8, blk_c)
        if jac:
            core = core * j_ref[...][None, :, :]
        o_ref[...] = core
    return kernel


def _kron_site(E_, runs):
    for run in runs:
        case = kron_probe.kron_case(run, "cpu", E=E_)
        _, ndof, _, prec, jac = kron_probe.KRON_RUNS[run]
        c = E_ // 8
        a = {k: _np(v) for k, v in case.arrays.items()}
        args = [a["u"].reshape(ndof, 8, c), a["R"][0]] + (
            [a["jac"]] if jac else [])
        ref = _pallas(_kron_matvec_body(ndof, c, jac), args, (ndof, 8, c))
        if prec == "3x":
            _check_3x(case, _kron_oracle(ndof, jac))
            continue
        (got,) = case.fn(case.arrays)
        _close(_np(got).reshape(ndof, 8, c), ref)


def site_kron_62():
    """tpu_kron_probe.py:22-68: kron_matvec, mvec20 and mass35 (jac), HI;
    the 3x runs held to float64."""
    _kron_site(kron_probe.E_KRON_CPU, range(len(kron_probe.KRON_RUNS)))


def site_kron_90():
    """tpu_kron_probe.py:89-98: the small-scale call ``s_call`` (smallc =
    512, one grid step), which the script builds and never calls: the same
    kernel, restated at its block."""
    _kron_site(8 * 512, (1, 4))


def site_lane_52():
    """tpu_lane_reshape_probe.py:49-59 (run_case's pallas_call) with the
    kernels A-D of :93-112, at every (d, g) (the script's --interpret
    size, E = 2**12)."""
    for d, g in lane_reshape_probe.SHAPES:
        B, gd = E // g, g * d

        def kA(x_ref, o_ref):
            o_ref[...] = 2.0 * x_ref[...]

        def kB(j_ref, x_ref, o_ref):
            b = x_ref.shape[0]
            t = x_ref[...].reshape(b, g, d) * j_ref[...][:, :, None]
            o_ref[...] = t.reshape(b, gd)

        def kC(K_ref, j_ref, x_ref, o_ref):
            b = x_ref.shape[0]
            t = jax.lax.dot_general(x_ref[...], K_ref[...], DIMS,
                                    preferred_element_type=jnp.float32)
            t = t.reshape(b, g, d) * j_ref[...][:, :, None]
            o_ref[...] = t.reshape(b, gd)

        def kD(K_ref, x_ref, o_ref):
            o_ref[...] = jax.lax.dot_general(
                x_ref[...], K_ref[...], DIMS,
                preferred_element_type=jnp.float32)
        for kind, kern in zip("ABCD", (kA, kB, kC, kD)):
            case = lane_reshape_probe.kernel_case(kind, d, g, "cpu", E=E)
            a = {k: _np(v) for k, v in case.arrays.items()}
            K = a["R"][0].T if "R" in a else None
            args = {"A": [a["x"]], "B": [a.get("j"), a["x"]],
                    "C": [K, a.get("j"), a["x"]], "D": [K, a["x"]]}[kind]
            ref = _pallas(kern, args, (B, gd))
            got = _np(probes._as_list(case.fn(case.arrays))[0])
            if kind in "CD":
                got = got.T            # (I, E) view of the (B, g d) output
            _close(got.reshape(B, gd), ref)


SITES = {
    "tpu_layout_probe.py:75": site_layout_75,
    "tpu_layout_probe.py:101": site_layout_101,
    "tpu_layout_probe.py:119": site_layout_119,
    "tpu_fold_probe.py:84": site_fold_84,
    "tpu_fold_probe.py:96": site_fold_96,
    "tpu_fold_probe.py:117": site_fold_117,
    "tpu_fold_probe.py:162": site_fold_162,
    "tpu_fold_probe2.py:102": site_fold2_102,
    "tpu_fold_probe2.py:123": site_fold2_123,
    "tpu_fold_probe2.py:191": site_fold2_191,
    "tpu_fold_probe3.py:95": site_fold3_95,
    "tpu_fold_probe3.py:109": site_fold3_109,
    "tpu_fold_probe3.py:122": site_fold3_122,
    "tpu_fold_probe3.py:158": site_fold3_158,
    "tpu_fold_probe3.py:183": site_fold3_183,
    "tpu_fold_probe4.py:95": site_fold4_95,
    "tpu_fold_probe4.py:110": site_fold4_110,
    "tpu_fold_probe4.py:144": site_fold4_144,
    "tpu_fold_probe4.py:163": site_fold4_163,
    "tpu_fold_probe4.py:201": site_fold4_201,
    "tpu_fold_probe5.py:87": site_fold5_87,
    "tpu_fold_probe5.py:102": site_fold5_102,
    "tpu_fold_probe5.py:133": site_fold5_133,
    "tpu_fold_probe5.py:151": site_fold5_151,
    "tpu_fold_probe5.py:187": site_fold5_187,
    "tpu_kron_probe.py:62": site_kron_62,
    "tpu_kron_probe.py:90": site_kron_90,
    "tpu_lane_reshape_probe.py:52": site_lane_52,
}


def test_every_pallas_call_site_is_restated():
    """The sites above are the scripts' ``pl.pallas_call`` lines, all 28."""
    found = set()
    for path in sorted((REPO / "scripts").glob("tpu_*probe*.py")):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if "pl.pallas_call(" in line:
                found.add(f"{path.name}:{n}")
    assert found == set(SITES)
    assert len(SITES) == 28


@pytest.mark.parametrize("site", sorted(SITES))
def test_probe_site_matches_the_tpu_body(site):
    kernels.reset_launch_counts()
    SITES[site]()
    assert not any(kernels.launch_counts.values())   # CPU: plain versions

# }}}


# {{{ plans, views, refusals

def _emulate_stream(ops, alpha, plan):
    """The kernel's addressing: each operand read through the plan's
    strides from its storage, the output written through its strides."""
    v = torch.full(plan.shape, float(alpha))
    for o, t in enumerate(ops):
        v = v * torch.as_strided(t, plan.shape, plan.in_strides[o],
                                 t.storage_offset())
    out = torch.empty(ops[0].numel())
    torch.as_strided(out, plan.shape, plan.out_strides).copy_(v)
    return out.view(ops[0].shape)


def _stream_views(rng, E_=777):
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    return {
        "copy_ragged": ([t(E_, 35), t(E_, 35)], 1.0, "scalar"),
        "copy_aligned": ([t(780, 35), t(780, 35)], 1.0, "flat4"),
        "copy_offset": ([t(E_ * 35 + 1)[1:].view(E_, 35), t(E_, 35)], 1.0,
                        "scalar"),
        "copy_offset_flat": ([t(780 * 35 + 1)[1:].view(780, 35),
                              t(780, 35)], 1.0, "flat4"),
        "transpose_long": ([t(300, 200).t()], 1.0, "tile"),
        "batched_transpose": ([t(3, E_, 35).permute(0, 2, 1)], 1.0, "tile"),
        "to_dof_major": ([t(E_, 35).t()], 1.0, "tile"),
        "to_element_major": ([t(35, E_).t()], 1.0, "tile"),
        "scale": ([t(E_, 64)], 2.0, "flat4"),
        "lane_b_d4": ([t(E_, 16 * 4).view(E_, 16, 4),
                       t(E_, 16)[:, :, None].expand(E_, 16, 4)], 1.0,
                      "flat4"),
        "lane_b_d10": ([t(E_, 16 * 10).view(E_, 16, 10),
                        t(E_, 16)[:, :, None].expand(E_, 16, 10)], 1.0,
                       "flat4"),
        "transposed_times_broadcast": ([t(E_, 35).t(),
                                        t(E_)[None].expand(35, E_)], 1.0,
                                       "tile"),
        "folded": ([probes.fold(t(35, 800)), probes.fold(t(35, 800))], 1.0,
                   "flat4"),
    }


@pytest.mark.parametrize("name", sorted(_stream_views(
    np.random.default_rng(0))))
def test_stream_plan_addresses_every_element(name):
    """The stream plan merges, orders and strides the axes so that the
    kernel's addressing (emulated through the plan's strides) gives the
    plain version exactly; the path is the expected one."""
    ops, alpha, mode = _stream_views(np.random.default_rng(1))[name]
    out = torch.empty(ops[0].shape)
    plan = pk.plan_stream(tuple(ops[0].shape), [t.stride() for t in ops],
                          out.stride(),
                          aligned=[pk._aligned(t) for t in [out, *ops]])
    assert plan.mode == mode
    assert len(plan.shape) == 3
    if mode == "tile":
        assert plan.mask & 1 and plan.in_strides[0][1] == 1
    if mode == "flat4":        # the operands laid out as the output: float4
        assert plan.mask == sum(
            1 << o for o, t in enumerate(ops)
            if t.is_contiguous() and t.shape == ops[0].shape
            and pk._aligned(t))
    assert torch.equal(_emulate_stream(ops, alpha, plan),
                       pk.probe_stream_plain(ops, alpha=alpha))
    assert torch.equal(pk.probe_stream_f32(ops, alpha=alpha),
                       pk.probe_stream_plain(ops, alpha=alpha))


def test_stream_plan_merges_the_folded_copy_into_one_axis():
    """A folded copy and its dof-major copy are one stream of the same
    bytes; a transposed operand keeps two axes and takes the tile."""
    a = torch.zeros(35, 4096)
    f = probes.fold(a)
    plan_f = pk.plan_stream(f.shape, [f.stride()], f.contiguous().stride())
    plan_d = pk.plan_stream(a.shape, [a.stride()], a.stride())
    assert plan_f == plan_d
    assert plan_f.shape == (1, 1, 35 * 4096) and plan_f.mode == "flat4"
    t = a.t()
    plan_t = pk.plan_stream(t.shape, [t.stride()], (35, 1))
    assert plan_t.mode == "tile" and plan_t.shape == (1, 4096, 35)


def test_folded_storage_is_a_view_of_dof_major():
    u = probes.draw(np.random.default_rng(0), (35, 4096), torch.device(
        "cpu"))
    f = probes.fold(u)
    assert f.shape == (35, 8, 512)
    assert f.data_ptr() == u.data_ptr()
    assert f.untyped_storage().nbytes() == u.untyped_storage().nbytes()
    assert torch.equal(f.reshape(35, 4096), u)
    assert f[3, 2, 7] == u[3, 2 * 512 + 7]
    with pytest.raises(ValueError, match="multiple of the fold"):
        probes.fold(torch.zeros(35, 100))


def _elements_taken(E_, runs, block_elems, sub=pk.PA_TE, tiles=1, grid=0):
    """Every (row tile, element) of a probe_apply launch in the order its
    persistent blocks take them: block b walks the items b, b + grid, ...
    (*grid* 0: one block per item); an item (row tile fastest, then the
    sub-tile of *sub* elements, then the element block) maps its local
    indices to elements as the kernel's ``item_of`` and ``elem`` do."""
    run, n = pk.apply_geometry(E_, runs, block_elems, sub)
    nsub = -(-(runs * n) // sub)
    nitems = tiles * nsub * -(-run // n)
    taken = []
    for b in range(grid or nitems):
        for w in range(b, nitems, grid or nitems):
            r, ti = divmod(w, tiles)
            eb, st = divmod(r, nsub)
            for l in range(st * sub, min((st + 1) * sub, runs * n)):
                f, c = divmod(l, n)
                c += eb * n
                if c < run:
                    taken.append((ti, f * run + c))
    return taken


@pytest.mark.parametrize("E_,runs,block_elems", [
    (777, 1, 0), (777, 1, 300), (776, 8, 0), (776, 8, 16), (4096, 8, 2048),
    (4096, 1, 32768), (1000, 8, 8 * 125)])
def test_apply_tiling_takes_every_element_once(E_, runs, block_elems):
    """Each (row tile, element) is taken exactly once, whatever the
    sub-tile (the kernels' 128, 224, 256 and 512), the number of row tiles
    and the persistent grid (one block, a few, a card's worth, one per
    item)."""
    assert sorted(_elements_taken(E_, runs, block_elems)) == [
        (0, e) for e in range(E_)]
    for sub in (128, 224, 256, 512):
        for tiles in (1, 3):
            for grid in (1, 7, 264, 0):
                taken = _elements_taken(E_, runs, block_elems, sub, tiles,
                                        grid)
                assert sorted(taken) == [(t, e) for t in range(tiles)
                                         for e in range(E_)]


def test_apply_mapping_I_takes_each_run_in_a_block():
    """Under mapping I a block's elements come from every run; under III
    (runs = 1) from one contiguous range."""
    run, n = pk.apply_geometry(4096, 8, 128)
    assert (run, n) == (512, 16)
    first = [e for _, e in _elements_taken(4096, 8, 128)[:128]]
    assert sorted({e // 512 for e in first}) == list(range(8))
    assert [e for _, e in _elements_taken(4096, 1, 128)[:128]] == list(
        range(128))


def test_apply_default_block_is_one_sub_tile_of_the_kernel():
    """The default element block is one sub-tile of the kernel's tile
    (:func:`apply_tile`), so no item is cut short; an explicit block keeps
    its meaning."""
    for I, split in ((35, False), (20, False), (16, False), (640, False),
                     (35, True), (280, True)):
        _, sub = pk.apply_tile(I, split)
        assert pk.apply_geometry(2 ** 20, 8, 0, sub) == (2 ** 17, sub // 8)
        assert pk.apply_geometry(2 ** 20, 8, 2048, sub) == (2 ** 17, 256)


def _pitch(n, m):
    return n + ((m - n) % 32 + 32) % 32


@pytest.mark.parametrize("split,S_", [(False, 1), (False, 3), (True, 1),
                                      (True, 3)])
def test_apply_tile_fits_a_block(split, S_):
    """For every I the kernel takes, the tile (``csrc/probe_apply.cu``'s
    ``f32_tile`` / ``x3_tile``) covers I in as few row tiles of at most 128
    rows as it can (all of I up to 64: one tile; 64 where J weights S > 1
    f32 partials; at most 32), as even as the row quantum allows, with
    float4-aligned rows, element sub-tiles that split into 8 runs of a
    multiple of 4, at most 256 threads, and a four-stage ring of 16 j's
    within a block's 227 KB (R's slabs of every s in one f32 chunk at S >
    1)."""
    for I in range(1, pk.PA_MAX_DIM + 1):
        rows, elems = pk.apply_tile(I, split, S_)
        assert rows % (8 if split else 4) == 0 and elems % 32 == 0
        widest = 64 if S_ > 1 and not split else 128
        tiles = -(-I // rows)
        assert rows <= widest and tiles <= 32
        assert tiles == 1 if I <= 64 else tiles in (-(-I // widest),
                                                    -(-I // 96),
                                                    -(-I // 64))
        if split or I <= 64 or S_ > 1:          # as even as can be
            quantum = 8 if split and I <= 64 else 16 if split else 4
            assert rows - -(-I // tiles) < quantum
        else:                           # 64, 96 or 128, the least padded
            assert rows * tiles == min(-(-I // r) * r for r in (64, 96, 128))
        # u's chunk [j][l], or [l][j] with an element's pitch 20 (j-fast)
        if split:
            stage = 16 * 2 * _pitch(rows, 8) + max(16 * _pitch(elems, 8),
                                                   20 * elems)
        else:
            tm = 4 if I <= 64 or S_ > 1 else 8
            assert (rows // tm) * (elems // 8) <= 256
            # at S > 1 a chunk holds R's slab of every s
            stage = S_ * 16 * _pitch(rows, 4) + max(16 * _pitch(elems, 4),
                                                    20 * elems)
        assert 4 * stage * 4 <= 227 * 1024


def _kron_eye_left(D: torch.Tensor, g: int) -> torch.Tensor:
    """kron(I_g, D): the lane-pack facts' block-diagonal resident."""
    return torch.block_diag(*[D] * g)


def _ranges_by_scan(R: torch.Tensor, tile_rows: int) -> np.ndarray:
    """The range table by a direct scan of each (s, row tile) of R."""
    a = R.numpy()
    S, I, _ = a.shape
    tiles = -(-I // tile_rows)
    out = np.zeros((S, tiles, 2), np.int32)
    for s in range(S):
        for t in range(tiles):
            cols = np.nonzero(a[s, t * tile_rows:(t + 1) * tile_rows]
                              != 0)[1]
            if cols.size:
                out[s, t] = cols.min() // pk.PA_KC, cols.max() // pk.PA_KC + 1
    return out


def _range_cases():
    """(label, R): block-diagonal kron(I_g, D) whose band edges fall on
    neither a 16-j chunk nor a row tile, the packed vecmat's kron(I_16,
    x^T), a dense R, an all-zero R[s] at S = 3, a NaN in R."""
    rng = np.random.default_rng(5)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    cases = {f"kron(I{g}, D{d})": _kron_eye_left(t(d, d), g)[None]
             for g, d in ((16, 20), (16, 35), (32, 35))}
    cases["vecmat kron(I16, x^T)"] = _kron_eye_left(t(1, 35), 16)[None]
    cases["dense 35"] = t(1, 35, 35)
    zero_s = t(3, 35, 35)
    zero_s[1] = 0.0
    zero_s[2, :, 20:] = -0.0
    cases["S = 3, R[1] zero"] = zero_s
    nan = _kron_eye_left(t(20, 20), 16)[None].clone()
    nan[0, 5, 300] = float("nan")
    cases["NaN"] = nan
    return cases


@pytest.mark.parametrize("label", sorted(_range_cases()))
def test_range_table_matches_a_direct_scan(label):
    """The plain version of the kernels' pre-pass against a direct scan,
    at both kernels' row tiles and at 36 and 40 rows; a dense R keeps every
    chunk, an all-zero R[s] none, ±0 counts as zero and a NaN as nonzero."""
    R = _range_cases()[label]
    S, I, K = R.shape
    for tile_rows in {pk.apply_tile(I, False, S)[0],
                      pk.apply_tile(I, True, S)[0], 36, 40}:
        got = pk.probe_apply_ranges_plain(R, tile_rows)
        assert got.dtype == torch.int32
        assert got.shape == (S, -(-I // tile_rows), 2)
        assert np.array_equal(got.numpy(), _ranges_by_scan(R, tile_rows))
    full = pk.probe_apply_ranges_plain(R, 36)
    nk = -(-K // pk.PA_KC)
    if label == "dense 35":
        assert full.tolist() == [[[0, nk]]]
    if label.startswith("S = 3"):
        assert full[1].tolist() == [[0, 0]]
        assert full[2].tolist() == [[0, 2]]     # -0.0 past j = 20 is zero
    if label == "NaN":
        tiles = pk.probe_apply_ranges_plain(R, 128)
        assert tiles[0, 0].tolist() == [0, 300 // pk.PA_KC + 1]
    if label.startswith("kron(I16, D20)"):
        # a 128-row tile of a d = 20 band meets 140 j's, 9 chunks of 40
        assert pk.probe_apply_ranges_plain(R, 128)[0].tolist() == [
            [0, 9], [7, 17], [15, 20]]


def _ranged_apply(rows, R, tile_rows, out_elem_major=False):
    """The kernels' sum, chunk by chunk in the range table's order, over
    the ranged chunks only, in float64."""
    ranges = pk.probe_apply_ranges_plain(R, tile_rows)
    S, I, K = R.shape
    outs = []
    for row in rows:
        E_ = row.u.shape[1]
        out = torch.zeros(I, E_, dtype=torch.float64)
        for t in range(ranges.shape[1]):
            rs = slice(t * tile_rows, min(I, (t + 1) * tile_rows))
            for s in range(S):
                part = torch.zeros(rs.stop - rs.start, E_,
                                   dtype=torch.float64)
                for c in range(*ranges[s, t].tolist()):
                    js = slice(c * pk.PA_KC, min(K, (c + 1) * pk.PA_KC))
                    part += R[s, rs, js].double() @ row.u[js].double()
                out[rs] += part * (row.J[s].double() if row.J is not None
                                   else 1.0)
        if row.sigma is not None:
            out = out * row.sigma.reshape(I, E_).double()
        outs.append(out.float())
    return outs


@pytest.mark.parametrize("label", sorted(_range_cases()))
def test_ranged_sum_equals_the_plain_version(label):
    """Summing only the ranged chunks gives ``probe_apply_plain`` exactly:
    on integer-valued data (every sum exact in float32) with R's zeros where
    the case has them, J at S = 3, sigma broadcast as the kron probe's jac;
    a NaN in R stays a NaN."""
    R = _range_cases()[label]
    R = torch.where(R == 0, R, torch.round(R * 2).clamp(-3, 3))
    R[R != R] = float("nan")
    S, I, K = R.shape
    rng = np.random.default_rng(6)

    def ints(*shape):
        return torch.from_numpy(rng.integers(-4, 5, shape).astype(
            np.float32))
    E_ = 48
    rows = [pk.ApplyRow(u=ints(K, E_), J=ints(S, E_) if S > 1 else None,
                        sigma=ints(1, E_)[None].expand(I, 1, E_))
            for _ in range(2)]
    for split in (False, True):
        tile_rows = pk.apply_tile(I, split, S)[0]
        for got, want in zip(_ranged_apply(rows, R, tile_rows),
                             pk.probe_apply_plain(rows, R)):
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       equal_nan=True)


def _kernel_tf32_round(x: np.ndarray) -> np.ndarray:
    """``csrc/probe_apply.cu``'s ``tf32_round`` on the bit pattern: add
    0x1000 and clear the low 13 bits unless the exponent is all ones."""
    u = x.astype(np.float32).view(np.uint32).copy()
    finite = (u & 0x7f800000) != 0x7f800000
    u[finite] = (u[finite] + np.uint32(0x1000)) & np.uint32(0xffffe000)
    return u.view(np.float32)


def test_prepass_split_planes_equal_tf32_split():
    """The pre-pass's split as the kernel writes it (hi = tf32_round(x),
    lo = tf32_round(x - hi)) equals ``tf32_split`` bit for bit, on normal
    values, ties, subnormals, values that round to infinity, ±0, ±inf and
    NaN; the wrapper's CPU path hands the same planes to *tables*."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(4096).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -3e-39,
                        3.4e38, -3.4028235e38, 1.0 + 2 ** -11,
                        1.0 + 2 ** -11 + 2 ** -23], np.float32)
    ties = (rng.integers(0, 2 ** 19, 512, dtype=np.uint64).astype(np.uint32)
            << 13 | 0x1000).astype(np.uint32).view(np.float32)
    x = np.concatenate([x, bits.view(np.float32), special, ties])
    hi = _kernel_tf32_round(x)
    with np.errstate(invalid="ignore"):
        lo = _kernel_tf32_round(x - hi)
    t_hi, t_lo = kernels.tf32_split(torch.from_numpy(x))
    for mine, theirs in ((hi, t_hi.numpy()), (lo, t_lo.numpy())):
        nan = np.isnan(mine)
        assert np.array_equal(nan, np.isnan(theirs))
        assert np.array_equal(mine.view(np.uint32)[~nan],
                              theirs.view(np.uint32)[~nan])
    R = torch.from_numpy(rng.standard_normal((3, 35, 35)).astype(np.float32))
    rows = [pk.ApplyRow(u=torch.zeros(35, 64), J=torch.zeros(3, 64))]
    tables: dict = {}
    pk.probe_apply_3xtf32(rows, R, tables=tables)
    assert torch.equal(tables["hi"], kernels.tf32_split(R)[0])
    assert torch.equal(tables["lo"], kernels.tf32_split(R)[1])
    assert torch.equal(tables["ranges"], pk.probe_apply_ranges_plain(
        R, pk.apply_tile(35, True)[0]))


def test_apply_flags_follow_the_storage():
    """16-byte staging for a contiguous, aligned element axis; the lanes
    along j for element-major u; float4 stores of a dof-major output."""
    u = torch.zeros(35, 4096)
    out = torch.zeros(35, 4096)
    flags = pk.apply_flags([pk.ApplyRow(u=u)], [out], 4096, 128, False)
    assert flags == pk._U_VEC | pk._OUT_VEC
    em = torch.zeros(4096, 35).t()
    flags = pk.apply_flags([pk.ApplyRow(u=em)], [torch.zeros(4096, 35).t()],
                           4096, 128, True)
    assert flags == pk._U_K_FAST | pk._OUT_ELEM_MAJOR
    J = torch.zeros(3, 776)
    sg = torch.zeros(8, 776)[None].expand(35, 8, 776)
    flags = pk.apply_flags([pk.ApplyRow(u=torch.zeros(35, 776), J=J,
                                        sigma=sg)], [torch.zeros(35, 776)],
                           97, 16, False)
    assert flags == pk._HAS_J | pk._HAS_SIGMA     # run 97: no vectors


def _row(K=35, E_=64, S_=1, **kw):
    return pk.ApplyRow(u=torch.zeros(K, E_),
                       J=torch.zeros(S_, E_) if S_ > 1 else None, **kw)


@pytest.mark.parametrize("call,match", [
    (lambda: pk.probe_apply_f32([_row()] * 4, torch.zeros(1, 35, 35)),
     "b = 4 rows"),
    (lambda: pk.probe_apply_f32([_row(K=2049)], torch.zeros(1, 35, 2049)),
     "over the kernel's limit"),
    (lambda: pk.probe_apply_f32([_row(K=35)], torch.zeros(1, 2049, 35)),
     "over the kernel's limit"),
    (lambda: pk.probe_apply_f32([_row(S_=4)], torch.zeros(4, 35, 35)),
     "S = 4"),
    (lambda: pk.probe_apply_f32([pk.ApplyRow(u=torch.zeros(35, 64))],
                                torch.zeros(3, 35, 35)), "needs J"),
    (lambda: pk.probe_apply_f32([_row(E_=100)], torch.zeros(1, 35, 35),
                                runs=8), "not a multiple of runs"),
    (lambda: pk.probe_apply_f32([_row()], torch.zeros(1, 35, 35), runs=8,
                                block_elems=12), "do not split"),
    (lambda: pk.probe_apply_f32([_row()], torch.zeros(1, 35, 35,
                                                      dtype=torch.float64)),
     "takes float32"),
    (lambda: pk.probe_stream_f32([torch.zeros(4)] * 3), "1 or 2 operands"),
    (lambda: pk.probe_stream_f32([torch.zeros(4, dtype=torch.float64)]),
     "float32"),
    (lambda: pk.plan_stream((5, 3, 2, 4), [(1, 20, 60, 5)], (24, 8, 4, 1)),
     "walks 4 axes"),
])
def test_refusals(call, match):
    """Refusals name their limit: rows, R's size, S, J, the tiling, the
    dtypes, the stream's operands and axes."""
    with pytest.raises((InvalidParameterError, ValueError), match=match):
        call()


@pytest.mark.parametrize("make", [
    lambda: ([_row(), pk.ApplyRow(u=torch.zeros(64, 35).t())],
             torch.zeros(1, 35, 35)),
    lambda: ([_row(S_=3), pk.ApplyRow(u=torch.zeros(35, 64),
                                      J=torch.zeros(64, 3).t())],
             torch.zeros(3, 35, 35)),
    lambda: ([_row(), _row(E_=32)], torch.zeros(1, 35, 35)),
])
def test_apply_refuses_mismatched_storages(make):
    rows, R = make()
    with pytest.raises(ValueError, match="mismatched storages"):
        pk.probe_apply_f32(rows, R)


def test_stream_refuses_mismatched_storages():
    with pytest.raises(ValueError, match="mismatched storages"):
        pk.probe_stream_f32([torch.zeros(35, 64), torch.zeros(64, 35)])


def test_sigma_shape_is_checked():
    with pytest.raises(ValueError, match="I1 \\* I2"):
        pk.probe_apply_f32([_row(sigma=torch.zeros(5, 6, 64))],
                           torch.zeros(1, 35, 35))


def test_probe_modules_run_nothing_at_import():
    """Importing every probe module prints nothing, launches nothing and
    leaves the cases unbuilt (each module's ``cases`` is a generator)."""
    code = (
        "import importlib, pkgutil\n"
        "import feinsum_tpu_torch.probes as p\n"
        "from feinsum_tpu_torch.ops import kernels\n"
        "mods = [importlib.import_module(m.name) for m in\n"
        "        pkgutil.iter_modules(p.__path__, p.__name__ + '.')]\n"
        "import inspect\n"
        "assert len(mods) == 8, mods\n"
        "assert all(inspect.isgeneratorfunction(m.cases) for m in mods)\n"
        "assert not any(kernels.launch_counts.values())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == ""


def test_probes_take_no_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: layout_probe.copy_case(0),
                  lambda: fold_probe2.div_case("f32"),
                  lambda: next(lane_reshape_probe.cases()),
                  lambda: kron_probe.kron_case(0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    case = layout_probe.transpose_case("cpu", E=64)
    assert case.arrays["a"].device.type == "cpu"


@pytest.mark.parametrize("module", [layout_probe, fold_probe, fold_probe2,
                                    fold_probe3, fold_probe4, fold_probe5,
                                    kron_probe, lane_reshape_probe],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_module_cpu_mode_checks_every_case(module, capsys, monkeypatch):
    """``python -m feinsum_tpu_torch.probes.<name> --cpu``: every case of
    the module runs at the small size, checked against its plain version,
    untimed."""
    monkeypatch.setattr(sys, "argv", ["probe", "--cpu"])
    module.main()
    out = capsys.readouterr().out
    assert "cases done" in out and "not timed" in out
    assert "FAIL" not in out

# }}}

"""The port's matcher (``feinsum_tpu_torch.matching``, over ``torch.fx``)
held to the JAX package's (over jaxprs) on the corpus of
``tests/test_matching.py``: each function is written once in ``jnp`` and
once in ``torch`` and matched on the same numpy-seeded inputs.

The matched einsums must be the same einsum: equal canonical forms (names,
index letters, shapes, dtypes, the archive key), the same b and name map,
and the same instructions (``InsnInfo``: output slot, position, scale,
traced scale factors and their exponents, the operands read).  The order of
a matched einsum's operands is not compared: ``jnp.einsum`` lowers a
contraction to a chain of ``dot_general``s whose order the reference's
matcher follows, while ``torch.einsum`` stays one graph node in the
user's order; the canonical form is independent of that order.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feinsum_tpu as fr
import feinsum_tpu_torch as ft
from feinsum_tpu import matching as ref_matching
from feinsum_tpu_torch import matching
from feinsum_tpu_torch.einsum import SizeParam
from feinsum_tpu_torch.interop import einsum_from_reference

SEED = 3


def _inputs(specs, seed=SEED):
    """(jax args, torch args) from the same numpy draws: a shape tuple is a
    float32 array, a float a rank-0 float32 scalar."""
    rng = np.random.default_rng(seed)
    arrays = [np.float32(s) if isinstance(s, float)
              else rng.random(s, np.float32) for s in specs]
    return ([jnp.asarray(a) for a in arrays],
            [torch.tensor(a) if np.ndim(a) == 0 else torch.from_numpy(a)
             for a in arrays])


def assert_same_einsum(ref, ours):
    """The same matched einsum: canonical form, b and name map."""
    (re, rnm), (oe, onm) = ref, ours
    assert ft.canonicalize_einsum(oe) == einsum_from_reference(
        fr.canonicalize_einsum(re))
    assert oe.b == re.b
    assert onm == rnm


def _info(info):
    return (info.out_index, info.term_index, info.flat_index, info.scale,
            frozenset(info.arg_names), len(info.scale_vars),
            tuple(info.scale_var_pows))


def assert_same_instructions(jfn, tfn, specs, **kw):
    jargs, targs = _inputs(specs)
    ref = ref_matching.get_matched_einsums(jfn, jargs, **kw)
    ours = matching.get_matched_einsums(tfn, targs, **kw)
    assert len(ours) == len(ref)
    for (re, rnm, rinfo), (oe, onm, oinfo) in zip(ref, ours):
        assert_same_einsum((re, rnm), (oe, onm))
        assert _info(oinfo) == _info(rinfo)
    return ref, ours


def _match_both(jfn, tfn, specs, **kw):
    jargs, targs = _inputs(specs)
    ref = ref_matching.get_a_matched_einsum(jfn, jargs, **kw)
    ours = matching.get_a_matched_einsum(tfn, targs, **kw)
    assert_same_einsum(ref, ours)
    return ref, ours


# {{{ the corpus: (name, jnp function, torch function, input specs)

def _j_rhs(J, D, u, L, F, flux):
    vol = jnp.einsum("es,sij,ej->ei", J, D, u)
    surf = jnp.einsum("ifj,fe,fej->ei", L, F, flux)
    return 2.0 * vol - surf


def _t_rhs(J, D, u, L, F, flux):
    vol = torch.einsum("es,sij,ej->ei", J, D, u)
    surf = torch.einsum("ifj,fe,fej->ei", L, F, flux)
    return 2.0 * vol - surf


RHS_SPECS = ((2048, 3), (3, 8, 8), (2048, 8), (8, 4, 6), (4, 2048),
             (4, 2048, 6))

SINGLE = [
    ("single dot", lambda u, D: jnp.einsum("ej,ij->ei", u, D),
     lambda u, D: torch.einsum("ej,ij->ei", u, D), ((600, 35), (35, 35))),
    ("grad", lambda J, D, u: jnp.einsum("xre,rij,ej->xei", J, D, u),
     lambda J, D, u: torch.einsum("xre,rij,ej->xei", J, D, u),
     ((3, 3, 700), (3, 35, 35), (700, 35))),
    ("elementwise", lambda a, b: jnp.einsum("ij,ij->ij", a, b),
     lambda a, b: torch.einsum("ij,ij->ij", a, b), ((600, 35), (600, 35))),
    ("rowsum", lambda a: jnp.einsum("ij->i", a),
     lambda a: torch.einsum("ij->i", a), ((600, 35),)),
    ("batched rows",
     lambda Jx, Jy, R, ux, uy: (jnp.einsum("es,sij,ej->ei", Jx, R, ux),
                                jnp.einsum("es,sij,ej->ei", Jy, R, uy)),
     lambda Jx, Jy, R, ux, uy: (torch.einsum("es,sij,ej->ei", Jx, R, ux),
                                torch.einsum("es,sij,ej->ei", Jy, R, uy)),
     ((600, 3), (600, 3), (3, 8, 8), (600, 8), (600, 8))),
    ("tanh epilogue", lambda a, b: jnp.tanh(a @ b),
     lambda a, b: torch.tanh(a @ b), ((600, 8), (8, 8))),
    ("literal factor", lambda u, D: 0.5 * jnp.einsum("ej,ij->ei", u, D),
     lambda u, D: 0.5 * torch.einsum("ej,ij->ei", u, D),
     ((600, 35), (35, 35))),
    ("sum operand", lambda a, b, M: jnp.einsum("ej,ij->ei", a + b, M),
     lambda a, b, M: torch.einsum("ej,ij->ei", a + b, M),
     ((600, 8), (600, 8), (8, 8))),
    ("affine operand",
     lambda J, u, D: jnp.einsum("e,ej,ij->ei", 2.0 * J + 1.0, u, D),
     lambda J, u, D: torch.einsum("e,ej,ij->ei", 2.0 * J + 1.0, u, D),
     ((600,), (600, 8), (8, 8))),
    ("nonlinear operand", lambda u, D: jnp.exp(u) @ D,
     lambda u, D: torch.exp(u) @ D, ((600, 8), (8, 8))),
    ("scalar offset epilogue",
     lambda u, D: jnp.einsum("ej,ij->ei", u, D) + 1.0,
     lambda u, D: torch.einsum("ej,ij->ei", u, D) + 1.0,
     ((600, 8), (8, 8))),
    ("matmul transposed", lambda u, D: u @ D.T,
     lambda u, D: u @ D.T, ((600, 8), (8, 8))),
    ("permuted grad",
     lambda J, D, u: jnp.transpose(jnp.einsum("xre,rij,ej->xei", J, D, u),
                                   (1, 2, 0)),
     lambda J, D, u: torch.einsum("xre,rij,ej->xei", J, D, u).permute(
         1, 2, 0), ((3, 3, 700), (3, 10, 10), (700, 10))),
    ("reduction by sum", lambda u, v: jnp.sum(u * v, axis=1),
     lambda u, v: (u * v).sum(1), ((600, 8), (600, 8))),
    ("cast", lambda u, D: (u @ D).astype(jnp.float32),
     lambda u, D: (u @ D).to(torch.float32), ((600, 8), (8, 8))),
]

# }}}


@pytest.mark.parametrize("name, jfn, tfn, specs", SINGLE,
                         ids=[c[0] for c in SINGLE])
def test_single_instruction_matches_reference(name, jfn, tfn, specs):
    (re, _), (oe, _) = _match_both(jfn, tfn, specs)
    assert len(oe.all_size_params) == len(re.all_size_params)


@pytest.mark.parametrize("name, jfn, tfn, specs", SINGLE,
                         ids=[c[0] for c in SINGLE])
def test_instruction_enumeration_matches_reference(name, jfn, tfn, specs):
    assert_same_instructions(jfn, tfn, specs)


def test_sum_of_einsums_selection_matches_reference():
    jargs, targs = _inputs(RHS_SPECS)
    with pytest.raises(ft.EinsumMatchError, match="insn_match"):
        matching.get_a_matched_einsum(_t_rhs, targs)
    for sel in (lambda i: "flux" in i.arg_names, (0, 0), 1,
                lambda i: "D" in i.arg_names):
        assert_same_einsum(
            ref_matching.get_a_matched_einsum(_j_rhs, jargs, insn_match=sel),
            matching.get_a_matched_einsum(_t_rhs, targs, insn_match=sel))
    ref, ours = assert_same_instructions(_j_rhs, _t_rhs, RHS_SPECS)
    assert [i.scale for _, _, i in ours] == [2.0, -1.0]
    with pytest.raises(ft.EinsumMatchError, match="selected no instruction"):
        matching.get_a_matched_einsum(_t_rhs, targs,
                                      insn_match=lambda i: False)


def test_knowledge_transfer_matches_reference():
    ref_e = fr.einsum("xre,rij,ej->xei",
                      fr.array("Jac", (3, 3, "E"), "float32"),
                      fr.array("Dmat", (3, 35, 35), "float32"),
                      fr.array("dofs", ("E", 35), "float32"))
    jargs, targs = _inputs(((3, 3, 900), (3, 35, 35), (900, 35)))
    subst_ref = ref_matching.match_fn_to_einsum(
        lambda a_jac, a_mat, a_u: jnp.einsum("spn,pdq,nq->snd", a_jac,
                                             a_mat, a_u), jargs, ref_e)

    def user_fn(a_jac, a_mat, a_u):
        return torch.einsum("spn,pdq,nq->snd", a_jac, a_mat, a_u)
    subst = matching.match_fn_to_einsum(user_fn, targs,
                                        einsum_from_reference(ref_e))
    assert {k: subst[k] for k in ("Jac", "Dmat", "dofs")} == {
        "Jac": "a_jac", "Dmat": "a_mat", "dofs": "a_u"}
    assert {k: subst_ref[k] for k in ("Jac", "Dmat", "dofs")} == {
        k: subst[k] for k in ("Jac", "Dmat", "dofs")}
    matched, _ = matching.get_a_matched_einsum(user_fn, targs)
    assert isinstance(matched.index_to_dim_length[subst["e"]], SizeParam)
    assert matching.get_call_ids(user_fn, targs) == frozenset(
        {"a_jac", "a_mat", "a_u"})


def test_traced_scalar_factors_match_reference():
    def j_neg(u, D, alpha):
        return -(alpha * jnp.einsum("ej,ij->ei", u, D))

    def t_neg(u, D, alpha):
        return -(alpha * torch.einsum("ej,ij->ei", u, D))
    _, ours = assert_same_instructions(j_neg, t_neg,
                                       ((600, 8), (8, 8), 3.0))
    assert ours[0][2].scale == -1.0 and len(ours[0][2].scale_vars) == 1

    def factor_first(einsum, literal_first):
        def f(u, D, alpha):
            s = 2.0 * alpha if literal_first else alpha * 2.0
            return s * einsum("ej,ij->ei", u, D)
        return f

    for literal_first in (False, True):
        _, ours = assert_same_instructions(
            factor_first(jnp.einsum, literal_first),
            factor_first(torch.einsum, literal_first),
            ((600, 8), (8, 8), 3.0))
        assert len(ours[0][2].scale_vars) == 1

    def jdiv(u, alpha, beta):
        return beta * jnp.einsum("ej,ej->e", u, u) / alpha

    def tdiv(u, alpha, beta):
        return beta * torch.einsum("ej,ej->e", u, u) / alpha
    _, ours = assert_same_instructions(jdiv, tdiv, ((600, 8), 2.0, 3.0))
    assert ours[0][2].scale_var_pows == (1, -1)


def test_captured_constants_match_reference():
    M = np.random.default_rng(1).random((8, 8), np.float32)
    jM, tM = jnp.asarray(M), torch.from_numpy(M)
    ref = ref_matching.get_a_matched_einsum(
        lambda u: jnp.einsum("ej,ij->ei", u, jM), _inputs(((600, 8),))[0])
    ours = matching.get_a_matched_einsum(
        lambda u: torch.einsum("ej,ij->ei", u, tM), _inputs(((600, 8),))[1])
    assert_same_einsum(ref, ours)
    assert ours[1] == {"u": 0, "expr0": ()}

    # constants folded at trace time are captured constants too
    def fn2(u, M):
        return torch.einsum("ej,ij->ei", u * torch.ones(600, 8).T.T, M)
    e2, nm2 = matching.get_a_matched_einsum(fn2, _inputs(((600, 8),
                                                          (8, 8)))[1])
    assert any(v == () for v in nm2.values())

    def fn3(u, M):
        s = torch.sum(torch.ones(8, 8), dim=0)
        return torch.einsum("ej,ij->ei", u * s[None, :], M)
    e3, _ = matching.get_a_matched_einsum(fn3, _inputs(((600, 8),
                                                        (8, 8)))[1])
    assert e3.n >= 2


def test_curl_component_difference_matches_reference():
    def jcurl(Jy, Jz, D, Fz, Fy):
        return (jnp.einsum("es,sij,ej->ei", Jy, D, Fz)
                - jnp.einsum("es,sij,ej->ei", Jz, D, Fy))

    def tcurl(Jy, Jz, D, Fz, Fy):
        return (torch.einsum("es,sij,ej->ei", Jy, D, Fz)
                - torch.einsum("es,sij,ej->ei", Jz, D, Fy))
    specs = ((600, 3), (600, 3), (3, 7, 7), (600, 7), (600, 7))
    jargs, targs = _inputs(specs)
    for k in (0, 1):
        assert_same_einsum(
            ref_matching.get_a_matched_einsum(jcurl, jargs, insn_match=k),
            matching.get_a_matched_einsum(tcurl, targs, insn_match=k))
    assert_same_instructions(jcurl, tcurl, specs)


def test_scalar_einsum_sums_match_reference():
    def jf(u, v):
        return jnp.einsum("ej,ej->", u, u) + jnp.einsum("ej,ej->", u, v)

    def tf(u, v):
        return torch.einsum("ej,ej->", u, u) + torch.einsum("ej,ej->", u, v)
    _, ours = assert_same_instructions(jf, tf, ((600, 8), (600, 8)))
    assert all(e.out_idx_set == () for e, _nm, _i in ours)


def test_epilogue_frontier_enumeration_matches_reference():
    def jf(u, D):
        return jnp.tanh(jnp.einsum("ej,ij->ei", u, D))

    def tf(u, D):
        return torch.tanh(torch.einsum("ej,ij->ei", u, D))
    _, ours = assert_same_instructions(jf, tf, ((600, 8), (8, 8)))
    assert ours[0][2].out_index >= 1 and ours[0][1] == {"u": 0, "D": 1}


def test_consumer_rhs_matches_reference():
    """The instructions of examples/compile_user_rhs.py's limited RHS: the
    three div terms (one over the ``2 Jz + 1`` expression), the lift and
    the energy, each scale and traced factor as in the reference."""
    from feinsum_tpu_torch import suite as S

    def j_rhs(dt, Jx, Jy, Jz, R, ux, uy, uz, L, Fj, flux):
        div = (jnp.einsum("es,sij,ej->ei", Jx, R, ux)
               + jnp.einsum("es,sij,ej->ei", Jy, R, uy)
               - jnp.einsum("es,sij,ej->ei", 2.0 * Jz + 1.0, R, uz))
        lift = jnp.einsum("ifj,fe,fej->ei", L, Fj, flux)
        r = dt * (div - 0.5 * lift)
        energy = jnp.sqrt(jnp.einsum("ej,ej->", ux, ux))
        return jnp.tanh(r), energy

    E, nd = 600, 8
    specs = (0.125, (E, 3), (E, 3), (E, 3), (3, nd, nd), (E, nd), (E, nd),
             (E, nd), (nd, 4, 6), (4, E), (4, E, 6))
    _, ours = assert_same_instructions(j_rhs, S.user_rhs_limited, specs)
    assert sorted(i.scale for _, _, i in ours) == [-1.0, -0.5, 1.0, 1.0,
                                                   1.0]


def test_pure_non_einsum_still_rejects():
    with pytest.raises(ft.EinsumMatchError,
                       match="outside the batched-einsum"):
        matching.get_a_matched_einsum(lambda u: torch.tanh(u),
                                      _inputs(((600, 8),))[1])


def test_untraceable_and_broadcast_matmul_raise():
    def branchy(u):
        return u @ u.T if bool(u.sum() > 0) else u
    with pytest.raises(ft.EinsumMatchError, match="symbolic_trace"):
        matching.get_a_matched_einsum(branchy, _inputs(((600, 8),))[1])

    def bmm(a, b):
        return a @ b
    with pytest.raises(ft.EinsumMatchError, match="broadcast batch"):
        matching.get_a_matched_einsum(bmm, _inputs(((2, 600, 8),
                                                    (1, 8, 8)))[1])


def test_abstract_long_axes_and_map_names_match_reference():
    e = fr.einsum("ej,ij->ei", fr.array("u", (100_000, 35), "float32"),
                  fr.array("D", (35, 35), "float32"))
    ours = matching.abstract_long_axes(einsum_from_reference(e))
    assert ours == einsum_from_reference(ref_matching.abstract_long_axes(e))
    ref_e = fr.einsum("ej,ij->ei", fr.array("x", ("E", 35), "float32"),
                      fr.array("M", (35, 35), "float32"))
    assert matching.map_names(einsum_from_reference(ref_e), ours) == \
        ref_matching.map_names(ref_e, ref_matching.abstract_long_axes(e))


def test_graph_cse_collapses_repeated_expressions():
    """The ``torch.fx`` counterpart of ``hoist_cses_in_jaxpr``: two einsum
    calls over the same ``2 J + 1`` read one expression operand, and the
    deduplicated callable computes what the function computes."""
    def fn(J, u, D):
        a = torch.einsum("e,ej,ij->ei", 2.0 * J + 1.0, u, D)
        b = torch.einsum("e,ej,ij->ei", 2.0 * J + 1.0, u, D.T)
        return a + b

    args = _inputs(((600,), (600, 8), (8, 8)))[1]
    g = ft.hoist_cses_in_fn(fn, args)
    assert sum(n.op == "call_function" and n.target is torch.einsum
               for n in g.graph.nodes) == 2
    assert sum(n.op == "call_function" and "add" in str(n.target)
               for n in g.graph.nodes) == 2      # 2J + 1 once, and a + b
    torch.testing.assert_close(g(*args), fn(*args))
    insns = matching.get_matched_einsums(fn, args)
    assert {n for _, nm, _ in insns for n in nm} == {"u", "D", "expr0"}

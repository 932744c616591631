"""K1's general step algebra on the port: ``step_block_f32``
(``feinsum_tpu_torch/ops/step_block.py``, ``ops/kernels.py``) against the
JAX package's K1 (``build_pallas_executable``) on the programs no row family
takes, and the demo space ``demo_transform_space``.

The reference programs are built by the JAX package (its own spaces and
``fused_pallas_program``) with ``block_long >= E``, so that its Pallas
kernel runs in interpret mode on one grid step (ROADMAP fault F3), and
carried across with ``feinsum_tpu_torch.interop``; both get the same seeded
numpy inputs.  On CPU tensors the port's wrapper runs ``step_block_plain``;
:func:`emulate` runs the offset tables the kernel receives
(``step_block_tables``) the way ``csrc/step_block.cu`` reads them, so that
the host's side of the kernel is held to the plain version here;
``test_torch_kernels.py`` holds the kernel itself to its plain version on
the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import feinsum_tpu as fr
import feinsum_tpu_torch as ft
from feinsum_tpu.measure import (
    apply_layouts as ref_apply_layouts,
    generate_input_arrays as ref_generate_input_arrays,
)
from feinsum_tpu.tuning import \
    get_transform_func_from_module_path as ref_space
from feinsum_tpu.tuning.impls._common import \
    fused_pallas_program as ref_fused_pallas_program
from feinsum_tpu_torch.canonicalization import canonicalize_einsum
from feinsum_tpu_torch.codegen.program import get_index_lengths
from feinsum_tpu_torch.contraction_schedule import (
    ContractionSchedule,
    EinsumOperand,
    IntermediateResult,
)
from feinsum_tpu_torch.interop import arrays_from_numpy, \
    program_from_reference
from feinsum_tpu_torch.measure import apply_layouts, generate_input_arrays
from feinsum_tpu_torch.ops import kernels
from feinsum_tpu_torch.ops.cuda_emitter import grid_letter, \
    hoist_resident_steps, plan_cuda_launch, row_family
from feinsum_tpu_torch.ops.step_block import plan_step_block
from feinsum_tpu_torch.tuning import get_transform_func_from_module_path
from feinsum_tpu_torch.tuning.impls import _common

E = 48
RTOL = 2e-5


def _a(name, shape):
    return ft.array(name, shape, "float32")


# the programs no row family takes, at narrow widths: (einsum, hoist)
CASES = {
    # (a) outputs beyond (x?, e, i): the demo and sum factorization on
    # hexahedra (the optimal path: three steps, each carrying e)
    "demo_ndof6": (ft.einsum("ij,ejk->eik", _a("A", (6, 6)),
                             _a("B", ("E", 6, 6))), False),
    "sumfact_q4": (ft.einsum("ai,bj,ck,eabc->eijk", _a("Ax", (5, 5)),
                             _a("Ay", (5, 5)), _a("Az", (5, 5)),
                             _a("u", ("E", 5, 5, 5))), True),
    "sumfact_q4_one_step": (ft.einsum(
        "ai,bj,ck,eabc->eijk", _a("Ax", (5, 5)), _a("Ay", (5, 5)),
        _a("Az", (5, 5)), _a("u", ("E", 5, 5, 5))), False),
    # (b) a contraction-free row whose operands do not share a layout
    "broadcast_ndof5": (ft.einsum("ej,e->ej", _a("A", ("E", 5)),
                                  _a("w", ("E",))), False),
    # (c) a contracted long axis with a resident operand, with two short
    # letters per operand, and an outer product above 64 x 64
    "resident_reduce_ndof7": (ft.einsum("ej,j->", _a("A", ("E", 7)),
                                        _a("w", (7,))), False),
    "two_letter_reduce": (ft.einsum("eij,ejk->ik", _a("P", ("E", 5, 6)),
                                    _a("Q", ("E", 6, 5))), False),
    "gram_ndof70x66": (ft.einsum("ei,ej->ij", _a("u", ("E", 70)),
                                 _a("v", ("E", 66))), False),
    # more register tiles than a block has threads (21 x 21 tiles of 8 x
    # 8): the kernel takes them in rounds
    "gram_ndof165": (ft.einsum("ei,ej->ij", _a("u", ("E", 165)),
                               _a("v", ("E", 165))), False),
    # (d) b = 2: both rows in one launch, with their own operands
    "demo_b2": (ft.batched_einsum(
        "ij,ejk->eik", [[_a("A", (5, 5)), _a("B", ("E", 5, 5))],
                        [_a("C", (5, 5)), _a("D", ("E", 5, 5))]]), False),
}


def to_reference(e):
    def dim(d):
        return d.name if isinstance(d, ft.SizeParam) else d
    return fr.batched_einsum(e.get_subscripts(), [
        [fr.array(a.name, tuple(dim(d) for d in a.shape), a.dtype)
         for a in row] for row in e.args])


def reference_program(e, hoist: bool, dofmajor: bool = False):
    """The JAX package's fused program at one grid step."""
    r = to_reference(e)
    return ref_fused_pallas_program(
        fr.generate_program(r), block_long=E, hoist=hoist,
        dofmajor=dofmajor, parallel_grid=False)


def port_program(e, hoist: bool, dofmajor: bool = False,
                 block_long: int = E):
    return _common.fused_pallas_program(
        ft.generate_program(e), block_long=block_long, hoist=hoist,
        dofmajor=dofmajor, parallel_grid=False)


def run_both(ref_prog, seed=0, length=E):
    stored = ref_apply_layouts(ref_prog, ref_generate_input_arrays(
        ref_prog.einsum, long_dim_length=length, seed=seed, as_numpy=True))
    ref_fn = fr.build_executable(ref_prog, long_dim_length=length)
    ref_outs = [np.asarray(o) for o in ref_fn(
        {k: np.asarray(v) for k, v in stored.items()})]
    fn = ft.build_executable(program_from_reference(ref_prog),
                             long_dim_length=length, device="cpu")
    outs = [o.numpy() for o in fn(arrays_from_numpy(stored, "cpu"))]
    return ref_outs, outs


def assert_close(got, ref, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def emulate(rows, table, block_long: int) -> list:
    """``step_block_f32`` as ``csrc/step_block.cu`` computes it, in float64
    on the CPU: the tables, step descriptions and staging offsets the
    wrapper hands the kernel, the residents copied flat into a shared-memory
    array and the streamed inputs' sub-tiles into their two buffers, each
    step over the sub-tiles of each block (a dense step through its M, N,
    K and batch tables, a general one through its entry tables), a
    contracted long axis summed into per-block partial sums (a dense
    reduce's by the kernel's register tiles, every tile of every round)
    and then across blocks."""
    el = table.el
    s0 = next((s for s, letters in enumerate(table.inputs) if el in letters),
              None)
    E_ = 1 if s0 is None else rows[0][s0].shape[table.inputs[s0].index(el)]
    last = table.steps[-1]
    perm = [table.stored_out.index(ix) for ix in last.out]
    outs = []
    for row in rows:
        out = torch.zeros(tuple(E_ if ix == el else table.length[ix]
                                for ix in table.stored_out),
                          dtype=torch.float64)
        view = out.permute(tuple(perm))
        in_strides = tuple(tuple(t.stride()) for t in row)
        mode = kernels.step_block_mode(table, in_strides, view.stride())
        tabs, steps_i, steps_t, stage_i, stage_t = \
            kernels.step_block_tables(table, in_strides, tuple(view.stride()),
                                      mode)
        flat = []
        for t in row:
            span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
            f = torch.zeros(span, dtype=torch.float64)
            torch.as_strided(f, t.shape, t.stride()).copy_(t.double())
            flat.append(f.numpy())
        es = [kernels._sb_strides(letters, t.stride(), el)[1]
              for letters, t in zip(table.inputs, row)]
        out_flat = out.view(-1).numpy()
        out_es = kernels._sb_strides(last.out, view.stride(), el)[1]
        smem = np.zeros(max(1, table.smem_floats))
        for s, (res, res_n, *_rest) in enumerate(stage_i[:-1]):
            if res >= 0:
                smem[res:res + res_n] = flat[s][:res_n]

        def tab(off, n):
            return tabs[off:off + n]

        def sub_tile(s, n):
            """(entries' offsets in the tensor, shared-memory index of each
            (entry, element)) of row *s* of stage_i for n elements."""
            _res, _rn, buf, _bn, ns, pitch, efast, gaff = stage_i[s]
            le, x = np.arange(n), np.arange(ns)
            go = x * stage_t[s] if gaff else tab(stage_t[s], ns)
            idx = (x[:, None] * pitch + le[None, :] if efast
                   else le[None, :] * pitch + x[:, None])
            return go, idx

        def stage_copy(e0, n, parity):
            le = np.arange(n)
            for s in range(len(stage_i) - 1):
                buf, buf_n = stage_i[s][2:4]
                if buf < 0:
                    continue
                go, idx = sub_tile(s, n)
                smem[buf + parity * buf_n + idx] = flat[s][
                    (e0 + le)[None, :] * es[s] + go[:, None]]

        def copy_out(e0, n):
            le = np.arange(n)
            go, idx = sub_tile(len(stage_i) - 1, n)
            out_flat[(e0 + le)[None, :] * out_es + go[:, None]] = smem[
                stage_i[-1][2] + idx]

        def operand(src, e0, parity):
            if src >= 0:
                res, _n, buf, buf_n, _ns, pitch, efast, _g = stage_i[src]
                if res >= 0:
                    return smem, res, 0
                if buf >= 0:
                    return smem, buf + parity * buf_n, 1 if efast else pitch
                return flat[src], e0 * es[src], es[src]
            pk = steps_i[-1 - src]
            return smem, pk[8], pk[9] if pk[0] == 1 else 0

        def run(k, e0, n, parity):
            si, tt = steps_i[k], steps_t[k]
            kind, nops, n_out, n_sum = si[:4]
            src, dst, des, groups, affine, dense = (si[4:4 + nops], si[8],
                                                    si[9], si[10], si[11],
                                                    si[12])
            nM, nN, nK, nB = si[17:21]
            if kind == 2:
                dmem, dbase, des = red, 0, 0
            elif dst >= 0:
                dmem, dbase, des = smem, dst, des if kind == 1 else 0
            elif kind == 1 and stage_i[-1][2] >= 0:
                _r, _rn, buf, _bn, _ns, pitch, efast, _g = stage_i[-1]
                dmem, dbase, des = smem, buf, 1 if efast else pitch
            else:
                dmem, dbase, des = out_flat, e0 * out_es, out_es
            le = np.arange(n)
            if dense:
                (ma, ba, ea), (mb, bb, eb) = (operand(x, e0, parity)
                                              for x in src)
                Am, Ak, Ab, Bn, Bk, Bb, Dm, Dn, Db = (
                    np.arange(m) * tt[9 + q] if affine and q in (1, 4)
                    else tab(tt[9 + q], m) for q, m in enumerate(
                        (nM, nK, nB, nN, nK, nB, nM, nN, nB)))
                av = ma[ba + le[:, None, None, None] * ea
                        + Ab[None, :, None, None] + Am[None, None, :, None]
                        + Ak[None, None, None, :]]
                bv = mb[bb + le[:, None, None, None] * eb
                        + Bb[None, :, None, None] + Bn[None, None, :, None]
                        + Bk[None, None, None, :]]
                val = np.einsum("xbmk,xbnk->xbmn", av, bv)
                if kind == 2:
                    # the kernel's units (tile, group), in rounds of
                    # SB_THREADS: tile (tm, tn) holds the entries m = tm +
                    # tM * r, n = tn + tN * c of the result
                    rm, rn, tM, tN = si[15], si[16], si[21], si[22]
                    for u in range(tM * tN * groups):
                        tile, g = u % (tM * tN), u // (tM * tN)
                        ms = (tile % tM + tM * np.arange(rm))
                        ns = (tile // tM + tN * np.arange(rn))
                        ms, ns = ms[ms < nM], ns[ns < nN]
                        part = val[le % groups == g].sum(0)[0]
                        dmem[dbase + g * n_out + Dm[ms][:, None]
                             + Dn[ns][None, :]] += part[np.ix_(ms, ns)]
                    return
                dmem[dbase + le[:, None, None, None] * des
                     + Db[None, :, None, None] + Dm[None, None, :, None]
                     + Dn[None, None, None, :]] = val
                return
            prodv = np.ones((n_out, n, n_sum))
            for q in range(nops):
                o_tab = tab(tt[q], n_out)
                c_tab = (np.arange(n_sum) * tt[5 + q] if affine
                         else tab(tt[5 + q], n_sum))
                mem, base, e_st = operand(src[q], e0, parity)
                prodv = prodv * mem[base + le[None, :, None] * e_st
                                    + o_tab[:, None, None]
                                    + c_tab[None, None, :]]
            val = prodv.sum(2)
            if kind == 2:
                dmem[dbase + np.arange(n_out)] += val.sum(1)
                return
            dmem[dbase + le[None, :] * des + tab(tt[nops], n_out)[:, None]] \
                = val

        total = None
        si_last = steps_i[-1]
        red = np.zeros(si_last[2] * si_last[10])
        for b0 in range(0, E_, block_long):
            red[:] = 0
            for k, st in enumerate(table.steps):
                if st.kind == "free":
                    run(k, 0, 1, 0)
            e_end = min(E_, b0 + block_long)
            for sub, e0 in enumerate(range(b0, e_end, table.te)):
                n = min(table.te, e_end - e0)
                stage_copy(e0, n, sub % 2)
                for k, st in enumerate(table.steps):
                    if st.kind != "free":
                        run(k, e0, n, sub % 2)
                if stage_i[-1][2] >= 0:
                    copy_out(e0, n)
            if last.kind == "reduce":
                part = red.reshape(si_last[10], -1).sum(0)
                total = part if total is None else total + part
        if last.kind == "reduce":
            out_flat[tab(steps_t[-1][si_last[1]], si_last[2])] = total
        outs.append(out)
    return outs


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_block_matches_reference_k1(name):
    """Each program builds on the port's fused route, plans onto
    ``step_block_f32`` (before this kernel it raised) and matches the JAX
    package's K1 within 2e-5; the port's own ``fused_pallas_program``
    builds the reference's program."""
    e, hoist = CASES[name]
    ref_prog = reference_program(e, hoist)
    prog = program_from_reference(ref_prog)
    assert port_program(e, hoist) == prog
    plan = plan_cuda_launch(prog, get_index_lengths(e, E))
    assert plan.kernel == "step_block_f32"
    kernels.reset_launch_counts()
    ref_outs, outs = run_both(ref_prog, seed=2)
    assert len(outs) == e.b
    for got, ref in zip(outs, ref_outs):
        assert_close(got, ref)
    assert not any(kernels.launch_counts.values())


def test_sum_factorization_runs_three_steps():
    """With ``hoist`` the reference's optimal path has three steps, each
    carrying e, and the step table keeps them: the kernel does the
    schedule's work, not the one-step sum's."""
    e, _ = CASES["sumfact_q4"]
    prog = program_from_reference(reference_program(e, True))
    assert prog.schedule.subscripts == (
        "eabc,ai->ebci", "ebci,bj->ecij", "ecij,ck->eijk")
    table = plan_step_block(hoist_resident_steps(prog)[0],
                            get_index_lengths(e, E))
    assert [s.kind for s in table.steps] == ["element"] * 3
    assert [table.n_sum(s) for s in table.steps] == [5, 5, 5]
    one = plan_step_block(program_from_reference(reference_program(e, False)),
                          get_index_lengths(e, E))
    assert [table.n_sum(one.steps[0])] == [5 ** 3]


@pytest.mark.parametrize("layout", ["logical", "dofmajor"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_and_tables_match_the_einsum(name, layout):
    """``step_block_plain`` and the kernel's offset tables (:func:`emulate`)
    against the logical einsum in float64, over several blocks with a
    ragged tail (E = 101, 16 elements per block), in both stored layouts
    (the two thread mappings of the kernel)."""
    e, hoist = CASES[name]
    length = 101
    prog = port_program(e, hoist, dofmajor=layout == "dofmajor",
                        block_long=16)
    plan = plan_cuda_launch(prog, get_index_lengths(e, length))
    assert plan.kernel == "step_block_f32"
    logical = generate_input_arrays(e, long_dim_length=length, seed=4,
                                    device="cpu")
    rows = plan.operands(apply_layouts(prog, logical))
    kp = hoist_resident_steps(prog)[0]
    table = plan_step_block(kp, get_index_lengths(kp.einsum, length))
    subs = e.get_subscripts().replace(" ", "")
    out_perm = prog.descriptor.out_layout
    for r, (got, emu) in enumerate(zip(
            plan.plain(rows), emulate(rows, table, 16))):
        want = torch.einsum(subs, *[logical[a.name].double()
                                    for a in e.args[r]])
        if out_perm is not None:
            want = want.permute(*out_perm)
        assert got.is_contiguous()
        assert_close(got, want)
        assert_close(emu, want, rtol=1e-12)


def test_emulated_modes_cover_both_mappings():
    """The dof-major demo maps threads element-fastest, the logical one
    entry-fastest (``step_block_mode``)."""
    e, _ = CASES["demo_ndof6"]
    modes = []
    for dofmajor in (False, True):
        prog = port_program(e, False, dofmajor=dofmajor)
        rows = plan_cuda_launch(prog, get_index_lengths(e, E)).operands(
            apply_layouts(prog, generate_input_arrays(
                e, long_dim_length=E, device="cpu")))
        table = plan_step_block(prog, get_index_lengths(e, E))
        out_letters = table.steps[-1].out
        strides = torch.empty([E if ix == "e" else 6 for ix in
                               table.stored_out]).permute(
            *[table.stored_out.index(ix) for ix in out_letters]).stride()
        modes.append(kernels.step_block_mode(
            table, tuple(tuple(t.stride()) for t in rows[0]), strides))
    assert modes == [False, True]


def test_demo_space_is_the_reference_space():
    """``demo_transform_space``: the reference's parameter, range and
    einsum argument, and at every point the reference's program."""
    e = ft.einsum("ij,ejk->eik", _a("A", (35, 35)), _a("B", ("E", 35, 35)))
    r = to_reference(e)
    ours = get_transform_func_from_module_path("demo_transform_space")
    ref = ref_space("demo_transform_space")
    (name, p), = ours.get_param_space(e).items()
    (ref_name, rp), = ref.get_param_space(r).items()
    assert (name, p.low, p.high) == (ref_name, rp.low, rp.high) \
        == ("log2_block", 8, 13)
    assert set(ours.einsum_args) == set(ref.einsum_args) == {"long_axis"}
    refused = []
    for lb in range(8, 14):
        prog = ours.bind_args(e, log2_block=lb)(ft.generate_program(e))
        assert prog.descriptor.grid_index == "e"
        assert plan_cuda_launch(prog, get_index_lengths(
            e, 1000)).kernel == "step_block_f32"
        try:
            ref_prog = ref.bind_args(r, log2_block=lb)(fr.generate_program(r))
        except fr.InvalidParameterError as err:
            # the TPU's VMEM guard; a Hopper block's shared memory holds A
            # alone, whatever the block length
            assert "VMEM" in str(err)
            refused.append(lb)
            continue
        assert prog == program_from_reference(ref_prog)
    assert refused == [12, 13]


def test_demo_space_validates_and_tunes_on_the_cpu(tmp_path):
    """The demo through the entry point on CPU tensors: autotune into an
    archive, retrieve the champion and replay it against the oracle."""
    e = ft.einsum("ij,ejk->eik", _a("A", (6, 6)), _a("B", ("E", 6, 6)))
    db = str(tmp_path / "demo.sqlite")
    ft.autotune(e, "demo_transform_space", db_path=db, device="cpu",
                long_dim_length=300, test_limit=2)
    facts = ft.query(e, "cpu", db_path=db)
    assert {q.transform_id for q in facts} == {"demo_transform_space.py"}
    tr = ft.retrieve(e, "cpu", db_path=db)
    # a fact binds to the canonical einsum, whose long letter is the space's
    # long_axis: it replays on that einsum's program, as the tuner timed it
    c = canonicalize_einsum(e)
    ft.validate_batched_einsum_transform(c, tr, long_dim_length=300)
    kernels.reset_launch_counts()
    prog = tr(ft.generate_program(c))
    assert plan_cuda_launch(prog, get_index_lengths(
        c, 300)).kernel == "step_block_f32"
    fn = ft.build_executable(prog, long_dim_length=300, device="cpu")
    arrays = generate_input_arrays(c, long_dim_length=300, device="cpu")
    (out,) = fn(apply_layouts(prog, arrays))
    assert_close(out, torch.einsum(c.get_subscripts().replace(" ", ""),
                                   *[arrays[a.name].double()
                                     for a in c.args[0]]))
    assert kernels.launch_counts["step_block_f32"] == 0
    # on another spelling the bound grid_index names another letter (the
    # canonical long letter is i there): both packages grid over it, and
    # the port's output is the reference's (one grid step, i is 6 long)
    other = tr(ft.generate_program(e))
    assert other.descriptor.grid_index == "i"
    assert plan_cuda_launch(other, get_index_lengths(
        e, 300)).kernel == "step_block_f32"
    log2_block = other.descriptor.block_long.bit_length() - 1
    ref_prog = ref_space("demo_transform_space").bind_args(
        to_reference(c), log2_block=log2_block)(
            fr.generate_program(to_reference(e)))
    assert program_from_reference(ref_prog) == other
    (want,), (got,) = run_both(ref_prog, seed=3, length=300)
    assert_close(got, want)


def test_demo_validates_at_full_width_in_both_packages():
    """At the demo's width (ndof 35) both packages validate the space's
    point against the numpy oracle (one grid step)."""
    e = ft.einsum("ij,ejk->eik", _a("A", (35, 35)), _a("B", ("E", 35, 35)))
    ours = get_transform_func_from_module_path("demo_transform_space")
    ft.validate_batched_einsum_transform(
        e, ours.bind_args(e, log2_block=8), long_dim_length=200)
    r = to_reference(e)
    fr.validate_batched_einsum_transform(
        r, ref_space("demo_transform_space").bind_args(r, log2_block=8),
        long_dim_length=200)


# {{{ the grid letter

def _grid_case(subs, shapes, block_long, grid_index=None):
    """The JAX package's fused program of *subs* at one grid step (its
    block at least the grid letter's length), and the port's."""
    e = ft.einsum(subs, *[_a(n, s) for n, s in zip("ABC", shapes)])
    r = to_reference(e)
    ref_prog = fr.generate_program(r).with_descriptor(
        backend="pallas", block_long=block_long, grid_index=grid_index)
    return e, ref_prog


# the reference's grid choice (pallas_emitter.py::_pick_grid_index): a
# grid_index on another letter than the long one, two SizeParam letters
# (an output one preferred), a concrete einsum gridded over its longest
# output letter (2048) and one run without a grid (64); (einsum, shapes,
# block, grid_index, grid letter, kernel)
GRID_CASES = {
    "grid_index_other_letter": ("ij,ejk->eik", ((6, 6), ("E", 6, 6)), 64,
                                "i", "i", "step_block_f32"),
    "two_size_params": ("ij,ejf->eif", ((6, 6), ("E", 6, "F")), E, None, "e",
                        "step_block_f32"),
    "concrete_2048": ("ij,ejk->eik", ((6, 6), (2048, 6, 6)), 2048, None, "e",
                      "step_block_f32"),
    "concrete_2048_matvec": ("ej,ij->ei", ((2048, 6), (5, 6)), 2048, None,
                             "e", "dg_rows_f32"),
    "concrete_64": ("ij,ejk->eik", ((6, 6), (64, 6, 6)), 64, None, None,
                    "step_block_f32"),
    "concrete_64_matvec": ("ej,ij->ei", ((64, 6), (5, 6)), 64, None, None,
                           "step_block_f32"),
}


@pytest.mark.parametrize("name", sorted(GRID_CASES))
def test_grid_letter_matches_reference_k1(name):
    """Each grid-letter case (the fused route used to refuse all of them)
    plans on the reference's grid letter, onto ``step_block_f32`` or a row
    family, and matches the JAX package's K1 in interpret mode at one grid
    step within 2e-5 of max|ref|."""
    subs, shapes, block, grid_index, letter, kernel = GRID_CASES[name]
    e, ref_prog = _grid_case(subs, shapes, block, grid_index)
    prog = program_from_reference(ref_prog)
    lengths = get_index_lengths(e, E)
    assert grid_letter(prog, lengths) == letter
    assert plan_cuda_launch(prog, lengths).kernel == kernel
    if kernel == "step_block_f32":
        table = plan_step_block(prog, lengths)
        assert table.el == letter
        if letter is None:
            assert {s.kind for s in table.steps} == {"free"}
    ref_outs, outs = run_both(ref_prog, seed=5)
    for got, ref in zip(outs, ref_outs):
        assert_close(got, ref)


def test_grid_letter_tables_match_the_einsum():
    """The kernel's tables (:func:`emulate`) on a grid over another letter
    than the long one, over several blocks of it, and without a grid."""
    for subs, shapes, block, grid_index in (
            ("ij,ejk->eik", ((12, 6), ("E", 6, 6)), 4, "i"),
            ("ij,ejk->eik", ((6, 6), (40, 6, 6)), 64, None)):
        e, ref_prog = _grid_case(subs, shapes, block, grid_index)
        prog = program_from_reference(ref_prog)
        lengths = get_index_lengths(e, 30)
        plan = plan_cuda_launch(prog, lengths)
        logical = generate_input_arrays(e, long_dim_length=30, seed=6,
                                        device="cpu")
        rows = plan.operands(apply_layouts(prog, logical))
        table = plan_step_block(prog, lengths)
        want = torch.einsum(subs, *[logical[a.name].double()
                                    for a in e.args[0]])
        (emu,) = emulate(rows, table, block)
        (got,) = plan.plain(rows)
        assert_close(emu, want, rtol=1e-12)
        assert_close(got, want)

# }}}


# {{{ the thread tilings

def _planned(e, hoist):
    prog = port_program(e, hoist, dofmajor=True, block_long=512)
    kp = hoist_resident_steps(prog)[0]
    return prog, plan_step_block(kp, get_index_lengths(kp.einsum, 1000))


def test_dense_steps_plan_register_tiles():
    """The demo, each sum-factorization step and the Gram matrix plan as
    dense products with register tiles of at least 4 x 4 where M and N
    allow (the Gram matrix's reduce step splits K = e); the one-step sum
    factorization plans 5 entries per thread along i, which only Ax
    carries; ``step_block_plain`` of each matches the einsum in float64."""
    demo = ft.einsum("ij,ejk->eik", _a("A", (35, 35)), _a("B", ("E", 35, 35)))
    gram = ft.einsum("ei,ej->ij", _a("u", ("E", 120)), _a("v", ("E", 120)))
    sumfact, _ = CASES["sumfact_q4"]
    _, t = _planned(demo, False)
    (st,) = t.steps
    assert (st.kind, st.mode, st.split) == (
        "element", "dense", (("i",), ("k",), ("j",), ()))
    assert min(st.tile) >= 4
    _, t = _planned(gram, False)
    (st,) = t.steps
    assert (st.kind, st.mode, st.tile, st.split) == (
        "reduce", "dense", (8, 8), (("i",), ("j",), (), ()))
    _, t = _planned(sumfact, True)
    assert [(st.mode, st.split[2], st.split[1]) for st in t.steps] == [
        ("dense", ("a",), ("i",)), ("dense", ("b",), ("j",)),
        ("dense", ("c",), ("k",))]
    assert all(min(st.tile) >= 4 for st in t.steps)
    _, t = _planned(sumfact, False)
    (st,) = t.steps
    assert (st.mode, st.tile, st.tile_letter) == ("general", (5,), "i")
    for e, hoist in ((demo, False), (gram, False), (sumfact, True),
                     (sumfact, False)):
        prog, table = _planned(e, hoist)
        plan = plan_cuda_launch(prog, get_index_lengths(e, 40))
        logical = generate_input_arrays(e, long_dim_length=40, seed=7,
                                        device="cpu")
        (got,) = plan.plain(plan.operands(apply_layouts(prog, logical)))
        want = torch.einsum(e.get_subscripts().replace(" ", ""),
                            *[logical[a.name].double() for a in e.args[0]])
        if prog.descriptor.out_layout is not None:
            want = want.permute(*prog.descriptor.out_layout)
        assert_close(got, want)


def test_sub_tile_fits_shared_memory():
    """The planner sizes the sub-tile so that the residents, the streamed
    inputs' two buffers and the steps' results fit a Hopper block, and
    stages every streamed input."""
    for name, (e, hoist) in sorted(CASES.items()):
        _, t = _planned(e, hoist)
        assert 1 <= t.te <= 256 and t.smem_bytes <= kernels.MAX_SMEM_BYTES
        assert all((x >= 0) == (t.el in letters)
                   for x, letters in zip(t.sin, t.inputs)), name

# }}}


# {{{ refusals

def _chain(n: int, residents: int = None):
    """A program of n steps ``ea,ab->eb``, ``eb,ba->ea``, ...: u's short
    letter against a resident matrix in turn, the residents ``R0``...
    (each step its own, or *residents* of them in turn)."""
    residents = n if residents is None else residents
    e = ft.einsum("ea," + ",".join(["ab"] * residents) + "->e"
                  + ("b" if residents % 2 else "a"),
                  _a("u", ("E", 3)),
                  *[_a(f"R{k}", (3, 3)) for k in range(residents)])
    subs, names, args = [], [], []
    prev = EinsumOperand(0)
    for k in range(n):
        a, b = ("a", "b") if k % 2 == 0 else ("b", "a")
        subs.append(f"e{a},{a}{b}->e{b}")
        names.append(f"_s{k}" if k < n - 1 else "_fe_out")
        args.append((prev, EinsumOperand(1 + k % residents)))
        prev = IntermediateResult(names[-1])
    return ft.generate_program(e, schedule=ContractionSchedule(
        tuple(subs), tuple(names), tuple(args))).with_descriptor(
            backend="pallas", hoist_resident_steps=False)


def test_planner_refuses_naming_the_limit():
    """The planner names the limit a program exceeds: steps, operands per
    row, operands per step, letters per step, shared memory, or a long
    axis contracted before the last step."""
    def lengths(prog):
        return get_index_lengths(prog.einsum, 8)

    ok = _chain(8, residents=2)
    plan_step_block(ok, lengths(ok))
    with pytest.raises(ft.InvalidParameterError, match="at most 8 steps"):
        plan_step_block(_chain(9, residents=2), lengths(ok))
    nine = _chain(8)
    with pytest.raises(ft.InvalidParameterError,
                       match="at most 8 operands per row"):
        plan_step_block(nine, lengths(nine))
    five = ft.generate_program(ft.einsum(
        "ea,ab,bc,cd,df->ef", _a("u", ("E", 3)),
        *[_a(f"R{k}", (3, 3)) for k in range(4)]))
    with pytest.raises(ft.InvalidParameterError,
                       match="at most 4 operands per step"):
        plan_step_block(five, lengths(five))
    wide = ft.generate_program(ft.einsum("eabcdfghij->ea",
                                         _a("u", ("E",) + (2,) * 9)))
    with pytest.raises(ft.InvalidParameterError, match="letters per step"):
        plan_step_block(wide, lengths(wide))
    big = ft.generate_program(ft.einsum(
        "ij,ejk->eik", _a("R", (300, 300)), _a("u", ("E", 300, 2))))
    with pytest.raises(ft.InvalidParameterError, match="shared memory"):
        plan_step_block(big, lengths(big))
    early = ft.einsum("ej,ek,jk->", _a("u", ("E", 3)), _a("v", ("E", 3)),
                      _a("R", (3, 3)))
    sched = ContractionSchedule(
        ("ej,ek->jk", "jk,jk->"), ("_t", "_fe_out"),
        ((EinsumOperand(0), EinsumOperand(1)),
         (IntermediateResult("_t"), EinsumOperand(2))))
    with pytest.raises(ft.InvalidParameterError, match="before the last"):
        plan_step_block(ft.generate_program(early, schedule=sched),
                        get_index_lengths(early, 8))


def test_free_steps_run_once_per_block():
    """Without hoisting, a resident-only step stays in the kernel as a
    "free" step, computed once per block: the curl's ``R = sum_r D`` with
    ``prereduce`` and ``host_hoist`` off, on a row no family takes."""
    e = ft.einsum("rij,ejk->eik", _a("D", (3, 5, 5)), _a("u", ("E", 5, 4)))
    sched = ContractionSchedule(
        ("rij->ij", "ij,ejk->eik"), ("_pre", "_fe_out"),
        ((EinsumOperand(0),), (IntermediateResult("_pre"),
                               EinsumOperand(1))))
    prog = ft.generate_program(e, schedule=sched).with_descriptor(
        backend="pallas", hoist_resident_steps=False, block_long=16)
    table = plan_step_block(prog, get_index_lengths(e, 40))
    assert [s.kind for s in table.steps] == ["free", "element"]
    ft.validate_batched_einsum_transform(e, lambda p: prog,
                                         long_dim_length=40)
    plan = plan_cuda_launch(prog, get_index_lengths(e, 40))
    logical = generate_input_arrays(e, long_dim_length=40, device="cpu")
    rows = plan.operands(apply_layouts(prog, logical))
    (emu,) = emulate(rows, table, 16)
    assert_close(emu, torch.einsum("rij,ejk->eik", logical["D"].double(),
                                   logical["u"].double()), rtol=1e-12)
    hoisted = prog.with_descriptor(hoist_resident_steps=True)
    kp, host = hoist_resident_steps(hoisted)
    assert len(host) == 1 and kp.schedule.nsteps == 1
    ft.validate_batched_einsum_transform(e, lambda p: hoisted,
                                         long_dim_length=40)


def element_then_reduce(n: int, m: int, block_long: int):
    """``ij,ejk,ek->i`` in two steps, ``ij,ejk->eik`` (a dense element
    step) then ``eik,ek->i`` (a reduce over e and k), at widths *n*,
    *m*."""
    e = ft.einsum("ij,ejk,ek->i", _a("A", (n, n)), _a("B", ("E", n, m)),
                  _a("w", ("E", m)))
    sched = ContractionSchedule(
        ("ij,ejk->eik", "eik,ek->i"), ("_t", "_fe_out"),
        ((EinsumOperand(0), EinsumOperand(1)),
         (IntermediateResult("_t"), EinsumOperand(2))))
    return e, ft.generate_program(e, schedule=sched).with_descriptor(
        backend="pallas", hoist_resident_steps=False, block_long=block_long)


def test_reduce_after_an_element_step_is_general():
    """A reduce that is not the only step on the elements runs through
    its offset tables (the kernel keeps a dense reduce's register tiles
    across a block's sub-tiles, which needs the elements to itself), over
    several blocks with a ragged tail; ``step_block_plain`` and the
    kernel's tables (:func:`emulate`) against the einsum in float64."""
    e, prog = element_then_reduce(6, 5, 16)
    length = 101
    table = plan_step_block(prog, get_index_lengths(e, length))
    assert [(s.kind, s.mode) for s in table.steps] == [
        ("element", "dense"), ("reduce", "general")]
    plan = plan_cuda_launch(prog, get_index_lengths(e, length))
    assert plan.kernel == "step_block_f32"
    logical = generate_input_arrays(e, long_dim_length=length, seed=9,
                                    device="cpu")
    rows = plan.operands(apply_layouts(prog, logical))
    want = torch.einsum("ij,ejk,ek->i", *[logical[n].double()
                                          for n in ("A", "B", "w")])
    (got,) = plan.plain(rows)
    assert_close(got, want)
    (emu,) = emulate(rows, table, 16)
    assert_close(emu, want, rtol=1e-12)


def test_guard_smem_refuses_step_block_points():
    """``guard_smem`` checks a program no row family takes as
    ``step_block_f32`` runs it, before anything is built: the tuner's
    ``fused_pallas_program`` refuses the point."""
    e = ft.einsum("ij,ejk->eik", _a("R", (300, 300)), _a("u", ("E", 300, 2)))
    prog = ft.generate_program(e).with_descriptor(backend="pallas")
    assert row_family(prog, get_index_lengths(e, 1)) is None
    with pytest.raises(ft.InvalidParameterError, match="shared memory"):
        _common.guard_smem(e, "step_block_f32", program=prog)
    with pytest.raises(ft.InvalidParameterError, match="shared memory"):
        _common.guard_smem(e, "dg_rows_f32", program=prog)
    with pytest.raises(ft.InvalidParameterError, match="shared memory"):
        _common.fused_pallas_program(ft.generate_program(e), block_long=256,
                                     hoist=False)
    ok = ft.einsum("ij,ejk->eik", _a("R", (35, 35)), _a("u", ("E", 35, 35)))
    _common.guard_smem(ok, "dg_rows_f32",
                       program=ft.generate_program(ok).with_descriptor(
                           backend="pallas"))


def test_families_keep_their_rows():
    """A row a family takes keeps its kernel, and the family's refusals
    stay refusals: a DG row over the shared memory of a block, and a
    restriction row whose stored layouts split its merged letters."""
    from feinsum_tpu_torch import suite as S
    for e, kernel in ((S.make_div(6), "dg_rows_f32"),
                      (S.make_mass(6), "dg_rows_f32"),
                      (S.make_energy(6), "long_reduce_f32"),
                      (S.make_copy(6), "ew_product_f32")):
        prog = S.default_transform(e)(ft.generate_program(e))
        assert plan_cuda_launch(prog, get_index_lengths(
            e, E)).kernel == kernel
    with pytest.raises(ft.InvalidParameterError, match="shared memory"):
        _common.guard_smem(S.make_grad(200), "dg_rows_f32",
                           program=ft.generate_program(
                               S.make_grad(200)).with_descriptor(
                               backend="pallas"))
    gram64 = ft.einsum("ei,ej->ij", _a("u", ("E", 64)), _a("v", ("E", 64)))
    assert plan_cuda_launch(ft.generate_program(gram64).with_descriptor(
        backend="pallas"), get_index_lengths(gram64, E)).kernel \
        == "long_reduce_f32"

# }}}


def test_float64_keeps_the_pair_storage_message():
    e = ft.einsum("ij,ejk->eik", ft.array("A", (4, 4), "float64"),
                  ft.array("B", ("E", 4, 4), "float64"))
    prog = ft.generate_program(e).with_descriptor(backend="pallas")
    with pytest.raises(ft.InvalidParameterError, match="dd_pairs"):
        ft.build_executable(prog, long_dim_length=E)


def test_bf16_3x_runs_f32_under_its_name():
    e, _ = CASES["demo_ndof6"]
    prog = port_program(e, False).with_descriptor(precision="bf16_3x")
    assert plan_cuda_launch(prog, get_index_lengths(
        e, E)).kernel == "step_block_f32"
    ft.validate_batched_einsum_transform(e, lambda p: prog,
                                         long_dim_length=E)

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
the host's side of the kernel is held to the plain version here, and
:func:`emulate_stream` and :func:`emulate_lanes` run the stream and lanes
paths' tables likewise against the einsum; ``test_torch_kernels.py``
holds the kernels themselves to their plain version on the card."""

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
from feinsum_tpu_torch.ops import kernels, step_block
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


# {{{ the stream path

def _node_table(subs, shapes, n):
    """The step table of *subs* over operands of *shapes* ("N" the long
    letter n, at length *n*) on its trivial schedule."""
    e = ft.einsum(subs, *[_a(name, s) for name, s in zip("GV", shapes)])
    program = ft.generate_program(e).with_descriptor(backend="pallas")
    return plan_step_block(program, get_index_lengths(e, n))


def _out_view(table, E_):
    """The output view the wrapper allocates: contiguous in the stored
    order, axes in the last step's order."""
    out = torch.empty(tuple(E_ if ix == table.el else table.length[ix]
                            for ix in table.stored_out))
    return out.permute(tuple(table.stored_out.index(ix)
                             for ix in table.steps[-1].out))


def _storage(shape, pad=0, offset=0, perm=None):
    """A float32 view of *shape*: its last axis padded by *pad* in the
    storage, its first element *offset* floats into it, or (*perm*) a
    permutation of a contiguous tensor of the permuted shape."""
    if perm is not None:
        inv = [perm.index(a) for a in range(len(shape))]
        return torch.rand([shape[a] for a in perm]).permute(*inv)
    full = (*shape[:-1], shape[-1] + pad)
    flat = torch.rand(int(np.prod(full)) + offset)[offset:]
    return flat.view(full)[..., :shape[-1]]


# (einsum, operand shapes with "N", n, storage arguments per operand,
# the path): the metric products take the stream path; a product the
# stream path cannot run takes the lanes path where its layout allows;
# each other case falls back
PATH_CASES = {
    "grad_metric": ("xrn,rn->xn", ((3, 3, "N"), (3, "N")), 64, ({}, {}),
                    "stream"),
    "div_metric": ("xrn,xn->rn", ((3, 3, "N"), (3, "N")), 64, ({}, {}),
                   "stream"),
    "ragged_elementwise": ("n,n->n", (("N",), ("N",)), 61, ({}, {}),
                           "stream"),
    "ragged_output": ("xrn,rn->xn", ((3, 3, "N"), (3, "N")), 61,
                      ({"pad": 3}, {"pad": 3}), "dense"),
    "two_by_two": ("xrn,rn->xn", ((2, 2, "N"), (2, "N")), 64, ({}, {}),
                   "stream"),
    "scale": ("xn,n->xn", ((3, "N"), ("N",)), 64, ({}, {}), "stream"),
    "resident": ("xr,rn->xn", ((3, 3), (3, "N")), 64, ({}, {}), "lanes"),
    "reduce": ("xrn,rn->xr", ((3, 3, "N"), (3, "N")), 64, ({}, {}), None),
    "long_letter_strided": ("xrn,rn->xn", ((3, 3, "N"), (3, "N")), 64,
                            ({"perm": (2, 0, 1)}, {}), "dense"),
    "unaligned_entry_stride": ("xrn,rn->xn", ((3, 3, "N"), (3, "N")), 61,
                               ({}, {}), "dense"),
    "unaligned_pointer": ("xrn,rn->xn", ((3, 3, "N"), (3, "N")), 64,
                          ({"offset": 1}, {}), "dense"),
    "over_budget": ("xrn,rn->xn", ((4, 3, "N"), (3, "N")), 64, ({}, {}),
                    "lanes"),
    "batch_letter": ("xn,xn->xn", ((3, "N"), (3, "N")), 64, ({}, {}),
                     "lanes"),
    # the lanes path: n % 4 != 0 alone (the streamed rows padded to 64
    # floats, the output without an entry stride), a streamed operand off
    # 16 bytes, one element-major
    "lanes_ragged_long_axis": ("x,xn->n", ((3,), (3, "N")), 61,
                               ({}, {"pad": 3}), "dense"),
    "lanes_unaligned_pointer": ("xr,rn->xn", ((3, 3), (3, "N")), 64,
                                ({}, {"offset": 1}), "dense"),
    "lanes_element_major": ("xr,rn->xn", ((3, 3), (3, "N")), 64,
                            ({}, {"perm": (1, 0)}), "dense"),
}


def _path_case(name):
    subs, shapes, n, storage, want = PATH_CASES[name]
    table = _node_table(subs, shapes, n)
    ins = [_storage(tuple(n if d == "N" else d for d in s), **kw)
           for s, kw in zip(shapes, storage)]
    return table, ins, n, want


@pytest.mark.parametrize("name", sorted(PATH_CASES))
def test_step_block_path_takes_the_stream_path_where_it_may(name):
    """``step_block_path`` on the launch's own tables, strides and
    pointers: an element-local product without residents on 16 bytes takes
    the stream path (a ragged n too, where no operand has an entry stride);
    a product with a resident, more entries than the stream instances hold
    or a batch letter takes the lanes path on 16 bytes; a reduce step, the
    long letter off stride 1, an unaligned entry stride (of the contiguous
    output alone, beside inputs on padded storage, too) or pointer, or (the
    lanes path) a long axis that is not a multiple of 4 keep the table's
    mode (a reduce's ``None`` here)."""
    table, ins, n, want = _path_case(name)
    view = _out_view(table, n)
    got = kernels.step_block_path(table, tuple(tuple(t.stride()) for t in ins),
                                  tuple(view.stride()), (*ins, view))
    assert got == (table.mode if want is None else want)


def emulate_stream(row, table) -> torch.Tensor:
    """``step_block_stream`` (``csrc/step_block.cu``) in float64 on the
    CPU: the stream path's tables as the wrapper hands them over, W the
    operand that carries the result's letters, each result entry summed
    over the contracted entries in order, every element."""
    el = table.el
    (slot, letters), *_ = [(s, x) for s, x in enumerate(table.inputs)]
    E_ = row[slot].shape[letters.index(el)]
    view = _out_view(table, E_).double()
    tabs, steps_i, steps_t, _si, _st = kernels.step_block_tables(
        table, tuple(tuple(t.stride()) for t in row), tuple(view.stride()),
        False, True)
    (si,), (tt,) = steps_i, steps_t
    src, affine, (nM, nN, nK) = si[4:6], si[11], si[17:20]
    d = tt[9:18]

    def at(q, i):
        return int(tabs[d[q] + i])

    def kth(q, k):
        return k * d[q] if affine else int(tabs[d[q] + k])
    flat = []
    for t in row:
        span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
        f = torch.zeros(span, dtype=torch.float64)
        torch.as_strided(f, t.shape, t.stride()).copy_(t.double())
        flat.append(f.numpy())
    out = torch.zeros(view.numel(), dtype=torch.float64)
    wa = nN == 1
    W, X = flat[src[0 if wa else 1]], flat[src[1 if wa else 0]]
    e = np.arange(E_)
    for m in range(nM if wa else nN):
        acc = np.zeros(E_)
        for k in range(nK):
            ow = (at(0, m) + kth(1, k) + at(2, 0) if wa
                  else at(3, m) + kth(4, k) + at(5, 0))
            ox = (at(3, 0) + kth(4, k) + at(5, 0) if wa
                  else at(0, 0) + kth(1, k) + at(2, 0))
            acc = acc + W[ow + e] * X[ox + e]
        oo = (at(6, m) + at(7, 0) if wa else at(6, 0) + at(7, m)) + at(8, 0)
        out.numpy()[oo + e] = acc
    return torch.as_strided(out, view.shape, view.stride())


@pytest.mark.parametrize("name", ["grad_metric", "div_metric",
                                  "ragged_elementwise", "two_by_two",
                                  "scale",
                                  "hex_grad_metric", "hex_div_metric"])
def test_stream_tables_match_the_einsum(name):
    """The stream path's tables (:func:`emulate_stream`) against the
    einsum in float64: W first (the trivial schedule) and W second (the
    hexahedral model's own programs, whose schedule takes the vector
    first), G's offsets at the model's n^3 E nodes."""
    if name.startswith("hex_"):
        n = 125 * 4
        program = hoist_resident_steps(ft.HexWaveOperator3D(
            device="cpu").programs[name[4:]])[0]
        table = plan_step_block(program, get_index_lengths(program.einsum,
                                                           n))
        subs = program.einsum.get_subscripts().replace(" ", "")
        ins = [torch.rand(3, 3, n), torch.rand(3, n)]
    else:
        table, ins, n, _ = _path_case(name)
        subs = PATH_CASES[name][0]
    view = _out_view(table, n)
    assert kernels.step_block_path(
        table, tuple(tuple(t.stride()) for t in ins), tuple(view.stride()),
        (*ins, view)) == "stream"
    want = torch.einsum(subs, *[t.double() for t in ins])
    assert_close(emulate_stream(ins, table), want, rtol=1e-12)

# }}}


# {{{ the lanes path

# the models' tables and the path each takes at the cells' sizes, on
# contiguous operands on 16 bytes
VISCO_EXECS = tuple(f"{kind}_{d}" for kind, n in (
    ("derivative", 4), ("source", 5), ("relax", 4)) for d in range(n)) + (
    "volume", "flux")
MODEL_PATHS = {
    **{f"ader_{name}": "lanes" for name in (
        "derivative_0", "derivative_1", "derivative_2", "derivative_3",
        "volume", "flux")},
    "hex_grad_axes": "lanes", "hex_div_1": "lanes", "hex_div_2": "lanes",
    "hex_div_3": "lanes", "hex_grad_metric": "stream",
    "hex_div_metric": "stream",
    **{f"visco_{name}": "lanes" for name in VISCO_EXECS},
}


def _model_op(name):
    """The model of a ``<model>_<executable>`` case name, the executable's
    name, and its cell's long length (the metric products over 125 E
    nodes)."""
    model, exe = name.split("_", 1)
    op, n = {"ader": (ft.AderElasticOperator3D, 4_000_000),
             "hex": (ft.HexWaveOperator3D, 2_000_000),
             "visco": (ft.AderViscoelasticOperator3D, 1_000_000)}[model]
    return op(device="cpu"), exe, 125 * n if "metric" in exe else n


@pytest.mark.parametrize("name", sorted(MODEL_PATHS))
def test_model_tables_take_their_paths(name):
    """``step_block_path`` on each model's own tables at its cell's size
    (E = 4M for ADER, 2M for the hexahedral model, the metric products
    over its 125 E nodes, 1M for viscoelastic ADER), on contiguous tensors
    without storage (the meta device): every ADER table, the viscoelastic
    flux's among them, and the four hexahedral tables off the stream path
    take the lanes path, the two metric products stay on the stream
    path."""
    op, exe, n = _model_op(name)
    program, table = _model_table(op, exe, n)
    ins = [torch.empty(tuple(n if ix == table.el else table.length[ix]
                             for ix in letters), device="meta")
           for letters in table.inputs]
    view = torch.empty(tuple(n if ix == table.el else table.length[ix]
                             for ix in table.stored_out),
                       device="meta").permute(tuple(
                           table.stored_out.index(ix)
                           for ix in table.steps[-1].out))
    assert kernels.step_block_path(
        table, tuple(tuple(t.stride()) for t in ins), tuple(view.stride()),
        (*ins, view)) == MODEL_PATHS[name]


@pytest.mark.parametrize("name", ["sumfact_q4_one_step",
                                  "resident_reduce_ndof7", "gram_ndof70x66",
                                  "two_letter_reduce"])
def test_lanes_path_refuses_general_and_reduce_tables(name):
    """A table with a general step (sum factorization in one step) or a
    step that contracts the long axis has no lanes plan, and keeps its
    mode whatever its layout."""
    e, hoist = CASES[name]
    kp = hoist_resident_steps(port_program(e, hoist, dofmajor=True))[0]
    table = plan_step_block(kp, get_index_lengths(kp.einsum, 64))
    assert kernels._sb_lanes_plan(table) is None
    ins = _model_inputs(None, table, 64)
    out = torch.empty(tuple(64 if ix == table.el else table.length[ix]
                            for ix in table.stored_out))
    view = out.permute(tuple(table.stored_out.index(ix)
                             for ix in table.steps[-1].out))
    assert kernels.step_block_path(
        table, tuple(tuple(t.stride()) for t in ins), tuple(view.stride()),
        (*ins, view)) == table.mode

def _flat(t) -> np.ndarray:
    """The float64 storage span of view *t*, its entries where it puts
    them."""
    span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    f = torch.zeros(span, dtype=torch.float64)
    torch.as_strided(f, t.shape, t.stride()).copy_(t.double())
    return f.numpy()


def emulate_lanes(row, table, block_long: int, plan=None) -> torch.Tensor:
    """``step_block_lanes`` (``csrc/step_block.cu``) in float64 on the CPU:
    the lanes path's meta and tables as the wrapper hands them over, read
    the way the kernel reads them: blocks of whole sub-tiles, the
    residents packed once a block, each streamed region's sub-tile staged
    when the kernel copies it (two buffers: at the top of the sub-tile
    before; one: after its refill step), zeros past the last element, and
    each step's entries over the 32-lane columns of shared memory, which
    starts as NaN so that a read of a row nothing wrote shows; by *plan*
    (default :func:`kernels._sb_lanes_plan`'s).  A chained pair runs at
    its first step (:func:`_emulate_chain`), its refills at both."""
    el = table.el
    slot = next(s for s, x in enumerate(table.inputs) if el in x)
    E_ = row[slot].shape[table.inputs[slot].index(el)]
    view = _out_view(table, E_).double()
    plan = plan or kernels._sb_lanes_plan(table)
    meta, tabs, maps = kernels.step_block_lanes_tables(
        table, tuple(tuple(t.stride()) for t in row), tuple(view.stride()),
        plan)
    ns, nr, te, double, n_ints, ints_src, _threads = meta[:7]
    steps = [meta[7 + 20 * k:7 + 20 * (k + 1)] for k in range(ns)]
    base = 7 + 20 * ns
    regs = [meta[base + 6 * r:base + 6 * (r + 1)] for r in range(nr)]
    ints = tabs[ints_src:ints_src + n_ints]
    flat = [_flat(t) for t in row]
    out = np.zeros(view.numel())
    smem_n = plan.smem_floats
    lanes = np.arange(te)

    def stage(r, e0, n, parity):
        off, second, rows, sl, m, _refill = regs[r]
        at = second if parity else off
        d = maps[9 * m:9 * (m + 1)]
        lens, strides = d[1:2 * d[0] - 1:2], d[2:2 * d[0]:2]
        for x in range(rows):
            src, rest = e0, x
            for ln, st in zip(lens, strides):   # the fastest letter first
                src += (rest % ln) * st
                rest //= ln
            vals = np.zeros(te)
            vals[:n] = flat[sl][src:src + n]
            smem[at + x * te:at + (x + 1) * te] = vals

    def base_of(r, parity):
        off, second, *_ = regs[r]
        return second if parity and second >= 0 else off

    block = -(-block_long // te) * te
    for b0 in range(0, E_, block):
        smem = np.full(smem_n, np.nan)
        for st in steps:
            if st[2]:
                poff, pn, psrc = st[16:19]
                g = tabs[psrc:psrc + pn]
                smem[poff:poff + pn] = np.where(
                    g >= 0, flat[st[1]][np.maximum(g, 0)], 0.0)
        e_end = min(E_, b0 + block)
        streamed = [r for r in range(nr) if regs[r][3] >= 0]
        for r in streamed:
            stage(r, b0, min(te, e_end - b0), 0)
        parity = 0
        for e0 in range(b0, e_end, te):
            n, nxt = min(te, e_end - e0), e0 + te
            if double and nxt < e_end:
                for r in streamed:
                    stage(r, nxt, min(te, e_end - nxt), parity ^ 1)
            for k, st in enumerate(steps):
                if st[19] == 1:
                    _emulate_chain(smem, st, steps[k + 1], ints, tabs, out,
                                   base_of, regs, e0, n, parity, lanes)
                elif st[19] == 0:
                    _emulate_step(smem, st, ints, tabs, out, base_of, regs,
                                  e0, n, parity, lanes)
                if not double and nxt < e_end:
                    for r in streamed:
                        if regs[r][5] == k:
                            stage(r, nxt, min(te, e_end - nxt), 0)
            if double:
                parity ^= 1
    return torch.as_strided(torch.from_numpy(out), view.shape, view.stride())


def _emulate_step(smem, st, ints, tabs, out, base_of, regs, e0, n,
                  parity, lanes) -> None:
    """One step of :func:`emulate_lanes`, not chained: each entry of its
    result over the sub-tile's columns, to its region or the output."""
    te = len(lanes)
    (xreg, wreg, wres, nx, nw, nb, nk, _rx, _rw, _tx, _tw, xk,
     wk, tab, dst, dg, poff, _pn, _ps, _chain) = st
    Xx = ints[tab:tab + nx]
    Xb = ints[tab + nx:tab + nx + nb]
    c = tab + nx + nb
    Ww = ints[c:c + (0 if wres else nw)]
    c += 0 if wres else nw
    Wb = ints[c:c + nb]
    Dx = ints[c + nb:c + nb + nx]
    Dw = ints[c + nb + nx:c + nb + nx + nw]
    Db = ints[c + nb + nx + nw:c + 2 * nb + nx + nw]
    xb = base_of(xreg, parity)
    for b in range(nb):
        for x in range(nx):
            for w in range(nw):
                acc = np.zeros(te)
                for kk in range(nk):
                    xr = xb + (Xx[x] + Xb[b] + kk * xk) * te
                    a = smem[xr + lanes]
                    if wres:
                        v = smem[poff + Wb[b] + kk * wk + w]
                    else:
                        wr = base_of(wreg, parity) + (
                            Ww[w] + Wb[b] + kk * wk) * te
                        v = smem[wr + lanes]
                    acc = acc + a * v
                if dst >= 0:
                    d = regs[dst][0] + (Dx[x] + Dw[w] + Db[b]) * te
                    smem[d + lanes] = acc
                else:
                    o = (tabs[dg + x] + tabs[dg + nx + w]
                         + tabs[dg + nx + nw + b] + e0)
                    out[o + lanes[:n]] = acc[:n]


def _emulate_chain(smem, a, c, ints, tabs, out, base_of, regs, e0, n,
                   parity, lanes) -> None:
    """A chained pair of :func:`emulate_lanes` as ``lane_chain`` runs it:
    per unit (a batch entry of the second step *c*, RM of its free entries
    on the first result's side) the first step *a*'s result over the
    unit's packed tile for each of *a*'s X rows (where the tile carries
    *a*'s batch, each tile entry's X rows at its own batch entry), each
    of its entries then one of *c*'s contracted entries against *c*'s
    per-element rows; only *c*'s result written."""
    rq, rw = a[7], a[8]
    nn, rm = c[7], c[8]
    nkw = c[6] // a[3]
    ax = ints[a[13]:a[13] + a[3]]
    # X's rows of each tile column: its tile entry's batch entry
    xb = (ints[a[13] + a[3]:a[13] + a[3] + a[5]][
        np.minimum(np.arange(rw) // rm, nkw - 1)] if a[5] > 1
        else np.zeros(rw, np.int64))
    yb = ints[c[13] + c[3]:c[13] + c[3] + c[5]]
    d0 = c[13] + c[3] + 2 * c[5] + c[4]
    Dx, Dw, Db = (ints[d0:d0 + c[3]], ints[d0 + c[3]:d0 + c[3] + c[4]],
                  ints[d0 + c[3] + c[4]:d0 + c[3] + c[4] + c[5]])
    X, Y = base_of(a[0], parity), base_of(c[0], parity)
    for b in range(c[5]):
        for mt in range(c[10]):
            wp = a[16] + (b * c[10] + mt) * rw
            o = np.zeros((nn, rm, len(lanes)))
            for q in range(a[3]):
                acc = np.zeros((rw, len(lanes)))
                for kk in range(a[6]):
                    xr = smem[X + (ax[q] + xb[:, None] + kk * a[11])
                              * len(lanes) + lanes[None, :]]
                    acc += xr * smem[wp + kk * a[12]
                                     + np.arange(rw)][:, None]
                for kw in range(nkw):
                    yr = yb[b] + (q * nkw + kw) * c[11]
                    for i in range(nn):
                        y = smem[Y + (yr + i) * len(lanes) + lanes]
                        o[i] += acc[kw * rm:(kw + 1) * rm] * y[None, :]
            for j in range(rm):
                w = mt * rm + j
                if w >= c[4]:
                    continue
                for i in range(nn):
                    if c[14] >= 0:
                        d = regs[c[14]][0] + (Dx[i] + Dw[w] + Db[b]) * len(
                            lanes)
                        smem[d + lanes] = o[i, j]
                    else:
                        at = (tabs[c[15] + i] + tabs[c[15] + c[3] + w]
                              + tabs[c[15] + c[3] + c[4] + b] + e0)
                        out[at + lanes[:n]] = o[i, j, :n]


def _model_table(op, name, n):
    program = hoist_resident_steps(op.programs[name])[0]
    return program, plan_step_block(program, get_index_lengths(
        program.einsum, n))


def _model_inputs(program, table, n, storage=None):
    """Random operands of *program* at long length *n* in its stored
    layouts, one per table slot (``storage(slot, shape)`` may lay one out
    otherwise)."""
    el = table.el
    ins = []
    for slot, letters in enumerate(table.inputs):
        shape = tuple(n if ix == el else table.length[ix] for ix in letters)
        ins.append(torch.rand(shape) if storage is None
                   else storage(slot, shape))
    return ins


ADER_EXECS = ("derivative_0", "derivative_1", "derivative_2",
              "derivative_3", "volume", "flux")


@pytest.mark.parametrize("name", ADER_EXECS + (
    "hex_grad_axes", "hex_div_1", "hex_div_2", "hex_div_3", "visco_flux"))
def test_lanes_tables_match_the_einsum(name):
    """The lanes path's tables (:func:`emulate_lanes`) against the einsum
    in float64 on the models' own programs, at a length that leaves a
    block's last sub-tile part full (blocks of 64 elements, a multiple of
    4 elements that no sub-tile divides); the viscoelastic flux chains a
    pair whose tile carries the first step's batch."""
    op, exe, _n = _model_op(name if name.startswith(("hex_", "visco_"))
                            else f"ader_{name}")
    n = 140
    program, table = _model_table(op, exe, n)
    ins = _model_inputs(program, table, n)
    view = _out_view(table, n)
    assert kernels.step_block_path(
        table, tuple(tuple(t.stride()) for t in ins), tuple(view.stride()),
        (*ins, view)) == "lanes"
    subs = ",".join("".join(x) for x in table.inputs) + "->" + "".join(
        table.steps[-1].out)
    want = torch.einsum(subs, *[t.double() for t in ins])
    assert_close(emulate_lanes(ins, table, 64), want, rtol=1e-12)


# the pairs each model table may chain (lane_chain_groups: the second
# step's contracted letters on W's side, its batch and its free letters on
# the first result's side, in the first step's letters) and the pairs its
# plan chains
MODEL_CHAINS = {
    **{f"ader_derivative_{d}": ({0: (("x",), (), ("k",))}, (0,))
       for d in range(4)},
    "ader_volume": ({}, ()),
    "ader_flux": ({0: ((), ("f",), ("m",))}, (0,)),
    **{f"hex_{name}": ({}, ()) for name in ("grad_axes", "div_1", "div_2",
                                            "div_3")},
    **{f"visco_derivative_{d}": ({0: (("x",), (), ("k",))}, ())
       for d in range(4)},
    "visco_volume": ({0: (("x",), (), ("k",))}, ()),
    "visco_flux": ({1: (("f",), (), ("k",))}, (1,)),
}


@pytest.mark.parametrize("name", sorted(MODEL_CHAINS))
def test_model_tables_chain_their_pairs(name):
    """Which pairs of each model table may chain, and which its plan
    chains: every elastic derivative's and the elastic flux's first two
    steps (a reference matrix times the element's entries, then a
    per-element product over the first result's entries), not the elastic
    volume term (its per-element product comes first) and no hexahedral
    table (every step a resident times the element's entries); the
    viscoelastic derivatives and volume term may chain but have no
    instance of their widths (NN = 15, NKW = 3), and the viscoelastic
    flux chains its last two steps, the first's batch letter (the face)
    contracted by the second."""
    op, exe, n = _model_op(name)
    _program, table = _model_table(op, exe, n)
    groups, chained = MODEL_CHAINS[name]
    assert {k: step_block.lane_chain_groups(table, k)
            for k in range(len(table.steps))
            if step_block.lane_chain_groups(table, k)} == groups
    plan = kernels._sb_lanes_plan(table)
    assert plan.chains == chained
    assert [ls.chain for ls in plan.steps] == [
        1 if k in chained else 2 if k - 1 in chained else 0
        for k in range(len(table.steps))]
    flat = step_block.plan_lanes(table, _chain=False)
    if name == "visco_flux":
        # unchained, its regions exceed a block's shared memory
        assert flat is None
    else:
        assert flat.chains == ()


# the plans of the tables that chain nothing, as before chains: (te, two
# buffers, threads, shared memory in bytes, each step's (X operand,
# resident W, tile))
UNCHAINED_PLANS = {
    "ader_volume": (32, False, 512, 132608,
                    ((1, False, (4, 9)), (0, True, (2, 12)))),
    "hex_grad_axes": (32, False, 256, 98176,
                      ((0, True, (2, 16)), (0, True, (5, 8)),
                       (0, True, (5, 8)))),
    **{f"hex_div_{d}": (128, False, 256, 64512, ((0, True, (5, 4)),))
       for d in (1, 2, 3)},
}


@pytest.mark.parametrize("name", sorted(UNCHAINED_PLANS))
def test_tables_without_chains_plan_as_before(name):
    """The volume term and the four hexahedral lanes tables plan as they
    did before chained pairs: the same sub-tile, buffers, threads, shared
    memory and steps' roles and tiles, with or without chains weighed."""
    op, exe, n = _model_op(name)
    _program, table = _model_table(op, exe, n)
    for plan in (kernels._sb_lanes_plan(table),
                 step_block.plan_lanes(table, _chain=False)):
        assert (plan.te, plan.double, plan.threads, 4 * plan.smem_floats,
                tuple((ls.x, ls.wres, ls.tile) for ls in plan.steps)) \
            == UNCHAINED_PLANS[name]


def _chain_cases() -> list:
    """``(table name, chained tiles)`` of each chained tile of
    ``SB_LANE_CHAINS`` and ``SB_LANE_CHAINS_BATCH`` that an ADER table's
    chained pair takes (the viscoelastic flux's the latter)."""
    cases = []
    for name in ADER_EXECS + ("visco_flux",):
        op, exe, _n = _model_op(name if name.startswith("visco_")
                                else f"ader_{name}")
        _program, table = _model_table(op, exe, 140)
        tiles = {tuple(ls.tile for ls in plan.steps if ls.chain)
                 for _key, plan in step_block.lanes_candidates(table)}
        cases += [(name, t) for t in sorted(tiles) if t]
    return cases


@pytest.mark.parametrize("name,tiles", _chain_cases())
def test_lanes_chains_match_the_einsum(name, tiles):
    """Each chained tile an ADER table may take, on the lanes tables of the
    modelled best plan with that tile (:func:`emulate_lanes`), against the
    einsum in float64, at 140 elements: a multiple of 4 that no sub-tile
    divides, so that a block's last sub-tile is part full."""
    op, exe, _n = _model_op(name if name.startswith("visco_")
                            else f"ader_{name}")
    n = 140
    program, table = _model_table(op, exe, n)
    _key, plan = min((c for c in step_block.lanes_candidates(table)
                      if tuple(ls.tile for ls in c[1].steps if ls.chain)
                      == tiles), key=lambda c: c[0])
    ins = _model_inputs(program, table, n)
    subs = ",".join("".join(x) for x in table.inputs) + "->" + "".join(
        table.steps[-1].out)
    want = torch.einsum(subs, *[t.double() for t in ins])
    assert_close(emulate_lanes(ins, table, 64, plan), want, rtol=1e-12)

# }}}

"""K2's multi-step dense schedules on the port: ``tc_steps_f32``
(``feinsum_tpu_torch/ops/tc_steps.py``, ``ops/kernels.py``) against the JAX
package's K2 (``_build_multigrid``) on the three-operand contractions its
``tc_pallas_v0`` and ``tc_pallas_v1`` bind: sum factorization on Q4
hexahedra ``ai,bj,ck,eabc->eijk`` (E = 16), the chain ``abc,cd,de->abe``,
the batched triple product ``eij,ejk,ekl->eil`` (ndof 8) and two operators
on one mode ``abcd,de,ef->abcf`` at (4, 6, 8, 16).

Both packages bind the same space points on the same einsums and get the
same seeded numpy inputs; the JAX package's K2 runs in Pallas interpret
mode.  On CPU tensors the port's wrapper runs ``tc_steps_plain``;
:func:`emulate` runs the offset tables the kernel receives
(``tc_steps_tables``) cell by cell as ``csrc/tc_steps.cu`` reads them, so
that the host's side of the kernel is held to the einsum here;
``test_torch_kernels.py`` holds the kernel itself to its plain version on
the card.  The tolerance is the float32 oracle's, 2e-5 of max|ref|; at
``bf16_3x`` each package is held to the float64 oracle within 2e-5 and the
two to each other within 4e-5, as in ``test_torch_bf16_3x.py``."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import feinsum_tpu as fr
import feinsum_tpu_torch as ft
from feinsum_tpu.contraction_schedule import (
    ContractionSchedule as RefSchedule,
    EinsumOperand as RefOperand,
    IntermediateResult as RefResult,
)
from feinsum_tpu.measure import (
    apply_layouts as ref_apply_layouts,
    generate_input_arrays as ref_generate_input_arrays,
)
from feinsum_tpu.ops.layouts import unpack_output as ref_unpack_output
from feinsum_tpu.tuning import get_transform_func_from_module_path as ref_space
from feinsum_tpu_torch import suite as S
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
from feinsum_tpu_torch.ops.tc_emitter import plan_tc_launch
from feinsum_tpu_torch.ops.tc_steps import plan_tc_steps, tc_steps_tables
from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

RTOL = 2e-5
PAIR_RTOL = 4e-5
SEED = 7

# the three einsums of the slice, and the small chain, at narrow widths
EINSUMS = {
    "sumfact_q4": ("ai,bj,ck,eabc->eijk",
                   ((5, 5), (5, 5), (5, 5), (16, 5, 5, 5))),
    "chain": ("abc,cd,de->abe", ((3, 4, 5), (5, 6), (6, 7))),
    "triple_ndof8": ("eij,ejk,ekl->eil", ((16, 8, 8),) * 3),
    "two_operators": ("abcd,de,ef->abcf", ((4, 6, 8, 16), (16, 6), (6, 16))),
}
SPACES = ("tc_pallas_v0", "tc_pallas_v1")


def make_pair(key):
    subs, shapes = EINSUMS[key]
    names = [chr(ord("A") + i) for i in range(len(shapes))]
    ours = ft.einsum(subs, *[ft.array(n, s, "float32")
                             for n, s in zip(names, shapes)])
    ref = fr.einsum(subs, *[fr.array(n, s, "float32")
                            for n, s in zip(names, shapes)])
    return ours, ref


def assert_close(got, ref, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def ref_points(space: str, r) -> list:
    """Every point of the reference's *space* on *r* that binds, with its
    program: the whole grid of the space's parameters."""
    sp = ref_space(space)
    ps = sp.get_param_space(r)
    names = sorted(ps)
    values = [list(range(ps[n].low, ps[n].high + 1)) if hasattr(ps[n], "low")
              else [False, True] for n in names]
    out = []
    for combo in itertools.product(*values):
        params = dict(zip(names, combo))
        try:
            out.append((params, sp.bind_args(r, **params)(
                fr.generate_program(r))))
        except fr.InvalidParameterError:
            continue
    return out


def oracle(e, logical, row=0):
    subs = e.get_subscripts().replace(" ", "")
    return np.einsum(subs, *[logical[a.name].double().numpy()
                             for a in e.args[row]])


def run_reference(ref_prog, seed=SEED):
    """``(logical inputs, stored inputs, outputs)`` of the reference's
    program on its seeded numpy inputs, the outputs unpacked."""
    r = ref_prog.einsum
    logical = ref_generate_input_arrays(r, long_dim_length=1, seed=seed,
                                        as_numpy=True)
    stored = ref_apply_layouts(ref_prog, logical)
    outs = fr.build_executable(ref_prog, long_dim_length=1)(stored)
    return logical, stored, [np.asarray(ref_unpack_output(
        ref_prog, np.asarray(o), tuple(int(d) for d in r.shape)))
        for o in outs]


def run_port(prog, stored):
    e = prog.einsum
    fn = ft.build_executable(prog, long_dim_length=1, device="cpu")
    return [ft.unpack_output(prog, o, tuple(int(d) for d in e.shape)).numpy()
            for o in fn(arrays_from_numpy(stored, "cpu"))]


def emulate(ops, table):
    """``tc_steps_f32`` as ``csrc/tc_steps.cu`` computes it, in float64 on
    the CPU: the tables, step descriptions and grid strides the wrapper
    hands the kernel, every cell's bases from its grid indices (the last
    grid letter fastest), each step's entries as products over the offset
    tables summed over the contracted entries, intermediates in a
    shared-memory array; checks that each output element is written once
    per cell sweep."""
    length = table.length
    out = torch.zeros(tuple(length[ix] for ix in table.stored_out),
                      dtype=torch.float64)
    view = out.permute(tuple(table.stored_out.index(ix)
                             for ix in table.out))
    tabs, steps_i, steps_t, grid = tc_steps_tables(
        table, tuple(tuple(t.stride()) for t in ops), tuple(view.stride()))
    assert tabs.dtype == np.int32
    flat = []
    for t in ops:
        span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
        f = torch.zeros(span, dtype=torch.float64)
        torch.as_strided(f, t.shape, t.stride()).copy_(t.double())
        flat.append(f.numpy())
    out_flat = out.view(-1).numpy()
    written = np.zeros(out_flat.shape, dtype=int)
    nops_max = kernels.TS_MAX_OPS
    ncells = int(np.prod([g[0] for g in grid]))
    assert ncells == table.ncells
    for cell in range(ncells):
        base = np.zeros(len(ops) + 1, dtype=np.int64)
        c = cell
        for g in reversed(grid):
            idx = c % g[0]
            c //= g[0]
            base += idx * np.asarray(g[1:], dtype=np.int64)
        smem = np.full(max(1, table.smem_floats), np.nan)
        for si, st in zip(steps_i, steps_t):
            nops, n_out, n_sum, affine = si[:4]
            src, dst = si[4:4 + nops], si[4 + nops_max]
            t_out, t_sum = st[:nops_max + 1], st[nops_max + 1:]
            prod = np.ones((n_out, n_sum))
            for q in range(nops):
                o_tab = tabs[t_out[q]:t_out[q] + n_out].astype(np.int64)
                c_tab = (np.arange(n_sum, dtype=np.int64) * t_sum[q]
                         if affine else
                         tabs[t_sum[q]:t_sum[q] + n_sum].astype(np.int64))
                if src[q] >= 0:
                    mem, b0 = flat[src[q]], base[src[q]]
                else:
                    mem, b0 = smem, steps_i[-1 - src[q]][4 + nops_max]
                prod = prod * mem[b0 + o_tab[:, None] + c_tab[None, :]]
            val = prod.sum(1)
            d_tab = tabs[t_out[nops]:t_out[nops] + n_out].astype(np.int64)
            if dst >= 0:
                smem[dst + d_tab] = val
            else:
                out_flat[base[-1] + d_tab] = val
                np.add.at(written, base[-1] + d_tab, 1)
    assert (written == 1).all()
    return out


# {{{ every reference point binds, plans and computes the einsum

@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("key", sorted(EINSUMS))
def test_reference_points_bind_in_the_port(key, space):
    """Each point the reference's space binds on the einsum binds in the
    port with the same parameters, plans onto ``tc_steps_f32`` (before this
    kernel each raised) with the reference's schedule, grid and blocks, and
    its output, for each distinct schedule and storage, is the einsum's."""
    e, r = make_pair(key)
    port = get_transform_func_from_module_path(space)
    lengths = get_index_lengths(e, 1)
    logical = generate_input_arrays(e, long_dim_length=1, seed=SEED,
                                    device="cpu")
    want = oracle(e, logical)
    points = ref_points(space, r)
    assert points
    checked = set()
    for params, ref_prog in points:
        prog = port.bind_args(e, **params)(ft.generate_program(e))
        carried = program_from_reference(ref_prog)
        assert prog.schedule == carried.schedule
        for name in ("grid_index", "grid_blocks", "grid_m", "arg_layouts"):
            assert getattr(prog.descriptor, name) == \
                getattr(carried.descriptor, name), (name, params)
        plan = plan_tc_launch(prog, lengths)
        assert plan.kernel == "tc_steps_f32", params
        key_ = (prog.schedule, prog.descriptor.arg_layouts,
                prog.descriptor.out_layout)
        if key_ in checked:
            continue
        checked.add(key_)
        (got,) = plan.run(plan.operands(apply_layouts(prog, logical)))
        assert_close(ft.unpack_output(prog, got, want.shape).numpy(), want)


def _sample(key, space, n, seed):
    """*n* distinct reference programs of *space* on *key*, drawn with a
    seed from the points that bind.  Sum factorization's one-step schedule
    of four operands is left out: the reference's interpret mode takes over
    a minute on it (the port's side of it is held to the einsum by
    ``test_reference_points_bind_in_the_port`` and, through the kernel's
    tables, by ``test_plain_and_tables_match_the_einsum``)."""
    _, r = make_pair(key)
    distinct = {}
    for params, prog in ref_points(space, r):
        if prog.schedule.nsteps == 1 and len(prog.schedule.arguments[0]) > 3:
            continue
        distinct.setdefault(prog, params)
    items = sorted(distinct.items(), key=lambda kv: repr(sorted(
        kv[1].items())))
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(items), size=min(n, len(items)), replace=False)
    return [items[int(i)][1] for i in sorted(picks)]


OUTPUT_CASES = [(key, space, params)
                for key in sorted(EINSUMS) for space in SPACES
                for params in _sample(key, space, 3, seed=len(key))]


@pytest.mark.parametrize("key,space,params", OUTPUT_CASES,
                         ids=[f"{k}-{s}-{i % 3}" for i, (k, s, _)
                              in enumerate(OUTPUT_CASES)])
def test_outputs_match_reference_k2(key, space, params):
    """A seeded sample of the bound points: the reference's K2 in
    interpret mode and the port (its plain version, and the kernel's tables
    through :func:`emulate`) on the same inputs."""
    e, r = make_pair(key)
    ref_prog = ref_space(space).bind_args(r, **params)(fr.generate_program(r))
    prog = get_transform_func_from_module_path(space).bind_args(
        e, **params)(ft.generate_program(e))
    logical, stored, (want,) = run_reference(ref_prog)
    kernels.reset_launch_counts()
    (got,) = run_port(prog, stored)
    assert not any(kernels.launch_counts.values())
    plan = plan_tc_launch(prog, get_index_lengths(e, 1))
    ops = plan.operands(arrays_from_numpy(stored, "cpu"))[0]
    table = plan_tc_steps(prog, get_index_lengths(e, 1))
    emu = ft.unpack_output(prog, emulate(ops, table), want.shape).numpy()
    exact = oracle(e, {k: torch.from_numpy(np.asarray(v))
                       for k, v in logical.items()})
    assert_close(emu, exact, rtol=1e-12)
    if prog.descriptor.precision == "bf16_3x":
        assert plan.kernel == "tc_steps_f32"
        assert_close(got, exact)
        assert_close(want, exact)
        assert float(np.max(np.abs(got - want))) \
            <= PAIR_RTOL * float(np.max(np.abs(exact)))
    else:
        assert_close(got, want)


def test_reference_program_carries_across():
    """The reference's own ``tc_pallas_v1`` program on two operators at
    one mode (blocks on a and b, the optimal path), carried across field by
    field, plans onto ``tc_steps_f32`` and gives the reference's output."""
    e, r = make_pair("two_operators")
    ref_prog = ref_space("tc_pallas_v1").bind_args(
        r, n_grid=2, blk0_idx=1, blk1_idx=1, m_pos=2, mstack=True,
        precision_idx=0, use_opt_path=True)(fr.generate_program(r))
    assert ref_prog.descriptor.grid_blocks == (("a", 2), ("b", 2))
    assert ref_prog.schedule.subscripts == ("de,abcd->eabc",
                                            "eabc,ef->abcf")
    prog = program_from_reference(ref_prog).with_descriptor(
        vmem_limit_bytes=None)
    plan = plan_tc_launch(prog, get_index_lengths(e, 1))
    assert plan.kernel == "tc_steps_f32"
    stored = ref_apply_layouts(ref_prog, ref_generate_input_arrays(
        r, long_dim_length=1, seed=SEED, as_numpy=True))
    (want,) = fr.build_executable(ref_prog, long_dim_length=1)(stored)
    (got,) = plan.run(plan.operands(arrays_from_numpy(stored, "cpu")))
    assert_close(got.numpy(), np.asarray(want))

def test_renamed_letters_match_reference():
    """A schedule whose steps name the chain's letters otherwise than the
    einsum does (``abd,dc->abc``, then ``abc,ce->abe``: c and d trade
    names, of equal length, as the reference's lowering needs), as the
    reference renames an operand's letters by the step subscript, on a
    blocked grid."""
    shapes = ((3, 4, 5), (5, 5), (5, 7))
    e = ft.einsum("abc,cd,de->abe", *[ft.array(n, sh, "float32")
                                      for n, sh in zip("ABC", shapes)])
    r = fr.einsum("abc,cd,de->abe", *[fr.array(n, sh, "float32")
                                      for n, sh in zip("ABC", shapes)])
    ref_prog = fr.generate_program(r, schedule=RefSchedule(
        ("abd,dc->abc", "abc,ce->abe"), ("_t0", "_fe_out"),
        ((RefOperand(0), RefOperand(1)),
         (RefResult("_t0"), RefOperand(2))))).with_descriptor(
        backend="pallas", grid_index=("a", "b"), grid_blocks=(("b", 2),))
    prog = program_from_reference(ref_prog)
    assert prog.schedule.subscripts[0] == "abd,dc->abc"
    assert plan_tc_launch(prog, get_index_lengths(e, 1)).kernel \
        == "tc_steps_f32"
    logical, stored, (want,) = run_reference(ref_prog)
    (got,) = run_port(prog, stored)
    assert_close(got, want)
    assert_close(got, oracle(e, {k: torch.from_numpy(np.asarray(v))
                                 for k, v in logical.items()}))

# }}}


# {{{ the cell table and the kernel's tables

def _program(subs, shapes, grid, blocks=(), schedule=None, layouts=(),
             out_layout=None, rows=1, opt=True):
    names = [[f"{chr(ord('A') + p)}{r}" for p in range(len(shapes))]
             for r in range(rows)]
    e = ft.batched_einsum(subs, [[ft.array(n, s, "float32")
                                  for n, s in zip(row, shapes)]
                                 for row in names])
    if schedule is None:
        prog = (ft.generate_program_with_opt_einsum_schedule(e) if opt
                else ft.generate_program(e))
    else:
        prog = ft.generate_program(e, schedule=schedule)
    return e, prog.with_descriptor(
        backend="pallas", grid_index=tuple(grid), grid_blocks=tuple(blocks),
        arg_layouts=tuple(layouts), out_layout=out_layout)


def _renamed_chain():
    """The chain with its contracted letter renamed in the first step and
    its operands' letters renamed in the second."""
    return ContractionSchedule(
        ("abk,kd->abd", "xyd,de->xye", "abe->abe"),
        ("_t0", "_t1", "_fe_out"),
        ((EinsumOperand(0), EinsumOperand(1)),
         (IntermediateResult("_t0"), EinsumOperand(2)),
         (IntermediateResult("_t1"),)))


# (subscripts, shapes, grid, blocks, schedule or None, permuted, rows, opt)
TABLE_CASES = {
    "ragged_chain": ("abc,cd,de->abe", ((3, 5, 7), (7, 5), (5, 3)), "ab",
                     (("b", 5),), None, False, 1, True),
    "batch_block_triple": ("eij,ejk,ekl->eil", ((12, 3, 5), (12, 5, 7),
                                                (12, 7, 3)),
                           "e", (("e", 4),), None, False, 1, True),
    "permuted_sumfact": ("ai,bj,ck,eabc->eijk",
                         ((3, 5), (5, 7), (7, 3), (6, 3, 5, 7)), "ei",
                         (("e", 2),), None, True, 1, True),
    "b2_two_operators": ("abcd,de,ef->abcf", ((4, 3, 5, 7), (7, 3), (3, 6)),
                         "ab", (("a", 2),), None, True, 2, True),
    "trivial_four_operands": ("ai,bj,ck,eabc->eijk",
                              ((3, 5), (5, 7), (7, 3), (4, 3, 5, 7)), "e",
                              (), None, False, 1, False),
    "renamed_chain": ("abc,cd,de->abe", ((3, 4, 5), (5, 6), (6, 7)), "a",
                      (), _renamed_chain(), True, 1, True),
}


def table_case(name, device="cpu", seed=SEED):
    """``(einsum, program, logical inputs, plan)`` of a TABLE_CASES row;
    the permuted cases store every operand and the output reversed."""
    subs, shapes, grid, blocks, sched, permuted, rows, opt = \
        TABLE_CASES[name]
    e, prog = _program(subs, shapes, grid, blocks, sched, rows=rows,
                       opt=opt)
    if permuted:
        prog = prog.with_descriptor(
            arg_layouts=tuple((a.name, tuple(reversed(range(len(idx)))))
                              for row in e.args
                              for a, idx in zip(row, e.in_idx_sets)),
            out_layout=tuple(reversed(range(len(e.out_idx_set)))))
    logical = generate_input_arrays(e, long_dim_length=1, seed=seed,
                                    device=device)
    return e, prog, logical, plan_tc_launch(prog, get_index_lengths(e, 1))


@pytest.mark.parametrize("name", sorted(TABLE_CASES))
def test_plain_and_tables_match_the_einsum(name):
    """``tc_steps_plain`` and the kernel's offset tables (:func:`emulate`)
    against the logical einsum in float64: ragged extents (3, 5, 7), a
    block on a batch letter, stored permutations of the operands and the
    output, b = 2, the trivial one-step schedule of four operands and
    renamed letters."""
    e, prog, logical, plan = table_case(name)
    assert plan.kernel == "tc_steps_f32"
    table = plan_tc_steps(prog, get_index_lengths(e, 1))
    rows = plan.operands(apply_layouts(prog, logical))
    kernels.reset_launch_counts()
    outs = plan.run(rows)
    assert not any(kernels.launch_counts.values())
    for r, (got, ops) in enumerate(zip(outs, rows)):
        want = torch.from_numpy(oracle(e, logical, r))
        if prog.descriptor.out_layout is not None:
            want = want.permute(*prog.descriptor.out_layout)
        assert got.is_contiguous()
        assert_close(got, want)
        assert_close(emulate(ops, table), want, rtol=1e-12)


def test_cell_table_of_sum_factorization():
    """Three steps per cell, each summing five terms per entry, the two
    intermediates in one cell's shared memory side by side (the second
    reads the first) and the third step's room reusing the first's."""
    e, prog = _program("ai,bj,ck,eabc->eijk", ((5, 5),) * 3 + (
        (16, 5, 5, 5),), "e", (("e", 4),))
    table = plan_tc_steps(prog, get_index_lengths(e, 1))
    assert [st.n_sum for st in table.steps] == [5, 5, 5]
    assert [st.n_out for st in table.steps] == [500, 500, 500]
    assert [st.dst for st in table.steps] == [0, 500, -1]
    assert table.smem_floats == 1000 and table.ncells == 4
    assert table.threads == 256
    assert table.terms() == 4 * 3 * 500 * 5
    one = plan_tc_steps(prog.copy(schedule=ft.generate_program(e).schedule),
                        get_index_lengths(e, 1))
    assert one.terms() == 4 * 500 * 125 and one.smem_floats == 0
    # a narrow cell takes fewer threads
    e1, p1 = _program("ai,bj,ck,eabc->eijk", ((5, 5),) * 3 + (
        (16, 5, 5, 5),), "e")
    assert plan_tc_steps(p1, get_index_lengths(e1, 1)).threads == 128


def test_intermediate_room_is_reused():
    """A four-step chain: the third intermediate takes the first's room."""
    e, prog = _program("ab,bc,cd,de,ef->af",
                       ((4, 8), (8, 8), (8, 8), (8, 8), (8, 4)), "a",
                       schedule=ContractionSchedule(
                           ("ab,bc->ac", "ac,cd->ad", "ad,de->ae",
                            "ae,ef->af"),
                           ("_t0", "_t1", "_t2", "_fe_out"),
                           ((EinsumOperand(0), EinsumOperand(1)),
                            (IntermediateResult("_t0"), EinsumOperand(2)),
                            (IntermediateResult("_t1"), EinsumOperand(3)),
                            (IntermediateResult("_t2"), EinsumOperand(4)))))
    table = plan_tc_steps(prog, get_index_lengths(e, 1))
    assert [st.dst for st in table.steps] == [0, 8, 0, -1]
    assert table.smem_floats == 16


def test_planner_refuses_naming_the_limit():
    # two operators at full width gridded over a alone: the intermediate
    # (b, c, e) of 1 MB per cell
    e, prog = _program("abcd,de,ef->abcf", ((2, 64, 64, 256), (256, 64),
                                            (64, 256)), "a")
    with pytest.raises(ft.InvalidParameterError, match="shared memory"):
        plan_tc_steps(prog, get_index_lengths(e, 1))
    with pytest.raises(ft.InvalidParameterError, match="shared memory"):
        get_transform_func_from_module_path("tc_pallas_v0").bind_args(
            e, n_grid=1, precision_idx=0, use_opt_path=True)(
                ft.generate_program(e))
    nine = "ab,bc,cd,de,ef,fg,gh,hi,ij,jk->ak"
    shapes = ((2, 2),) * 10
    e9, p9 = _program(nine, shapes, "a", opt=False)
    with pytest.raises(ft.InvalidParameterError,
                       match="at most 8 operands per row"):
        plan_tc_steps(p9, get_index_lengths(e9, 1))
    e7, p7 = _program("ab,bc,cd,de,ef,fg,gh->ah", ((2, 2),) * 7, "a",
                      opt=False)
    with pytest.raises(ft.InvalidParameterError,
                       match="at most 6 operands per step"):
        plan_tc_steps(p7, get_index_lengths(e7, 1))
    letters = "abcdefghijklmnopq"
    e17, p17 = _program(f"{letters},{letters[1:]}->a", ((2,) * 17, (2,) * 16),
                        "a", opt=False)
    with pytest.raises(ft.InvalidParameterError, match="letters per step"):
        plan_tc_steps(p17, get_index_lengths(e17, 1))
    e8, p8 = _program("ab,bc,cd,de,ef,fg,gh,hi->ai", ((2, 2),) * 8, "a",
                      opt=False)
    names = ["_t0", "_t1"] + [f"_s{k}" for k in range(6)] + ["_fe_out"]
    sched = ContractionSchedule(
        ("ab->ab", "ab->ab") + tuple(
            f"a{c},{c}{n}->a{n}" for c, n in zip("bcdefgh", "cdefghi")),
        tuple(names),
        ((EinsumOperand(0),), (IntermediateResult("_t0"),)) + tuple(
            (IntermediateResult(names[k + 1]), EinsumOperand(k + 1))
            for k in range(7)))
    with pytest.raises(ft.InvalidParameterError, match="at most 8 steps"):
        plan_tc_steps(p8.copy(schedule=sched), get_index_lengths(e8, 1))


def test_a_step_that_contracts_a_grid_letter_is_refused():
    """A renamed grid letter keeps its origin: a step may not sum it."""
    e, prog = _program("ab,bc->ac", ((4, 3), (3, 5)), "a",
                       schedule=ContractionSchedule(
                           ("xb->b", "ab,bc->ac"), ("_t", "_fe_out"),
                           ((EinsumOperand(0),),
                            (EinsumOperand(0), EinsumOperand(1)))))
    with pytest.raises(ft.InvalidParameterError, match="grid letter 'a'"):
        plan_tc_steps(prog, get_index_lengths(e, 1))


def test_bf16_3x_runs_f32_under_its_name():
    e, prog, logical, plan = table_case("ragged_chain")
    p3 = prog.with_descriptor(precision="bf16_3x")
    plan3 = plan_tc_launch(p3, get_index_lengths(e, 1))
    assert plan3.kernel == "tc_steps_f32"
    rows = plan.operands(apply_layouts(prog, logical))
    assert torch.equal(plan3.run(rows)[0], plan.run(rows)[0])


def test_two_operand_steps_stay_on_tc_grid():
    """The TCCG rows' tuner seeds plan onto ``tc_grid_f32`` as before; the
    same rows at one step of a single operand pair with a block on a batch
    letter, or with a letter contracted within one operand, go to
    ``tc_steps_f32``."""
    v1 = get_transform_func_from_module_path("tc_pallas_v1")
    for name, e in S.tccg_suite():
        for seed in S.TCCG_SEEDS.get(name, []):
            ce = ft.canonicalize_einsum(e)
            prog = v1.bind_args(ce, **seed, precision_idx=0)(
                ft.generate_program(ce))
            assert plan_tc_launch(prog, get_index_lengths(ce, 1)).kernel \
                == "tc_grid_f32"
    e, prog = _program("eij,ejk->eik", ((6, 3, 4), (6, 4, 5)), "e",
                       (("e", 2),))
    assert plan_tc_launch(prog, get_index_lengths(e, 1)).kernel \
        == "tc_steps_f32"
    assert plan_tc_launch(prog.with_descriptor(grid_blocks=()),
                          get_index_lengths(e, 1)).kernel == "tc_grid_f32"
    e2, p2 = _program("ijx,jk->ik", ((3, 4, 2), (4, 5)), "i")
    assert plan_tc_launch(p2, get_index_lengths(e2, 1)).kernel \
        == "tc_steps_f32"
    logical = generate_input_arrays(e2, long_dim_length=1, seed=1,
                                    device="cpu")
    (got,) = ft.build_executable(p2, device="cpu")(apply_layouts(p2,
                                                                 logical))
    assert_close(got, oracle(e2, logical))

# }}}


# {{{ the spaces and the archive path

def test_v1_searches_the_schedule_on_three_operands():
    """``use_opt_path`` changes the kernel's work on three or more operands
    and is searched there; on two it stays unsearched."""
    v1 = get_transform_func_from_module_path("tc_pallas_v1")
    e, _ = make_pair("two_operators")
    assert "use_opt_path" in v1.get_param_space(e)
    assert "use_opt_path" not in v1.get_param_space(S.tccg_suite()[0][1])
    terms = {}
    for opt in (False, True):
        prog = v1.bind_args(e, n_grid=2, blk0_idx=1, blk1_idx=1, m_pos=2,
                            precision_idx=0, use_opt_path=opt)(
            ft.generate_program(e))
        terms[opt] = plan_tc_steps(prog, get_index_lengths(e, 1)).terms()
    assert terms[True] < terms[False]


def test_archive_path_on_cpu(tmp_path):
    """autotune -> query -> candidate ladder -> replay -> validate on the
    chain, on CPU (host timings under the key ``cpu``), and the replay's
    output equals the reference's for the same fact."""
    e, r = make_pair("two_operators")
    db = str(tmp_path / "steps.sqlite")
    seeds = [dict(n_grid=2, blk0_idx=0, blk1_idx=1, m_pos=3,
                  precision_idx=0, use_opt_path=True),
             dict(n_grid=1, blk0_idx=1, blk1_idx=0, m_pos=3,
                  precision_idx=0, use_opt_path=False)]
    ft.autotune(e, "tc_pallas_v1", db_path=db, device="cpu", test_limit=3,
                seed_configs=seeds)
    facts = ft.query(e, "cpu", db_path=db)
    assert len(facts) == 3
    assert [dict(q.transform_params) for q in facts[:len(seeds)]] == seeds
    winner = next(S.candidate_transforms("two_operators", e, db_path=db,
                                         device="cpu"))
    assert winner.fact is not None
    ft.validate_batched_einsum_transform(e, winner.transform, device="cpu")
    prog = winner.transform(ft.generate_program(e))
    plan = plan_tc_launch(prog, get_index_lengths(e, 1))
    assert plan.kernel == "tc_steps_f32"
    params = dict(winner.fact.transform_params)
    rce = fr.canonicalize_einsum(r)
    ref_prog = ref_space("tc_pallas_v1").bind_args(
        rce, **{"mstack": False, "use_opt_path": False, **params})(
        fr.generate_program(r))
    _, stored, (want,) = run_reference(ref_prog)
    (got,) = run_port(prog, stored)
    assert_close(got, want)


@pytest.mark.parametrize("key", sorted(S.TC_STEPS_SEEDS))
def test_suite_rows_and_seeds_bind(key):
    """The suite's three rows at full size and their seeds bind in both
    TC spaces and plan onto ``tc_steps_f32`` within a Hopper block."""
    rows = dict(S.tc_steps_suite())
    e = rows[key]
    ce = ft.canonicalize_einsum(e)
    for space, seeds in S.TC_STEPS_SEEDS[key].items():
        sp = get_transform_func_from_module_path(space)
        assert seeds
        for params in seeds:
            prog = sp.bind_args(ce, **params)(ft.generate_program(ce))
            plan = plan_tc_launch(prog, get_index_lengths(ce, 1))
            assert plan.kernel == "tc_steps_f32"

# }}}

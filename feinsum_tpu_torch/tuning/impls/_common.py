"""Shared helpers of the transform spaces."""

from __future__ import annotations

from ...diagnostics import InvalidParameterError
from ...einsum import SizeParam


def _is_streamed(einsum, p: int) -> bool:
    return any(isinstance(einsum.index_to_dim_length[ix], SizeParam)
               for ix in einsum.in_idx_sets[p])


def _private_indices(einsum, p: int) -> list:
    """The indices of operand *p* that no other operand and not the output
    carries."""
    elsewhere = set(einsum.out_idx_set)
    for q in range(einsum.n):
        if q != p:
            elsewhere |= set(einsum.in_idx_sets[q])
    return [ix for ix in einsum.in_idx_sets[p] if ix not in elsewhere]


def has_resident_private_indices(einsum) -> bool:
    """Whether some resident (no-long-axis) operand carries indices private
    to it, which a first step can sum away: the ``prereduce`` knob's
    applicability (:func:`prereduce_resident_private`)."""
    return any(not _is_streamed(einsum, p) and _private_indices(einsum, p)
               for p in range(einsum.n))


def jfold_applicable(einsum) -> bool:
    """``jfold`` needs >= 2 streamed operands (to form the outer product)
    and >= 1 resident operand (to contract against)."""
    n_long = sum(_is_streamed(einsum, p) for p in range(einsum.n))
    return 2 <= n_long < einsum.n


def long_axis_of(einsum) -> str:
    """The einsum's one parametric (long) index letter."""
    params = [ix for ix, ln in einsum.index_to_dim_length.items()
              if isinstance(ln, SizeParam)]
    if len(params) != 1:
        raise InvalidParameterError(
            f"schedule space expects exactly one parametric axis, found"
            f" {params}")
    return params[0]


def fp32_precision(name: str) -> str:
    """A space's precision choice, checked: the full-fp32 names and
    ``"bf16_3x"`` (the reference's 3-pass bf16 dot; three TF32 tensor-core
    passes on the card, see the descriptor's ``precision``) pass; any other
    name raises :class:`InvalidParameterError`."""
    from ...codegen.descriptor import FP32_PRECISIONS, SPLIT_PRECISIONS
    if name not in FP32_PRECISIONS + SPLIT_PRECISIONS:
        raise InvalidParameterError(
            f"precision {name!r}: the port runs full fp32"
            f" {FP32_PRECISIONS} or the 3xTF32 split {SPLIT_PRECISIONS}")
    return name


def has_dg_dot(einsum) -> bool:
    """Whether the fused route plans *einsum*'s rows onto ``dg_rows_f32``
    (a contracted short axis, the long axis and another letter in the
    output), the one fused kernel with a 3xTF32 variant: the rows where
    ``precision_3x`` changes the launch."""
    el = long_axis_of(einsum)
    return bool(einsum.sum_indices) and el in einsum.out_idx_set \
        and len(einsum.out_idx_set) > 1


def resolve_block(log2_block: int, blkc128: int = 0) -> int:
    """Elements of the long axis per thread block from the space's params:
    ``1024 * blkc128`` when ``blkc128 > 0``, else ``2 ** log2_block`` (the
    encoding of ``feinsum_tpu``'s spaces, so their facts bind here)."""
    return 1024 * int(blkc128) if blkc128 else 2 ** int(log2_block)


def guard_smem(einsum, kernel: str = "dd_rows", program=None) -> None:
    """Raise :class:`InvalidParameterError` when one thread block of the
    kernel that runs a row would need more shared memory than a Hopper
    block has (227 KB): the analog of ``feinsum_tpu``'s VMEM guard.  The
    demand depends on the row shape only, not on the block length, except
    for ``step_block_f32``.

    *kernel* is ``"dd_rows"`` (the fp64 DG rows), ``"dg_rows_f32"``, the
    float32 fused route, ``"dg_rows_3xtf32"``, that route at ``bf16_3x``,
    or ``"lane_pack_dg_f32"``/``"lane_pack_dg_3xtf32"``, a packed DG
    program (:func:`rewrite_lane_pack_dg`), whose shared memory holds a
    fixed tile of each operand however wide g·d is, so that what the guard
    checks are the kernel's limits on the rewrite's structure
    (:func:`~feinsum_tpu_torch.ops.kernels.check_lane_pack_dg_shape`).  A
    packed matvec (:func:`rewrite_lane_pack`) is a plain matvec over g·d
    and is checked as one, with R the kron-expanded (g·di, g·dj) resident.
    On the fused route each row goes to the kernel that will run it:
    a contraction-free row to ``ew_product_f32`` (no shared memory), a row
    whose output is the long axis alone to ``row_reduce_f32`` (its weight
    w, at most ``MAX_REDUCE_J`` values), and the others to ``dg_rows_f32``
    (R and one u column per thread); a row whose long axis is contracted to
    ``long_reduce_f32`` (its output entries and staged rows) and a
    restriction row to ``dg_rows_f32`` as a matvec over its merged output
    letters (at ``bf16_3x`` on ``dg_rows_3xtf32``, whose shared memory
    also holds a tile of the outputs, so X counts).

    With *program* (the program the kernels run, after hoisting, whose
    einsum is *einsum*), a fused program that no row family takes
    (``ops/cuda_emitter.py::row_family``), or any program with *kernel*
    ``"step_block_f32"``, is checked as ``step_block_f32`` runs it: its
    steps' staged residents and results of one sub-tile of elements at its
    block length, and the kernel's limits on steps, operands and letters
    (:func:`~feinsum_tpu_torch.ops.step_block.plan_step_block`)."""
    from ...codegen.program import get_index_lengths
    from ...ops.cuda_emitter import row_family
    from ...ops.dg_rows import plan_reduce_row, plan_row, \
        resident_carries_outputs
    from ...ops.kernels import MAX_REDUCE_J, MAX_SMEM_BYTES, \
        dd_rows_smem_bytes, dg_rows_3x_smem_bytes, dg_rows_smem_bytes
    from ...ops.step_block import plan_step_block

    if program is not None and kernel != "dd_rows":
        lengths = get_index_lengths(program.einsum, 1)
        if kernel == "step_block_f32" or (
                not kernel.startswith("lane_pack_dg")
                and row_family(program, lengths) is None):
            plan_step_block(program, lengths)
            return
    if kernel == "step_block_f32":
        raise ValueError("guard_smem: step_block_f32 is checked on a program")
    if kernel.startswith("lane_pack_dg"):
        from ...ops.lane_pack import lane_pack_dg_shape
        lane_pack_dg_shape(einsum, kernel.endswith("3xtf32"))
        return
    smem_bytes = {"dd_rows": lambda X, *a: dd_rows_smem_bytes(*a),
                  "dg_rows_f32": lambda X, *a: dg_rows_smem_bytes(*a),
                  "dg_rows_3xtf32": dg_rows_3x_smem_bytes}[kernel]
    fused = kernel != "dd_rows"
    lengths = einsum.index_to_dim_length
    if fused and long_axis_of(einsum) not in einsum.out_idx_set:
        _guard_long_reduce(einsum)
        return
    if fused and resident_carries_outputs(einsum):
        # a restriction row: a matvec over the merged output letters
        (r_idx,) = [idx for idx in einsum.in_idx_sets
                    if long_axis_of(einsum) not in idx]
        i_len = j_len = 1
        for ix in r_idx:
            if ix in einsum.out_idx_set:
                i_len *= int(lengths[ix])
            else:
                j_len *= int(lengths[ix])
        need = smem_bytes(1, 1, i_len, j_len, False)
        if need > MAX_SMEM_BYTES:
            raise InvalidParameterError(
                f"{kernel} needs {need} bytes of shared memory per block;"
                f" a Hopper block has {MAX_SMEM_BYTES}")
        return
    for row in range(einsum.b):
        if fused and not einsum.sum_indices:
            continue
        if fused and len(einsum.out_idx_set) == 1:
            j = int(lengths[plan_reduce_row(einsum, row).j_letter])
            if j > MAX_REDUCE_J:
                raise InvalidParameterError(
                    f"row_reduce_f32 holds at most {MAX_REDUCE_J} weights in"
                    f" shared memory, the row has {j}")
            continue
        p = plan_row(einsum, row)
        S = int(lengths[p.s_letter]) if p.s_letter is not None else 1
        X = int(lengths[p.x_letter]) if p.x_letter is not None else 1
        need = smem_bytes(X, S, int(lengths[p.i_letter]),
                          int(lengths[p.j_letter]), p.u_has_s)
        if need > MAX_SMEM_BYTES:
            raise InvalidParameterError(
                f"{kernel} needs {need} bytes of shared memory per block;"
                f" a Hopper block has {MAX_SMEM_BYTES}")


def _guard_long_reduce(einsum) -> None:
    """``long_reduce_f32``'s limits on a row with a contracted long axis:
    its output entries and the staged rows of its short letters."""
    from ...codegen.program import generate_program
    from ...ops.cuda_emitter import long_reduce_shape
    lengths = {ix: 1 if isinstance(ln, SizeParam) else int(ln)
               for ix, ln in einsum.index_to_dim_length.items()}
    long_reduce_shape(generate_program(einsum), lengths)


def guard_tc_grid(program) -> None:
    """Raise :class:`InvalidParameterError` when the contraction kernels
    cannot take *program* (a tuple ``grid_index``): the Hopper kernels' own
    limits in place of ``feinsum_tpu``'s VMEM and Mosaic guards.  It plans
    through :func:`~feinsum_tpu_torch.ops.tc_emitter.plan_tc_launch`, which
    routes the program: one step of two einsum operands to ``tc_grid_f32``,
    which tiles every cell and needs no shared memory or unrolling that
    grows with it (it refuses what is structural, see
    :func:`~feinsum_tpu_torch.ops.kernels.tc_classify`, or a launch of more
    than 2**31 - 1 blocks); every other schedule to ``tc_steps_f32``, which
    refuses a cell whose intermediates exceed a Hopper block's shared
    memory, or more steps, operands per step or letters per step than it
    takes (:func:`~feinsum_tpu_torch.ops.tc_steps.plan_tc_steps`)."""
    from ...codegen.program import get_index_lengths
    from ...ops.tc_emitter import plan_tc_launch

    plan_tc_launch(program, get_index_lengths(program.einsum, 1))


def prereduce_resident_private(einsum, schedule):
    """Prefix *schedule* with steps that reduce each resident (no-long-axis)
    operand over its private indices (in no other operand nor the output),
    and rewrite later steps to read the reduced results.  Curl's D (r, i, j)
    with r private becomes ``rij->ij``: on the fused route that step is
    hoisted, and each row becomes a mass-shaped launch.  Returns *schedule*
    itself when no resident operand has private indices."""
    from ...contraction_schedule import (
        ContractionSchedule,
        EinsumOperand,
        IntermediateResult,
    )

    e = einsum
    pre_subs, pre_names, pre_args = [], [], []
    replace = {}
    for p in range(e.n):
        private = [] if _is_streamed(e, p) else _private_indices(e, p)
        if private:
            sub = e.in_idx_sets[p]
            reduced = "".join(ix for ix in sub if ix not in private)
            name = f"_fe_pre_{p}"
            pre_subs.append(f"{''.join(sub)}->{reduced}")
            pre_names.append(name)
            pre_args.append((EinsumOperand(p),))
            replace[p] = (name, reduced)
    if not replace:
        return schedule
    new_subs, new_args = [], []
    for subs_, args_ in zip(schedule.subscripts, schedule.arguments):
        ins, out = subs_.split("->")
        ins2, args2 = [], []
        for s_, a_ in zip(ins.split(","), args_):
            if isinstance(a_, EinsumOperand) and a_.position in replace:
                name, reduced = replace[a_.position]
                ins2.append(reduced)
                args2.append(IntermediateResult(name))
            else:
                ins2.append(s_)
                args2.append(a_)
        new_subs.append(f"{','.join(ins2)}->{out}")
        new_args.append(tuple(args2))
    return ContractionSchedule(
        subscripts=tuple(pre_subs) + tuple(new_subs),
        result_names=tuple(pre_names) + schedule.result_names,
        arguments=tuple(pre_args) + tuple(new_args))


def fused_pallas_program(program, *, block_long: int, hoist: bool,
                         parallel_grid: bool = True, dofmajor: bool = False,
                         fold: bool = False, preblock: bool = False,
                         precision_3x: bool = False, jfold: bool = False,
                         prereduce: bool = False, vmem_idx=None,
                         split_rows: bool = False, accum_f32: bool = False,
                         host_hoist: bool = True, mfold: bool = False,
                         keep_schedule: bool = False, **desc):
    """``feinsum_tpu``'s core DG schedule on the fused kernels
    (``backend="pallas"``): the schedule (the program's own with
    *keep_schedule*, which a packed DG program carries from
    :func:`rewrite_lane_pack_dg`; else ``jfold``'s outer-product-first
    one, the optimal path with ``hoist``, else the trivial one), resident
    pre-reduction (``prereduce``), *block_long* elements per thread block,
    *parallel_grid* as ``dimension_semantics``, *dofmajor* layouts, one
    launch per row with *split_rows*, and ``hoist_resident_steps`` from
    *host_hoist*; extra keywords are descriptor fields (``flatten``).

    On the card: ``precision_3x`` sets ``precision="bf16_3x"``, as in the
    reference (three TF32 tensor-core passes for the DG rows' j-dot on
    ``dg_rows_3xtf32``); ``fold`` (the fold-8 storage), ``preblock`` (the
    (8, 128) tile blocks) and ``mfold`` (MXU row packing) raise;
    ``vmem_idx`` (the TPU's VMEM cap) is accepted and ignored.  Shared
    memory is guarded per row on the einsum the kernels run
    (:func:`guard_smem`); a program that no row family takes is guarded
    as ``step_block_f32`` runs it."""
    from ...contraction_schedule import (
        get_opt_einsum_contraction_schedule,
        get_trivial_contraction_schedule,
    )
    from ...ops.cuda_emitter import hoist_resident_steps
    from ...ops.layouts import dofmajor_layouts

    del vmem_idx     # a TPU VMEM cap; see the docstring
    for on, why in (
            (fold, "fold: the TPU's fold-8 storage"),
            (preblock, "preblock: the TPU's (8, 128) tile blocks"),
            (mfold, "mfold: the TPU's MXU row packing")):
        if on:
            raise InvalidParameterError(f"{why} has no Hopper meaning")
    e = program.einsum
    if keep_schedule:
        schedule = program.schedule
    elif jfold:
        from ...algebraic import \
            extract_multiplicative_terms_in_sum_reduction_as_subst
        from ...codegen.program import generate_program

        if not jfold_applicable(e):
            raise InvalidParameterError(
                "jfold needs >=2 streamed operands and >=1 resident operand")
        long_pos = [p for p in range(e.n) if _is_streamed(e, p)]
        schedule = prereduce_resident_private(
            e, extract_multiplicative_terms_in_sum_reduction_as_subst(
                generate_program(e), long_pos).schedule)
    elif hoist:
        schedule = get_opt_einsum_contraction_schedule(e)
    else:
        schedule = get_trivial_contraction_schedule(e)
    if prereduce and not jfold and not keep_schedule:
        reduced = prereduce_resident_private(e, schedule)
        if reduced is schedule:
            raise InvalidParameterError(
                "prereduce: no resident operand has private contracted"
                " indices")
        schedule = reduced
    if dofmajor and "arg_layouts" not in desc:
        desc["arg_layouts"], desc["out_layout"] = dofmajor_layouts(e)
    if split_rows:
        if e.b <= 1:
            raise InvalidParameterError(
                "split_rows needs a multi-row batched einsum")
        desc["multiple_results_in_one_kernel"] = False
    if accum_f32:
        if all(dt.itemsize >= 4 for dt in e.arg_to_dtype.values()):
            raise InvalidParameterError(
                "accum_f32 only applies to sub-32-bit input dtypes")
        desc["accum_dtype"] = "float32"
    if not host_hoist:
        desc["hoist_resident_steps"] = False
    if precision_3x:
        desc["precision"] = "bf16_3x"
    p2 = program.copy(schedule=schedule).with_descriptor(
        backend="pallas",
        block_long=block_long,
        dimension_semantics="parallel" if parallel_grid else "arbitrary",
        **desc)
    kernel_program = hoist_resident_steps(p2)[0]
    guard_smem(kernel_program.einsum,
               ("lane_pack_dg" if keep_schedule else "dg_rows")
               + ("_3xtf32" if precision_3x else "_f32"),
               program=kernel_program)
    return p2


def make_dg_space(*, log2_block_max: int = 18):
    """The DG family's transform space: every DG module
    (``dg_div_v0``, ``dg_grad_v0``, ``face_mass_v0``, ``mass_v0``,
    ``curl_3d_v0``) is ``transform = make_dg_space()``.  It has
    ``feinsum_tpu``'s parameter names, defaults and signature, so every
    archived fact binds.  It searches only the knobs whose values launch
    different kernels or arguments on the card; the others are pinned
    (``IntParameter(v, v)``) at a value that sets no TPU-only field:

    * searched: ``log2_block``/``blkc128`` (``block_long``), ``dofmajor``
      (where it changes a layout), ``prereduce`` (where a resident operand
      has private indices: curl), ``rowcat`` (where rows can be stacked:
      div, curl), ``split_rows`` (b > 1), ``precision_3x`` (where the
      rows go to ``dg_rows_f32``, whose 3xTF32 variant it selects:
      :func:`has_dg_dot`; elsewhere pinned at 0, and a fact with it on
      binds and runs the f32 kernel) and ``lane_pack_g`` in [0, 5] where
      the reference searches it (:func:`lane_packable` or
      :func:`lane_pack_dg_applicable`): g = 2**lane_pack_g elements per
      packed row, after ``rowcat`` when both are on (the rewrites and
      their guards are the reference's, see :func:`rewrite_lane_pack` and
      :func:`rewrite_lane_pack_dg`; the DG variant refuses ``hoist``,
      ``jfold``, ``mfold`` and ``prereduce``);
    * pinned, accepted at any value: ``parallel_grid`` (1),
      ``vmem_idx`` (2, ignored), ``host_hoist`` (1), ``hoist`` and
      ``jfold`` (0: they build the reference's schedules, and
      ``dg_rows_f32`` computes each row's value whatever the step order;
      no DG row's optimal path has a resident-only step, and ``jfold``'s
      pre-reduction on curl is ``prereduce``'s launch);
    * pinned at 0, raising at 1: ``fold``, ``preblock`` and ``mfold``;
      ``accum_f32`` is gated off for 32-bit inputs, as in the reference."""
    from ...ops.layouts import dofmajor_layouts
    from .. import BoolParameter, IntParameter, transform_param

    def gate(cond):
        return BoolParameter() if cond else IntParameter(0, 0)

    def pinned(value: int):
        return lambda e: IntParameter(value, value)

    @transform_param("log2_block", lambda e: IntParameter(8, log2_block_max))
    @transform_param("blkc128", lambda e: IntParameter(0, 32))
    @transform_param("dofmajor", lambda e: gate(
        dofmajor_layouts(e) != ((), None)))
    @transform_param("fold", pinned(0))
    @transform_param("preblock", pinned(0))
    @transform_param("precision_3x", lambda e: gate(has_dg_dot(e)))
    @transform_param("hoist", pinned(0))
    @transform_param("jfold", pinned(0))
    @transform_param("mfold", pinned(0))
    @transform_param("prereduce", lambda e: gate(
        has_resident_private_indices(e)))
    @transform_param("lane_pack_g", lambda e: (
        IntParameter(0, 5) if lane_packable(e) or lane_pack_dg_applicable(e)
        else IntParameter(0, 0)))
    @transform_param("rowcat", lambda e: gate(rowcat_applicable(e)))
    @transform_param("parallel_grid", pinned(1))
    @transform_param("vmem_idx", pinned(2))
    @transform_param("split_rows", lambda e: gate(e.b > 1))
    @transform_param("accum_f32", lambda e: gate(
        any(dt.itemsize < 4 for dt in e.arg_to_dtype.values())))
    @transform_param("host_hoist", pinned(1))
    def transform(program, log2_block, blkc128=0, *, dofmajor, parallel_grid,
                  hoist=False, fold=False, preblock=False, precision_3x=False,
                  jfold=False, mfold=False, prereduce=False, lane_pack_g=0,
                  rowcat=False, vmem_idx=None, split_rows=False,
                  accum_f32=False, host_hoist=True):
        extras = {}
        if rowcat:
            if split_rows:
                raise InvalidParameterError(
                    "rowcat merges rows; split_rows contradicts it")
            program, extras = rewrite_rowcat(program)
        keep_schedule = False
        if lane_pack_g:
            g = 2 ** int(lane_pack_g)
            if lane_packable(program.einsum):
                program, ex = rewrite_lane_pack(program, g)
            else:
                if hoist or jfold or mfold or prereduce:
                    raise InvalidParameterError(
                        "lane_pack (DG variant) fixes its own schedule;"
                        " hoist/jfold/mfold/prereduce do not compose")
                program, ex = rewrite_lane_pack_dg(program, g)
                keep_schedule = True
            extras.update(ex)
        p2 = fused_pallas_program(
            program, block_long=resolve_block(log2_block, blkc128),
            hoist=bool(hoist), parallel_grid=parallel_grid,
            dofmajor=dofmajor, fold=fold, preblock=preblock,
            precision_3x=precision_3x, jfold=bool(jfold), mfold=bool(mfold),
            prereduce=bool(prereduce), vmem_idx=vmem_idx,
            split_rows=bool(split_rows), accum_f32=bool(accum_f32),
            host_hoist=bool(host_hoist), keep_schedule=keep_schedule)
        return p2.with_descriptor(**extras) if extras else p2

    return transform


def lane_packable(einsum):
    """``feinsum_tpu``'s shape check for the lane-pack rewrite: a single-row
    2-operand matvec-class einsum (streamed (e, j) with the long axis
    leading, resident over {i, j}, output (e, i)), or the vecmat variant
    ``ej,j->e``.  Returns ``(el, i_letter, j_letter, streamed_name,
    resident_name, resident_idx)`` or ``None``."""
    e = einsum
    if e.b != 1 or e.n != 2:
        return None
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if len(long_letters) != 1:
        return None
    el = long_letters[0]
    streamed = [p for p, s in enumerate(e.in_idx_sets) if el in s]
    if len(streamed) != 1:
        return None
    sp = streamed[0]
    rp = 1 - sp
    s_idx, r_idx = e.in_idx_sets[sp], e.in_idx_sets[rp]
    if len(s_idx) != 2 or s_idx[0] != el:
        return None
    j = s_idx[1]
    if tuple(e.out_idx_set) == (el,) and tuple(r_idx) == (j,):
        return (el, None, j, e.args[0][sp].name, e.args[0][rp].name, (j,))
    if len(e.out_idx_set) != 2 or e.out_idx_set[0] != el:
        return None
    i = e.out_idx_set[1]
    if set(r_idx) != {i, j} or i == j:
        return None
    return (el, i, j, e.args[0][sp].name, e.args[0][rp].name, tuple(r_idx))


def lane_pack_dg_applicable(einsum):
    """``feinsum_tpu``'s structure check for the DG-family lane-pack
    rewrite: three operands, one resident over (i, j, m...), one main
    streamed ``(lam_u..., e, j)``, one scale streamed ``(e, s)`` or
    ``(lam_j..., e)``, and output ``(chi..., e, i)``.  Returns the
    structure dict or ``None``."""
    e = einsum
    if e.n != 3:
        return None
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if len(long_letters) != 1:
        return None
    el = long_letters[0]
    out = tuple(e.out_idx_set)
    if len(out) < 2 or out[-2] != el or out[-1] == el:
        return None
    i = out[-1]
    chi = out[:-2]
    if el in chi or i in chi:
        return None
    residents = [p for p, s in enumerate(e.in_idx_sets) if el not in s]
    if len(residents) != 1:
        return None
    rp = residents[0]
    rho = tuple(e.in_idx_sets[rp])
    if i not in rho:
        return None
    streamed = [p for p in range(3) if p != rp]

    def classify(up, jp):
        s = tuple(e.in_idx_sets[up])
        if not (len(s) >= 2 and s[-2] == el and s[-1] in rho and s[-1] != i
                and s[-1] not in out and set(s[:-2]) <= set(rho) - {i}):
            return None
        j, lam_u = s[-1], s[:-2]
        js = tuple(e.in_idx_sets[jp])
        m = tuple(c for c in rho if c not in (i, j))
        if len(js) == 2 and js[0] == el and js[1] in m:
            variant, s_ax, lam_j = "A", js[1], ()
        elif js[-1] == el and el not in js[:-1]:
            variant, s_ax, lam_j = "B", None, js[:-1]
            if not set(lam_j) <= set(m) | set(chi):
                return None
            if i in lam_j or j in lam_j:
                return None
        else:
            return None
        if not set(chi) <= set(lam_j):
            return None
        for c in set(rho) | set(lam_j) | {i, j}:
            if c != el and isinstance(e.index_to_dim_length[c], SizeParam):
                return None
        return dict(el=el, i=i, j=j, chi=chi, rp=rp, up=up, jp=jp, rho=rho,
                    m=m, lam_u=lam_u, lam_j=lam_j, variant=variant,
                    s_ax=s_ax)

    cands = [c for c in (classify(streamed[0], streamed[1]),
                         classify(streamed[1], streamed[0])) if c]
    if not cands:
        return None
    return max(cands, key=lambda c: int(e.index_to_dim_length[c["j"]]))


def _check_packed_dims(g: int, di: int, dj: int) -> None:
    """The reference's guards on the packed dof widths, part of the space:
    g·di and g·dj multiples of 8 and at most 4096."""
    if (g * di) % 8 or (g * dj) % 8:
        raise InvalidParameterError(
            f"lane_pack={g}: packed dims ({g}*{di}, {g}*{dj}) must be"
            f" 8-sublane-aligned")
    if g * max(di, dj) > 4096:
        raise InvalidParameterError(
            f"lane_pack={g}: packed dim {g * max(di, dj)} exceeds the 4096"
            f" resident cap")


def rewrite_lane_pack(program, g: int):
    """Rewrite a matvec-class program (:func:`lane_packable`) for
    ``lane_pack=g``, as ``feinsum_tpu`` does: the einsum becomes the same
    class with d -> g·d and E -> E/g; the streamed operand and the output
    are stored packed (free views of the row-major tensors) and the
    resident matrix becomes kron(I_g, D), built on the card once per call
    (``descriptor.kron_args``).  The vecmat variant ``ej,j->e`` gains an
    output axis of length g (its resident kron(I_g, x[:, None])).

    The guards are the reference's and define the space (they are not
    Hopper limits): g·di and g·dj multiples of 8, at most 4096.  Returns
    ``(rewritten_program, descriptor_extras)``; raises
    :class:`InvalidParameterError` when the shape does not qualify."""
    from ...contraction_schedule import get_trivial_contraction_schedule
    from ...make_einsum import array, einsum

    e = program.einsum
    info = lane_packable(e)
    if info is None:
        raise InvalidParameterError(
            "lane_pack applies only to matvec-class einsums"
            " (streamed (e,j) x resident (i,j) -> (e,i))")
    el, i, j, s_name, r_name, r_idx = info
    if i is None:
        # vecmat: the group axis becomes the new output dof axis
        i = next(c for c in "abcdefghijklmnopqrstuvwxyz"
                 if c not in (el, j) and c not in e.arg_to_shape)
        di = 1
        r_idx = (j, i)
    else:
        di = int(e.index_to_dim_length[i])
    dj = int(e.index_to_dim_length[j])
    _check_packed_dims(g, di, dj)
    sizes = {i: g * di, j: g * dj}
    e2 = einsum(
        f"{el}{j},{''.join(r_idx)}->{el}{i}",
        array(s_name, (f"N{el}_", g * dj), e.arg_to_dtype[s_name].name),
        array(r_name, tuple(sizes[ix] for ix in r_idx),
              e.arg_to_dtype[r_name].name))
    extras = dict(lane_pack=int(g), lane_pack_args=(s_name,),
                  kron_args=(r_name,))
    return program.copy(einsum=e2,
                        schedule=get_trivial_contraction_schedule(e2)), extras


def rewrite_lane_pack_dg(program, g: int):
    """Rewrite a DG-class program (:func:`lane_pack_dg_applicable`) for
    ``lane_pack=g``, as ``feinsum_tpu`` does: g consecutive elements share
    one packed dof row.

    * the main streamed ``u`` is stored (lam_u..., E/g, g·dj) and the scale
      streamed ``J`` (E/g, g·s) (variant A, div) or (lam_j..., E/g, g)
      (variant B), free views (``descriptor.lane_pack_args``);
    * the resident ``R`` becomes ``T[m] = kron(I_g, R[m])`` and a 0/1
      expansion matrix ``EXP`` spreads each element's scale over its di
      output lanes, both built on the card once per call
      (``kron_args``, ``lane_pack_expand``);
    * the schedule is three steps: ``V = u'·T`` (per m), ``W = J'·EXP``,
      then the product summed over the shared concrete axes not in the
      output, the schedule ``lane_pack_dg_f32`` runs.

    The guards are the reference's and define the space: g·di, g·dj and the
    packed scale lanes multiples of 8, g·max(di, dj) at most 4096.  Returns
    ``(rewritten_program, descriptor_extras)``."""
    from ...contraction_schedule import (
        ContractionSchedule,
        EinsumOperand,
        IntermediateResult,
    )
    from ...make_einsum import array, batched_einsum

    e = program.einsum
    info = lane_pack_dg_applicable(e)
    if info is None:
        raise InvalidParameterError(
            "lane_pack (DG variant) applies only to 3-operand classes with"
            " one resident, one (.., e, j) streamed and one scale streamed"
            " operand")
    el, i, j = info["el"], info["i"], info["j"]
    di = int(e.index_to_dim_length[i])
    dj = int(e.index_to_dim_length[j])
    _check_packed_dims(g, di, dj)
    used = set(e.index_to_dim_length) | set("".join(e.arg_to_shape))
    fresh = (c for c in "abcdefghijklmnopqrstuvwxyz" if c not in used)
    exp_name = "_lp_exp0"
    long_name = f"N{el}_"

    m, lam_u, lam_j = info["m"], info["lam_u"], info["lam_j"]
    chi, rho = info["chi"], info["rho"]
    sizes = {c: int(e.index_to_dim_length[c])
             for c in set(rho) | set(lam_j) if c != el}
    sizes[i] = g * di
    sizes[j] = g * dj
    s_lanes = g * (int(e.index_to_dim_length[info["s_ax"]])
                   if info["variant"] == "A" else 1)
    if s_lanes % 8:
        raise InvalidParameterError(
            f"lane_pack={g}: packed scale lanes ({s_lanes}) must be"
            f" 8-sublane-aligned")

    jdt = e.args[0][info["jp"]].dtype.name
    pk = next(fresh)
    if info["variant"] == "A":
        s_ax = info["s_ax"]
        s_len = int(e.index_to_dim_length[s_ax])
        sizes[pk] = g * s_len                  # packed J lanes (g*s)
        j_sub = el + pk
        exp_sub = s_ax + pk + i
        exp_shape = (s_len, g * s_len, g * di)
        expand = ((exp_name, "A", g, s_len, di, jdt),)
        n_lead_j = 0
        w_sub = s_ax + el + i
    else:
        sizes[pk] = g                          # the group axis
        j_sub = "".join(lam_j) + el + pk
        exp_sub = pk + i
        exp_shape = (g, g * di)
        expand = ((exp_name, "P", g, di, jdt),)
        n_lead_j = len(lam_j)
        w_sub = "".join(lam_j) + el + i

    t_sub = "".join(m) + i + j
    u_sub = "".join(lam_u) + el + j
    v_sub = "".join(m) + el + i
    out_sub = "".join(chi) + el + i

    def shp(sub):
        return tuple(long_name if c == el else sizes[c] for c in sub)

    rows = []
    for r in range(e.b):
        jarr = e.args[r][info["jp"]]
        rarr = e.args[r][info["rp"]]
        uarr = e.args[r][info["up"]]
        rows.append([array(jarr.name, shp(j_sub), jarr.dtype.name),
                     array(exp_name, exp_shape, jdt),
                     array(rarr.name, shp(t_sub), rarr.dtype.name),
                     array(uarr.name, shp(u_sub), uarr.dtype.name)])
    e2 = batched_einsum(f"{j_sub},{exp_sub},{t_sub},{u_sub}->{out_sub}",
                        rows)
    schedule = ContractionSchedule(
        subscripts=(f"{u_sub},{t_sub}->{v_sub}",
                    f"{j_sub},{exp_sub}->{w_sub}",
                    f"{v_sub},{w_sub}->{out_sub}"),
        result_names=("_lp_v", "_lp_w", "_fe_out"),
        arguments=((EinsumOperand(3), EinsumOperand(2)),
                   (EinsumOperand(0), EinsumOperand(1)),
                   (IntermediateResult("_lp_v"),
                    IntermediateResult("_lp_w"))))

    # the kron perm: the resident's logical axes -> (m..., i, j)
    perm = tuple(rho.index(c) for c in m + (i, j))
    pack_args = {(e.args[r][info["jp"]].name, n_lead_j) for r in range(e.b)}
    pack_args |= {(e.args[r][info["up"]].name, len(lam_u))
                  for r in range(e.b)}
    kron_args = {(e.args[r][info["rp"]].name, perm) for r in range(e.b)}
    extras = dict(lane_pack=int(g),
                  lane_pack_args=tuple(sorted(pack_args)),
                  kron_args=tuple(sorted(kron_args)),
                  lane_pack_expand=expand)
    return program.copy(einsum=e2, schedule=schedule), extras


def rowcat_applicable(einsum) -> bool:
    """``rowcat`` merges batch rows that share every resident operand and
    stream distinct per-row operands with the long axis leading (div and
    curl: J (E, s), u (E, j)); the long axis must lead the output too."""
    e = einsum
    if e.b <= 1:
        return False
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if len(long_letters) != 1:
        return False
    el = long_letters[0]
    if not e.out_idx_set or e.out_idx_set[0] != el:
        return False
    for p, idx in enumerate(e.in_idx_sets):
        names = [e.args[r][p].name for r in range(e.b)]
        if len({e.args[r][p].dtype for r in range(e.b)}) != 1:
            return False
        if el in idx:
            if idx[0] != el or len(set(names)) != e.b:
                return False
        elif len(set(names)) != 1:
            return False
    return True


def rewrite_rowcat(program):
    """Rewrite a rowcat-applicable batched program into one row over a
    b·E-long axis: the streamed operands are stored stacked end to end
    (``descriptor.rowcat_args``), the residents pass through, and the one
    output is the b row outputs stacked the same way.  Traffic and work are
    the same; on the card the b rows become one launch row over b times as
    many elements.  Returns ``(rewritten_program, descriptor_extras)``."""
    from ...contraction_schedule import get_trivial_contraction_schedule
    from ...make_einsum import array, einsum

    e = program.einsum
    if not rowcat_applicable(e):
        raise InvalidParameterError(
            "rowcat needs a batched einsum whose rows share every resident"
            " operand and stream distinct long-leading operands")
    el = long_axis_of(e)
    taken = set(e.arg_to_shape)
    new_args, rowcat_args = [], []
    for p, idx in enumerate(e.in_idx_sets):
        arg0 = e.args[0][p]
        if el in idx:
            k = 0
            while f"cat{p}_{k}" in taken:
                k += 1
            name = f"cat{p}_{k}"
            taken.add(name)
            rowcat_args.append(
                (name, tuple(e.args[r][p].name for r in range(e.b))))
            shape = tuple(f"N{el}_" if ix == el else
                          int(e.index_to_dim_length[ix]) for ix in idx)
            new_args.append(array(name, shape, arg0.dtype.name))
        else:
            new_args.append(array(
                arg0.name,
                tuple(int(e.index_to_dim_length[ix]) for ix in idx),
                arg0.dtype.name))
    subs = (",".join("".join(s) for s in e.in_idx_sets)
            + "->" + "".join(e.out_idx_set))
    e2 = einsum(subs, *new_args)
    extras = dict(rowcat=int(e.b), rowcat_args=tuple(rowcat_args))
    return program.copy(einsum=e2,
                        schedule=get_trivial_contraction_schedule(e2)), extras

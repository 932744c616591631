"""
The end-to-end consumer flow: compile a user's traced function against the
transform archive (the port of ``feinsum_tpu.apply``).

:func:`compile_fn_with_archive` returns a drop-in replacement callable:
every einsum instruction inside *fn* is matched (:mod:`feinsum_tpu_torch.
matching`), looked up in the archive and executed through the archived
schedule on the card's kernels; operand expressions (``2*J + 1``, captured
constants) are evaluated by interpreting the traced graph's backward slice;
instruction signs and scalar factors (:attr:`InsnInfo.scale`) and the sum
structure are re-applied to rebuild *fn*'s outputs.  Outputs computed
outside the grammar (``tanh(einsum)``) replay the graph's slice around the
archive-computed frontier einsum values (the epilogue seam).

Storage-contract note: archived schedules declare stored layouts
(dof-major, ``rowcat``...).  The compiled callable applies them to whatever
the caller passes, which costs a relayout pass per operand per call;
callers chasing the last part should store their state in the schedule's
layout and call ``build_executable`` directly.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .diagnostics import (
    EinsumMatchError,
    InvalidParameterError,
    NoFactInDatabaseError,
    TransformValidationError,
)
from .matching import (
    DEFAULT_LONG_DIM_LENGTH,
    _assemble_matched_einsum,
    _collect_instructions,
    _insn_infos,
    get_attr_value,
    node_dtype,
    node_shape,
)

logger = logging.getLogger(__name__)

#: what moves the candidate ladder and the shootout on to the next
#: candidate: the port refusing an archived schedule (a knob or a route it
#: does not carry, sizes its kernels do not take, a rewritten long axis it
#: cannot map) and a spot check that finds it miscomputes.  Anything else,
#: a kernel that fails to build or to launch above all, propagates.
_REFUSALS = (InvalidParameterError, NoFactInDatabaseError,
             TransformValidationError, EinsumMatchError)


# The H100's rates of the two in-graph relayouts, measured by
# chip_smoke.relayout_rates on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit (twice the bytes over the CUDA-event time at E = 1M, ndof 35): a
# permute copy (E, 35) -> (35, E) ran at 320.4 GB/s, a contiguous torch.cat
# of three (E, 35) tensors at 2853.9 GB/s.  They score archived candidates
# by per-call cost in the consumer path, where layouts are applied per call.
_RETILE_GBPS = 320.4
_STREAM_GBPS = 2853.9


def _per_call_relayout_seconds(program, idx_lengths):
    """Estimated seconds per call that *program*'s storage contract costs
    when it is applied to the caller's tensors: ``arg_layouts``,
    ``out_layout`` and ``pre_layouts`` at the permute-copy rate, ``rowcat``
    stacking and ``dd_pairs`` splitting at the streaming rate.  Lane
    packing costs nothing: (E, d) -> (E/g, g·d) is a view of the caller's
    row-major tensor, where the reference charges it as a retile under the
    TPU's (8, 128) tiling, which has no Hopper meaning.  The kron-expanded
    residents are a few MB built once per call and are not charged; the
    ``rowcat`` and ``dofmajor`` copies of a packed program are, at their
    packed sizes."""
    from .codegen.program import output_dtype
    from .einsum import SizeParam

    e = program.einsum
    desc = program.descriptor
    # build_executable stretches every SizeParam axis by rowcat and divides
    # it by lane_pack
    stretched = {ix: (int(ln) * desc.rowcat // desc.lane_pack if isinstance(
        e.index_to_dim_length.get(ix), SizeParam) else int(ln))
        for ix, ln in idx_lengths.items()}
    sizes = {}
    for row in e.args:
        for arg, idx in zip(row, e.in_idx_sets):
            n = arg.dtype.itemsize
            for ix in idx:
                n *= stretched[ix]
            sizes[arg.name] = n
    retiled = {name for name, perm in desc.arg_layouts_map.items()
               if tuple(perm) != tuple(range(len(perm))) and name in sizes}
    retiled |= {name for name, _nested in desc.pre_layouts if name in sizes}
    secs = sum(2 * sizes[n] for n in retiled) / (_RETILE_GBPS * 1e9)
    ol = desc.out_layout
    if ol is not None and tuple(ol) != tuple(range(len(ol))):
        for r in range(e.b):
            out_n = np.dtype(output_dtype(e, r)).itemsize
            for ix in e.out_idx_set:
                out_n *= stretched[ix]
            secs += 2 * out_n / (_RETILE_GBPS * 1e9)
    for new, _olds in desc.rowcat_args:
        secs += 2 * sizes.get(new, 0) / (_STREAM_GBPS * 1e9)
    if desc.dd_pairs:
        f64 = sum(sizes[a.name] for row in e.args
                  for a in row if a.dtype == np.float64)
        secs += 2 * f64 / (_STREAM_GBPS * 1e9)
    return secs


def _floor_seconds(einsum, idx_lengths, device=None) -> float:
    """The least time of one call at the given sizes: the logical bytes of
    every operand and output over the device's peak memory rate, from
    ``data/device_info.DEV_TO_PEAK_BW`` (an unknown device gets the H100
    SXM's data-sheet 3,350 GB/s)."""
    from .codegen.program import output_dtype
    from .data.device_info import DEV_TO_PEAK_BW, get_device_key

    try:
        key = get_device_key(device)
    except Exception:  # noqa: BLE001 - no card to name
        key = None
    bw = DEV_TO_PEAK_BW.get(key, DEV_TO_PEAK_BW["NVIDIA_H100_80GB_HBM3"])
    total = 0
    seen = set()
    for row in einsum.args:
        for arg, idx in zip(row, einsum.in_idx_sets):
            if arg.name in seen:     # a shared operand is read once
                continue
            seen.add(arg.name)
            n = arg.dtype.itemsize
            for ix in idx:
                n *= idx_lengths[ix]
            total += n
    for r in range(einsum.b):
        n = np.dtype(output_dtype(einsum, r)).itemsize
        for ix in einsum.out_idx_set:
            n *= idx_lengths[ix]
        total += n
    return total / (bw * 1e9)


def _backward_slice_eval(gm, args, targets, bindings=None):
    """Evaluate the graph nodes *targets* from *args* by interpreting only
    the backward slice of nodes that feed them (a ``torch.fx.Interpreter``
    run node by node).  *bindings* (node -> value) are leaves: the slice
    stops at them and their producers never run.  This is how the epilogue
    of a matched function replays around the archive-computed einsum
    frontier values."""
    bindings = bindings or {}
    needed = {t for t in targets if t not in bindings}
    keep = set()
    for node in reversed(list(gm.graph.nodes)):
        if node in needed:
            keep.add(node)
            for iv in node.all_input_nodes:
                if iv not in bindings:
                    needed.add(iv)
    interp = torch.fx.Interpreter(gm)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for node, arg in zip(placeholders, args):
        if node in keep:
            interp.env[node] = arg
    interp.env.update(bindings)
    for node in gm.graph.nodes:
        if node in keep and node.op != "placeholder" \
                and node not in bindings:
            interp.env[node] = interp.run_node(node)
    return {t: interp.env[t] for t in targets}


#: plan memo for :func:`compile_fn_with_archive`: recompiling the same fn
#: (same graph, shapes, constants, options and archive generation) costs a
#: query, builds and a spot check per plan.  Keyed on the traced graph's
#: code text, its placeholders' shapes and dtypes, its constants' bytes, and
#: the archive file's mtime, so recorded facts invalidate cached plans.
_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 32


def _plan_cache_key(gm, long_dim_length, device, db_path, arg_names,
                    validate, spot_check, shootout=None, run_device=None):
    """Cache key for a traced fn, or None when caching would be unsound or
    too costly (a constant over 64 KB would have to be hashed on every
    compile)."""
    from . import sql_utils

    h = hashlib.sha1()
    h.update(gm.code.encode())
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            h.update(repr((node_shape(node), str(node_dtype(node)))).encode())
        elif node.op == "get_attr":
            c = get_attr_value(gm, node.target)
            if not isinstance(c, torch.Tensor):
                return None
            if c.numel() * c.element_size() > 65536:
                return None
            h.update(repr((tuple(c.shape), str(c.dtype))).encode())
            h.update(c.detach().cpu().contiguous().numpy().tobytes())
    try:
        mtime = os.path.getmtime(db_path or sql_utils.DEFAULT_DB)
    except OSError:
        mtime = 0.0
    return (h.hexdigest(), long_dim_length, str(device), str(run_device),
            db_path, tuple(arg_names) if arg_names is not None else None,
            validate, spot_check, shootout, mtime)


def _run_device(example_args) -> torch.device:
    """The device of the example tensors: the compiled callable's plans are
    spot-checked and timed there.  Without a tensor among them, the
    current CUDA card (raises without one)."""
    from .cl_utils import default_device

    devices = {a.device for a in example_args if isinstance(a, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"example arguments lie on several devices:"
                         f" {sorted(map(str, devices))}")
    if devices:
        return next(iter(devices))
    return default_device(None, caller="compile_fn_with_archive")


def compile_fn_with_archive(fn: Callable, example_args: Sequence, *,
                            device=None,
                            db_path: Optional[str] = None,
                            long_dim_length: int = DEFAULT_LONG_DIM_LENGTH,
                            arg_names: Optional[Sequence] = None,
                            validate: bool = False,
                            spot_check: bool = True,
                            shootout: Optional[bool] = None) -> Callable:
    """Return a callable computing exactly what *fn* computes, with every
    einsum instruction executed through its best archived schedule; an
    archive miss serves the plain optimal-path program (one
    ``torch.einsum`` per step), as in the reference.

    The plans run on the device of *example_args*' tensors (the card unless
    the caller passes CPU tensors); *device* names the archive's device key
    (default: that device; a :class:`~feinsum_tpu_torch.cl_utils.FakeDevice`
    reads another device's facts).

    *shootout* (default auto): when the tensors lie on the card and the
    best candidate's modeled per-call time sits well above the physics
    floor at the call's sizes, the top candidates and the plain program are
    each built and timed on the card (CUDA events), and the measured winner
    is served.  ``False`` serves the first candidate that builds; ``True``
    forces the shootout.

    Traced scalar factors (``dt * rhs``, ``rhs / dt``) are re-applied at
    call time; non-grammar epilogues replay around the archive-computed
    einsum values.  Raises :class:`EinsumMatchError` only when *fn* holds
    no matchable einsum.

    Every selected champion is spot-checked once against the numpy oracle
    at a tiny length before its plan is cached (*spot_check*); pass
    ``validate=True`` for a check at up to 2048 elements instead, or
    ``spot_check=False`` to trust the archive.  Repeat calls with the same
    traced graph, shapes, constants and options return the memoized
    callable; recording new facts into the archive invalidates the memo
    (keyed on the archive file's mtime).  ``fn2.plans`` holds ``(row
    InsnInfos, matched einsum, program)`` per plan."""
    from torch.utils._pytree import tree_unflatten

    from . import sql_utils
    from .codegen.program import (
        build_executable,
        generate_program,
        generate_program_with_opt_einsum_schedule,
    )
    from .einsum import SizeParam
    from .measure import (
        apply_layouts,
        evaluate_giga_op_map,
        get_giga_op_map,
        validate_batched_einsum_transform,
    )
    from .ops.layouts import unpack_output

    (traced, labels, sources, _names, out_sums,
     (epi_out, frontier)) = _collect_instructions(
        fn, example_args, arg_names=arg_names, epilogue=True)
    gm = traced.gm
    run_device = _run_device(example_args)
    query_device = device if device is not None else run_device
    cache_key = _plan_cache_key(gm, long_dim_length, device, db_path,
                                arg_names, validate, spot_check, shootout,
                                run_device)
    if cache_key is not None and cache_key in _PLAN_CACHE:
        return _PLAN_CACHE[cache_key]
    infos = _insn_infos(out_sums, sources)
    insns = [(oi, ti, term)
             for oi, terms in enumerate(out_sums)
             for ti, term in enumerate(terms)]
    by_name = {s.name: s for s in sources}

    def concrete_lengths(einsum):
        lengths = {}
        for row in einsum.args:
            for arg, idx_set in zip(row, einsum.in_idx_sets):
                for letter, size in zip(idx_set, by_name[arg.name].shape):
                    lengths[letter] = int(size)
        return lengths

    def program_lengths(program, matched, matched_lengths):
        """Concrete index -> length for the (possibly rewritten) program:
        fixed axes from the program's own einsum, parametric axes from the
        user's sizes (by letter, else the unique long axis)."""
        user_long = {ix: matched_lengths[ix]
                     for ix, ln in matched.index_to_dim_length.items()
                     if isinstance(ln, SizeParam)}
        out = {}
        for ix, ln in program.einsum.index_to_dim_length.items():
            if isinstance(ln, SizeParam):
                if ix in user_long:
                    out[ix] = user_long[ix]
                elif len(user_long) == 1:
                    (out[ix],) = user_long.values()
                else:
                    raise EinsumMatchError(
                        f"cannot map rewritten long axis {ix!r} onto the"
                        f" matched einsum's {sorted(user_long)}")
            else:
                out[ix] = int(ln)
        return out

    def make_plan(row_infos, einsum):
        lengths = concrete_lengths(einsum)
        logical = tuple(lengths[ix] for ix in einsum.out_idx_set)
        # the candidate ladder: a champion that does not fit this call
        # (sizes, a route the port refuses) falls through to the
        # runner-ups, then to the plain program
        try:
            qs = sql_utils.query(einsum, query_device, db_path=db_path,
                                 err_if_no_results=False)
        except NoFactInDatabaseError:
            qs = []
        candidates = sql_utils.aggregate_reconfirmations(qs)
        long_val = max((lengths[ix] for ix, ln
                        in einsum.index_to_dim_length.items()
                        if isinstance(ln, SizeParam)),
                       default=max(lengths.values(), default=1))
        gops = None
        scored = []
        # rank by estimated per-call cost: the archived kernel time at this
        # call's sizes plus the relayout its storage contract costs here
        for q in candidates:
            est = float("inf")
            try:
                rate = float(q.total_giga_op_rate)
                if rate > 0:
                    if gops is None:
                        gops = sum(
                            float(v) for v in evaluate_giga_op_map(
                                get_giga_op_map(einsum), long_val).values())
                    prg = q.transform(generate_program(einsum))
                    est = gops / rate + _per_call_relayout_seconds(
                        prg, program_lengths(prg, einsum, lengths))
            except _REFUSALS:      # unrankable: kept, ranked last
                pass
            scored.append((est, q.transform))
        scored.sort(key=lambda t: t[0])

        def build_runner(program):
            """What the compiled callable runs per call, and what the
            shootout times: the storage contract applied to the caller's
            tensors, the kernel, the rowcat rows split, the outputs
            unpacked."""
            exe = build_executable(
                program, index_to_length=program_lengths(
                    program, einsum, lengths))
            rowcat = program.descriptor.rowcat > 1

            def runner(arrays):
                results = exe(apply_layouts(program, arrays))
                if rowcat:
                    return list(unpack_output(program, results[0], logical))
                return [unpack_output(program, res, logical)
                        for res in results]
            return runner

        def try_build(transform):
            if transform is not None:
                if validate or spot_check:
                    # an archived row that builds but miscomputes must not
                    # be served: check it once per cached plan
                    validate_batched_einsum_transform(
                        einsum, transform, device=run_device,
                        long_dim_length=min(2048 if validate else 128,
                                            max(lengths.values())))
                program = transform(generate_program(einsum))
            else:
                program = generate_program_with_opt_einsum_schedule(einsum)
            return program, build_runner(program)

        best_est = scored[0][0] if scored else float("inf")
        run_shootout = shootout
        if run_shootout is None:
            floor = _floor_seconds(einsum, lengths, query_device)
            run_shootout = (run_device.type == "cuda"
                            and best_est > 1.5 * floor)

        if not run_shootout:
            for transform in [t for _est, t in scored[:3]]:
                try:
                    program, runner = try_build(transform)
                    return (tuple(row_infos), einsum, program, runner)
                except _REFUSALS as ex:
                    logger.info("archived candidate refused (%s: %s)",
                                type(ex).__name__, str(ex)[:120])
            program, runner = try_build(None)
            return (tuple(row_infos), einsum, program, runner)

        # the shootout: the top archived finalists and the plain program,
        # each timed paying its full per-call cost
        built = []
        for transform in [t for _est, t in scored[:2]]:
            try:
                built.append((transform,) + try_build(transform))
            except _REFUSALS as ex:
                logger.info("finalist refused (%s: %s)",
                            type(ex).__name__, str(ex)[:120])
        built.append((None,) + try_build(None))
        if len(built) == 1:
            _t, program, runner = built[0]
            return (tuple(row_infos), einsum, program, runner)
        from . import measure
        sample = measure.generate_input_arrays(
            einsum, long_dim_length=long_val, device=run_device)
        timed = []
        for transform, program, runner in built:
            dt = measure._timeit_in_graph(runner, sample,
                                          min_work_seconds=0.2)
            timed.append((dt, transform, program, runner))
            logger.info("shootout: %s measured %.0f us/call end-to-end",
                        program.descriptor.backend, dt * 1e6)
        timed.sort(key=lambda t: t[0])
        _dt, _tr, program, runner = timed[0]
        return (tuple(row_infos), einsum, program, runner)

    indiv = []
    for info, insn in zip(infos, insns):
        einsum, _nm = _assemble_matched_einsum(
            labels, sources, [insn], long_dim_length=long_dim_length)
        indiv.append((info, insn, einsum))

    # group structurally identical instructions into batched einsums (a
    # componentwise div then hits the archive's b-row champions); the trial
    # assembly runs on a copy of the union-find
    def sig(einsum):
        return (einsum.get_subscripts(),
                tuple(str(a.shape) + a.dtype.name
                      for row in einsum.args for a in row))

    groups: dict = {}
    for item in indiv:
        groups.setdefault(sig(item[2]), []).append(item)

    plans = []
    for items in groups.values():
        if len(items) > 1:
            trial = labels.copy()
            try:
                be, _nm = _assemble_matched_einsum(
                    trial, sources, [insn for _i, insn, _e in items],
                    long_dim_length=long_dim_length)
            except EinsumMatchError:
                be = None
            if be is not None:
                plans.append(make_plan([i for i, _s, _e in items], be))
                continue
        for info, _insn, einsum in items:
            plans.append(make_plan([info], einsum))

    expr_vars = [s.var for s in sources if not isinstance(s.origin, int)]
    scale_vars = [v for row_infos, _e, _p, _r in plans
                  for info in row_infos for v in info.scale_vars]
    out_dtypes = [node_dtype(leaf) if isinstance(leaf, torch.fx.Node)
                  else None for leaf in traced.out_leaves]

    def fn2(*args):
        targets = expr_vars + [v for v in scale_vars if v not in expr_vars]
        expr_vals = _backward_slice_eval(gm, args, targets) if targets \
            else {}
        name_to_val = {}
        for s in sources:
            if isinstance(s.origin, int):
                name_to_val[s.name] = args[s.origin]
            else:
                name_to_val[s.name] = expr_vals[s.var]
        acc = {}
        for row_infos, einsum, _program, runner in plans:
            results = runner({name: name_to_val[name]
                              for name in einsum.arg_to_shape})
            for info, out in zip(row_infos, results):
                if info.scale != 1.0:
                    out = out * info.scale
                pows = info.scale_var_pows or (1,) * len(info.scale_vars)
                for v, p in zip(info.scale_vars, pows):
                    s = expr_vals[v]
                    if isinstance(s, torch.Tensor):
                        s = s.to(out.dtype)
                    out = out * s if p > 0 else out / s
                k = info.out_index
                acc[k] = out if k not in acc else acc[k] + out
        epi_vals = {}
        if epi_out:
            bindings = {node: acc[slot].to(node_dtype(node))
                        for node, slot in frontier.items()}
            targets = [v for kind, v in epi_out.values() if kind == "var"]
            if targets:
                epi_vals = _backward_slice_eval(gm, args, targets,
                                                bindings=bindings)
        flat = []
        for k, dtype in enumerate(out_dtypes):
            if k in epi_out:
                kind, v = epi_out[k]
                val = v if kind == "lit" else epi_vals[v]
            else:
                val = acc[k]
            if dtype is not None and isinstance(val, torch.Tensor):
                val = val.to(dtype)
            flat.append(val)
        return tree_unflatten(flat, traced.out_spec)

    # introspection: (row InsnInfos, matched einsum, program) per plan;
    # descriptor.backend == "pallas" marks an archive hit on the fused
    # kernels (the miss is the plain program), and a plan with several
    # InsnInfos batched those instructions into one b-row program
    fn2.plans = tuple((row_infos, einsum, program)
                      for row_infos, einsum, program, _r in plans)
    if cache_key is not None:
        while len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE[cache_key] = fn2
    return fn2

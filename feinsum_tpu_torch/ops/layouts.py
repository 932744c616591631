"""
Storage layouts of streamed operands, and the grouped layouts of a
rewritten program (:func:`apply_nested_layout`).

``dofmajor_layouts`` computes the argument and output permutations that
rotate every parametric (long) axis to the back.  On the GPU that puts the
element axis at stride 1, so neighbouring threads, which own neighbouring
elements, read neighbouring addresses.  The stored layout is the memory
layout: :func:`feinsum_tpu_torch.measure.apply_layouts` materialises each
permutation (``.contiguous()``), where a bare ``permute`` would only make a
strided view.
"""

from __future__ import annotations

import numpy as np

from ..einsum import BatchedEinsum, SizeParam


def dofmajor_layouts(einsum: BatchedEinsum):
    """(arg_layouts, out_layout) rotating long axes to the trailing position
    for every operand/output that carries one; resident operands of rank > 2
    keep their two largest axes trailing (the same rule as
    ``feinsum_tpu.ops.layouts.dofmajor_layouts``)."""
    arg_idx = {}
    for row in einsum.args:
        for arg, idx_set in zip(row, einsum.in_idx_sets):
            arg_idx[arg.name] = idx_set
    long_letters = {ix for ix, ln in einsum.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)}

    def rotate(idx_set):
        perm = [i for i, ix in enumerate(idx_set) if ix not in long_letters]
        perm += [i for i, ix in enumerate(idx_set) if ix in long_letters]
        return tuple(perm)

    layouts = []
    for name, idx_set in arg_idx.items():
        if (set(idx_set) & long_letters) and idx_set \
                and idx_set[-1] not in long_letters:
            layouts.append((name, rotate(idx_set)))
        elif not (set(idx_set) & long_letters) and len(idx_set) > 2:
            sizes = {ix: int(einsum.index_to_dim_length[ix])
                     for ix in idx_set}
            biggest = sorted(range(len(idx_set)),
                             key=lambda p: sizes[idx_set[p]])[-2:]
            big_sorted = sorted(biggest)      # keep relative order
            perm = tuple([p for p in range(len(idx_set))
                          if p not in biggest] + big_sorted)
            if perm != tuple(range(len(idx_set))):
                layouts.append((name, perm))
    out = tuple(einsum.out_idx_set)
    out_perm = None
    if out and out[-1] not in long_letters and (set(out) & long_letters):
        out_perm = rotate(out)
    return tuple(layouts), out_perm


def stored_arg_layouts(program) -> dict:
    """arg name -> stored (post arg_layouts permutation) index letters."""
    e = program.einsum
    layouts = program.descriptor.arg_layouts_map
    out = {}
    for row in e.args:
        for arg, idx_set in zip(row, e.in_idx_sets):
            perm = layouts.get(arg.name)
            out[arg.name] = (tuple(idx_set[p] for p in perm)
                             if perm is not None else tuple(idx_set))
    return out


def stored_out_letters(program) -> tuple:
    """The output's stored index letters (after ``out_layout``)."""
    e = program.einsum
    if program.descriptor.out_layout is None:
        return tuple(e.out_idx_set)
    return tuple(e.out_idx_set[p] for p in program.descriptor.out_layout)


def apply_nested_layout(arr, nested):
    """Apply a grouped storage layout (``descriptor.pre_layouts`` and
    ``pre_out_layout``): *nested* is a tuple of tuples of source-axis
    positions; the stored array is *arr* transposed to the flattened order
    and reshaped to one merged axis per group, materialised (a C-contiguous
    numpy array or tensor).  This is how a high-rank operand of a tensor
    contraction becomes the GEMM-natural 2D matrix of a TC-as-GEMM
    rewrite."""
    flat = tuple(int(p) for g in nested for p in g)
    if sorted(flat) != list(range(arr.ndim)):
        raise ValueError(
            f"nested layout {nested!r} is not a grouping of {arr.ndim} axes")
    shape = []
    k = 0
    for g in nested:
        n = 1
        for _ in g:
            n *= arr.shape[flat[k]]
            k += 1
        shape.append(n)
    if isinstance(arr, np.ndarray):
        return np.ascontiguousarray(arr.transpose(flat)).reshape(shape)
    return arr.permute(*flat).contiguous().reshape(shape)


def unpack_output(program, arr, logical_shape):
    """Invert the descriptor's output storage contract: stored row output
    tensor ``arr`` -> the logical einsum output of shape *logical_shape*.
    The forward chain is ``pre_out_layout`` -> ``lane_pack`` ->
    ``out_layout`` -> dd pairs (the reference's order), so this undoes them
    in reverse: a ``dd_pairs`` output's (2, ...) float32 pairs are
    recombined into float64 (a new tensor), the ``out_layout`` permutation
    is undone (a view), a lane-packed (lead..., E/g, g·d) output becomes
    (lead..., E, d) (the vecmat's (E/g, g) becomes (E,)), and a
    ``pre_out_layout`` grouping is split back into its source axes and
    transposed to the logical order.  A ``rowcat`` = b program's one
    output holds the b rows' outputs end to end along the leading long
    axis: it comes back as a (b, *logical_shape) view, row r at ``[r]``.
    The other output contracts are refused by ``build_executable``."""
    desc = program.descriptor
    if desc.dd_pairs:
        from .dd_emitter import combine_pairs
        arr = combine_pairs(arr)
    if desc.out_layout is not None:
        arr = arr.permute(*(int(i) for i in np.argsort(desc.out_layout)))
    if desc.lane_pack > 1:
        g = desc.lane_pack
        arr = arr.reshape(*arr.shape[:-2], arr.shape[-2] * g,
                          arr.shape[-1] // g)
        if len(logical_shape) == 1:
            arr = arr.reshape(-1)
    if desc.pre_out_layout is not None:
        flat = [int(p) for g in desc.pre_out_layout for p in g]
        arr = arr.reshape(tuple(int(logical_shape[p]) for p in flat))
        arr = arr.permute(*(int(i) for i in np.argsort(flat)))
    if desc.rowcat > 1:
        logical_shape = (desc.rowcat, *logical_shape)
        arr = arr.reshape(logical_shape)
    if tuple(arr.shape) != tuple(logical_shape):
        raise ValueError(
            f"unpack_output: inverted stored shape {tuple(arr.shape)} does"
            f" not match the logical output {tuple(logical_shape)}")
    return arr

"""
Canonicalization of batched einsums: the archive key.

Two batched einsums are isomorphic iff one is produced from the other by
renaming index letters, renaming argument names, permuting batch rows,
permuting operand positions uniformly across rows, and renaming
:class:`SizeParam` names; :func:`canonicalize_einsum` maps every member of an
isomorphism class to the same representative.  The algorithm and its output
are those of ``feinsum_tpu.canonicalization``, so both packages key an
einsum alike and read each other's archives.

The einsum is encoded as a colored digraph whose vertices are entities
(indices, args, rows, operand positions, per-position axes, size params) and
whose colors carry every name-free datum (dtype, concrete axis lengths,
output position, axis ordinal).  Canonical labeling (the C++ core
``native/canon.cpp``, or the same algorithm in ``native/canon_py.py`` when
``g++`` is missing) orders each entity class; canonical names are assigned by
that order and the einsum is rebuilt by renaming.
"""

from __future__ import annotations

import functools

import numpy as np

from .einsum import BatchedEinsum, FreeAxis, SizeParam

_CANON_INDEX_LETTERS = "ijklmnopqrstuvwxyzabcdefgh"


class _EinsumGraph:
    """Colored digraph induced by a :class:`BatchedEinsum`.

    Vertex classes and their color features (all name-free, hence invariant
    under the isomorphism moves):

      * index:      ("idx_free", output_position) or ("idx_sum", length-or-"p")
      * size param: ("param",)
      * arg:        ("arg", dtype.kind, dtype.itemsize, dtype.name)
      * row:        ("row",)
      * position:   ("pos",)
      * axis(j,a):  ("axis", a)
      * cell(i,j):  ("cell",)

    Edges: axis(j,a) -> pos(j); axis(j,a) -> index; row(i) -> cell(i,j);
    pos(j) -> cell(i,j); cell(i,j) -> arg; index -> param (parametric axes).
    """

    def __init__(self, einsum: BatchedEinsum) -> None:
        self.einsum = einsum
        features: list = []
        self.node_entity: list = []   # parallel: ("idx", name) etc.
        edges: list = []

        def add(entity, feature) -> int:
            node = len(features)
            features.append(feature)
            self.node_entity.append(entity)
            return node

        e = einsum
        idx_node: dict = {}
        param_node: dict = {}
        acc = e.index_to_access_descr

        for ix in sorted(e.all_indices):
            length = e.index_to_dim_length[ix]
            a = acc[ix]
            if isinstance(a, FreeAxis):
                feat = ("idx_free", a.output_index,
                        "p" if isinstance(length, SizeParam) else int(length))
            else:
                feat = ("idx_sum",
                        "p" if isinstance(length, SizeParam) else int(length))
            idx_node[ix] = add(("idx", ix), feat)
            if isinstance(length, SizeParam):
                if length.name not in param_node:
                    param_node[length.name] = add(("param", length.name),
                                                  ("param",))
                edges.append((idx_node[ix], param_node[length.name]))

        arg_node: dict = {}
        for name in sorted(e.all_args):
            dt = e.arg_to_dtype[name]
            arg_node[name] = add(("arg", name),
                                 ("arg", dt.kind, dt.itemsize, dt.name))

        pos_node = [add(("pos", j), ("pos",)) for j in range(e.n)]
        for j, idx_set in enumerate(e.in_idx_sets):
            for a, ix in enumerate(idx_set):
                ax = add(("axis", j, a), ("axis", a))
                edges.append((ax, pos_node[j]))
                edges.append((ax, idx_node[ix]))

        row_node = [add(("row", i), ("row",)) for i in range(e.b)]
        for i, row in enumerate(e.args):
            for j, arg in enumerate(row):
                cell = add(("cell", i, j), ("cell",))
                edges.append((row_node[i], cell))
                edges.append((pos_node[j], cell))
                edges.append((cell, arg_node[arg.name]))

        # features -> invariant int colors (rank within this einsum's feature set)
        distinct = sorted(set(features), key=repr)
        feat_to_color = {f: c for c, f in enumerate(distinct)}
        self.colors = [feat_to_color[f] for f in features]
        self.edges = edges
        self.n = len(features)


@functools.cache
def _get_native():
    """The native labeling core, or ``None`` without ``g++``."""
    from .native.build import load_canon
    return load_canon()


def _canonical_labeling(n: int, colors, edges):
    """perm[v] = canonical position of vertex v."""
    lib = _get_native()
    if lib is not None:
        import ctypes
        c_colors = np.ascontiguousarray(colors, dtype=np.int32)
        if edges:
            c_edges = np.ascontiguousarray(edges, dtype=np.int32).reshape(-1)
        else:
            c_edges = np.zeros(0, dtype=np.int32)
        perm = np.zeros(n, dtype=np.int32)
        rc = lib.fe_canonical_labeling(
            n,
            c_colors.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(edges),
            c_edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        if rc == 0:
            return perm.tolist()
        if rc == -2:
            raise RuntimeError(
                "canonical labeling search budget exceeded; the einsum's"
                " symmetry group is too large")
        raise RuntimeError(f"fe_canonical_labeling failed with code {rc}")
    from .native.canon_py import canonical_labeling_py
    return canonical_labeling_py(n, list(colors), list(edges))


def _canonical_renaming(einsum: BatchedEinsum):
    """Compute (sigma_i, sigma_j, sigma_idx, sigma_arg, sigma_param) that maps
    *einsum* to its canonical representative."""
    g = _EinsumGraph(einsum)
    perm = _canonical_labeling(g.n, g.colors, g.edges)

    rows, poss, idxs, args, params = [], [], [], [], []
    for node, ent in enumerate(g.node_entity):
        kind = ent[0]
        if kind == "row":
            rows.append((perm[node], ent[1]))
        elif kind == "pos":
            poss.append((perm[node], ent[1]))
        elif kind == "idx":
            idxs.append((perm[node], ent[1]))
        elif kind == "arg":
            args.append((perm[node], ent[1]))
        elif kind == "param":
            params.append((perm[node], ent[1]))

    sigma_i = [i for _, i in sorted(rows)]         # new row r = old row sigma_i[r]
    sigma_j = [j for _, j in sorted(poss)]
    idx_order = [ix for _, ix in sorted(idxs)]
    if len(idx_order) > len(_CANON_INDEX_LETTERS):
        raise ValueError("Cannot canonicalize an einsum with more than 26"
                         " indices.")
    sigma_idx = {ix: _CANON_INDEX_LETTERS[k] for k, ix in enumerate(idx_order)}
    sigma_arg = {name: f"arg_{k}"
                 for k, (_, name) in enumerate(sorted(args))}
    sigma_param = {name: f"N_{k}"
                   for k, (_, name) in enumerate(sorted(params))}
    return sigma_i, sigma_j, sigma_idx, sigma_arg, sigma_param


def _apply_renaming(einsum: BatchedEinsum, sigma_i, sigma_j, sigma_idx,
                    sigma_arg, sigma_param) -> BatchedEinsum:
    def rename_shape(shape):
        return tuple(
            SizeParam(sigma_param[s.name]) if isinstance(s, SizeParam) else s
            for s in shape)

    out_idx = tuple(sigma_idx[ix] for ix in einsum.out_idx_set)
    in_idx_sets = tuple(
        tuple(sigma_idx[ix] for ix in einsum.in_idx_sets[j]) for j in sigma_j)
    args = tuple(
        tuple(
            einsum.args[i][j].copy(
                name=sigma_arg[einsum.args[i][j].name],
                shape=rename_shape(einsum.args[i][j].shape))
            for j in sigma_j)
        for i in sigma_i)
    return BatchedEinsum(out_idx, in_idx_sets, args)


def canonicalize_einsum(einsum: BatchedEinsum) -> BatchedEinsum:
    """Return the canonical representative of *einsum*'s isomorphism class
    (canonical arg names ``arg_0, ...``, indices ``i, j, k, ...``, size params
    ``N_0, ...``)."""
    return _apply_renaming(einsum, *_canonical_renaming(einsum))


def get_substitution_mapping_between_isomorphic_batched_einsums(
        einsum1: BatchedEinsum, einsum2: BatchedEinsum) -> dict:
    """Return a name map (indices, args, size params) sending *einsum1*'s
    entities onto *einsum2*'s, provided they are isomorphic; raises
    ``ValueError`` otherwise."""
    r1 = _canonical_renaming(einsum1)
    r2 = _canonical_renaming(einsum2)
    if _apply_renaming(einsum1, *r1) != _apply_renaming(einsum2, *r2):
        raise ValueError("The two batched einsums are not isomorphic.")
    _, _, idx1, arg1, par1 = r1
    _, _, idx2, arg2, par2 = r2
    inv_idx2 = {v: k for k, v in idx2.items()}
    inv_arg2 = {v: k for k, v in arg2.items()}
    inv_par2 = {v: k for k, v in par2.items()}
    subst = {k: inv_idx2[v] for k, v in idx1.items()}
    subst.update({k: inv_arg2[v] for k, v in arg1.items()})
    subst.update({k: inv_par2[v] for k, v in par1.items()})
    return subst


def are_einsums_isomorphic(einsum1: BatchedEinsum,
                           einsum2: BatchedEinsum) -> bool:
    return canonicalize_einsum(einsum1) == canonicalize_einsum(einsum2)


def canonical_operand_positions(einsum: BatchedEinsum) -> tuple:
    """The operand-position permutation ``sigma_j`` of the canonical
    renaming: canonical operand position ``p`` holds *einsum*'s operand
    position ``sigma_j[p]``.

    Position-sensitive transform params are archived relative to canonical
    operand positions (:func:`feinsum_tpu_torch.tuning.autotune`
    canonicalizes before measuring), while archive replay applies the bound
    transform to the *user-ordered* program; such transforms route their
    params through this map.  Within-operand axis order is preserved by
    canonicalization; only the operand-position order can differ (e.g.
    ``dca,bd->abc`` canonicalizes to ``jl,lki->ijk`` with sigma_j =
    (1, 0))."""
    return tuple(_canonical_renaming(einsum)[1])

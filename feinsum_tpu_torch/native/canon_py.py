"""
Pure-Python fallback for the C++ canonical-labeling core (same algorithm,
same contract as ``canon.cpp``): McKay-style individualization-refinement on a
vertex-colored digraph with automorphism orbit pruning.  Used only when the
native build is unavailable; adequate for small graphs.
"""

from __future__ import annotations

from collections import deque


class _UF:
    def __init__(self, n: int) -> None:
        self.p = list(range(n))

    def find(self, x: int) -> int:
        p = self.p
        while p[x] != x:
            p[x] = p[p[x]]
            x = p[x]
        return x

    def unite(self, a: int, b: int) -> None:
        a, b = self.find(a), self.find(b)
        if a != b:
            if a > b:
                a, b = b, a
            self.p[b] = a


def canonical_labeling_py(n: int, colors, edges) -> list:
    """Return perm with perm[v] = canonical position of v."""
    if n == 0:
        return []
    out_adj = [[] for _ in range(n)]
    in_adj = [[] for _ in range(n)]
    for (u, v) in edges:
        out_adj[u].append(v)
        in_adj[v].append(u)

    # partition state: lab, pos, cstart, clen (see canon.cpp)
    lab = sorted(range(n), key=lambda v: (colors[v], v))
    pos = [0] * n
    for i, v in enumerate(lab):
        pos[v] = i
    cstart = [0] * n
    clen = [0] * n
    i = 0
    while i < n:
        j = i
        while j < n and colors[lab[j]] == colors[lab[i]]:
            j += 1
        clen[i] = j - i
        for k in range(i, j):
            cstart[k] = i
        i = j

    state = {"first": None, "best": None, "gens": [], "base": []}

    def refine(lab, pos, cstart, clen, wl):
        while wl:
            s = wl.popleft()
            L = clen[s]
            cnt = {}
            for ii in range(s, s + L):
                u = lab[ii]
                for v in in_adj[u]:
                    c = cnt.get(v)
                    cnt[v] = (c[0] + 1, c[1]) if c else (1, 0)
                for v in out_adj[u]:
                    c = cnt.get(v)
                    cnt[v] = (c[0], c[1] + 1) if c else (0, 1)
            affected = sorted({cstart[pos[v]] for v in cnt if clen[cstart[pos[v]]] > 1})
            for c0 in affected:
                cl = clen[c0]
                members = lab[c0:c0 + cl]
                keyed = sorted(
                    ((cnt.get(v, (0, 0)), k, v) for k, v in enumerate(members)),
                    key=lambda t: (t[0], t[1]))
                if keyed[0][0] == keyed[-1][0]:
                    continue
                for off, (_, _, v) in enumerate(keyed):
                    lab[c0 + off] = v
                    pos[v] = c0 + off
                ii = 0
                while ii < cl:
                    jj = ii
                    while jj < cl and keyed[jj][0] == keyed[ii][0]:
                        jj += 1
                    ns, nl = c0 + ii, jj - ii
                    clen[ns] = nl
                    for k in range(ns, ns + nl):
                        cstart[k] = ns
                    wl.append(ns)
                    ii = jj

    def leaf_rep(lab, pos):
        rep_colors = tuple(colors[v] for v in lab)
        rep_edges = tuple(sorted(pos[u] * n + pos[v] for (u, v) in edges))
        return (rep_colors, rep_edges)

    NO_JUMP = 1 << 30

    def _common_prefix(a, b):
        k = 0
        while k < len(a) and k < len(b) and a[k] == b[k]:
            k += 1
        return k

    def handle_leaf(lab, pos):
        # returns a backjump level or NO_JUMP (see canon.cpp handle_leaf)
        rep = leaf_rep(lab, pos)
        base = state["base"]
        if state["first"] is None:
            state["first"] = (rep, list(lab), list(pos), list(base))
            state["best"] = (rep, list(lab), list(pos), list(base))
            return NO_JUMP
        for key in ("first", "best"):
            ref_rep, ref_lab, _, ref_base = state[key]
            if rep == ref_rep:
                gamma = [ref_lab[pos[v]] for v in range(n)]
                if any(gamma[v] != v for v in range(n)):
                    state["gens"].append(gamma)
                return _common_prefix(base, ref_base)
        if rep > state["best"][0]:
            state["best"] = (rep, list(lab), list(pos), list(base))
        return NO_JUMP

    def search(lab, pos, cstart, clen):
        tc = -1
        s = 0
        while s < n:
            if clen[s] > 1:
                tc = s
                break
            s += clen[s]
        if tc < 0:
            return handle_leaf(lab, pos)
        candidates = lab[tc:tc + clen[tc]]
        uf = _UF(n)
        cursor = 0
        explored: list = []
        base = state["base"]
        my_level = len(base)
        for v in candidates:
            if explored:
                # lazy generator folding; cell-restricted unions (see canon.cpp)
                gens = state["gens"]
                while cursor < len(gens):
                    gamma = gens[cursor]
                    cursor += 1
                    if all(gamma[b] == b for b in reversed(base)):
                        for u in candidates:
                            if gamma[u] != u:
                                uf.unite(u, gamma[u])
                if any(uf.find(u) == uf.find(v) for u in explored):
                    continue
            explored.append(v)
            lab2, pos2 = list(lab), list(pos)
            cstart2, clen2 = list(cstart), list(clen)
            s = cstart2[pos2[v]]
            L = clen2[s]
            pv = pos2[v]
            lab2[s], lab2[pv] = lab2[pv], lab2[s]
            pos2[lab2[pv]] = pv
            pos2[v] = s
            clen2[s] = 1
            cstart2[s] = s
            if L > 1:
                clen2[s + 1] = L - 1
                for k in range(s + 1, s + L):
                    cstart2[k] = s + 1
            wl = deque([s] + ([s + 1] if L > 1 else []))
            refine(lab2, pos2, cstart2, clen2, wl)
            base.append(v)
            jump = search(lab2, pos2, cstart2, clen2)
            base.pop()
            if jump < my_level:
                return jump  # propagate backjump past this node
        return NO_JUMP

    refine(lab, pos, cstart, clen, deque(
        s for s in range(n) if cstart[s] == s))
    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10 * n + 1000))
    try:
        search(lab, pos, cstart, clen)
    finally:
        sys.setrecursionlimit(old_limit)
    return list(state["best"][2])

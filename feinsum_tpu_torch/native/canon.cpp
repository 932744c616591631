// First-party canonical labeling of vertex-colored directed graphs.
//
// Plays the role pybliss/bliss plays in the reference (canonicalization of the
// einsum-induced colored digraph, reference feinsum canonicalization.py:358-381)
// with the same contract: (edges, colors) -> permutation-to-canonical-form.
//
// Algorithm: McKay-style individualization-refinement.
//   * equitable partition refinement on a vertex-colored digraph, splitting by
//     (#out-edges into splitter, #in-edges into splitter) signatures;
//   * backtracking over the first non-singleton cell;
//   * canonical form = lexicographically greatest (color-sequence, edge-list)
//     over all explored leaves;
//   * automorphism pruning: leaves whose representation equals the first/best
//     leaf yield automorphism generators; at each tree node candidates are
//     pruned modulo the orbits of the subgroup generated by generators that
//     fix the node's base pointwise (sound subset of the full orbit pruning).
//
// C ABI only (loaded via ctypes), no Python.h dependency.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <deque>
#include <vector>

namespace {

struct Graph {
    int n;
    // CSR adjacency
    std::vector<int> out_off, out_nbr;
    std::vector<int> in_off, in_nbr;
    std::vector<int> colors;
};

struct Partition {
    // lab: vertices in partition order; pos: inverse of lab.
    // cstart[p]: start position of the cell containing position p.
    // clen[s]: length of the cell starting at position s (valid at starts).
    std::vector<int> lab, pos, cstart, clen;
};

struct UnionFind {
    std::vector<int> parent;
    explicit UnionFind(int n) : parent(n) {
        for (int i = 0; i < n; ++i) parent[i] = i;
    }
    int find(int x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    }
    void unite(int a, int b) {
        a = find(a); b = find(b);
        if (a != b) parent[a < b ? b : a] = (a < b ? a : b);
    }
};

struct Searcher {
    const Graph& g;
    int n;
    long long node_budget;
    bool budget_exceeded = false;

    // scratch for refinement signatures
    std::vector<int> cnt_out, cnt_in;
    std::vector<int> touched;
    std::vector<char> is_touched;

    // leaf bookkeeping
    bool have_first = false;
    std::vector<int> first_pos, first_lab, first_base;
    std::vector<long long> first_rep;
    std::vector<int> best_pos, best_lab, best_base;
    std::vector<long long> best_rep;

    static constexpr int NO_JUMP = 1 << 30;

    // automorphism generators (gens[k][v] = image of v)
    std::vector<std::vector<int>> gens;
    std::vector<int> base;  // individualized vertices along current path

    explicit Searcher(const Graph& graph, long long budget)
        : g(graph), n(graph.n), node_budget(budget),
          cnt_out(graph.n, 0), cnt_in(graph.n, 0),
          is_touched(graph.n, 0) {}

    // ---- refinement -----------------------------------------------------

    void refine(Partition& P, std::deque<int>& wl) {
        std::vector<int> affected;
        std::vector<char> cell_marked(n, 0);
        while (!wl.empty()) {
            int s = wl.front();
            wl.pop_front();
            int L = P.clen[s];
            // accumulate signatures w.r.t. splitter cell lab[s..s+L)
            touched.clear();
            for (int i = s; i < s + L; ++i) {
                int u = P.lab[i];
                for (int k = g.in_off[u]; k < g.in_off[u + 1]; ++k) {
                    int v = g.in_nbr[k];  // edge v -> u (u in splitter)
                    if (!is_touched[v]) { is_touched[v] = 1; touched.push_back(v); }
                    ++cnt_out[v];
                }
                for (int k = g.out_off[u]; k < g.out_off[u + 1]; ++k) {
                    int v = g.out_nbr[k];  // edge u -> v
                    if (!is_touched[v]) { is_touched[v] = 1; touched.push_back(v); }
                    ++cnt_in[v];
                }
            }
            // collect affected cells
            affected.clear();
            for (int v : touched) {
                int c0 = P.cstart[P.pos[v]];
                if (!cell_marked[c0] && P.clen[c0] > 1) {
                    cell_marked[c0] = 1;
                    affected.push_back(c0);
                }
            }
            std::sort(affected.begin(), affected.end());
            for (int c0 : affected) {
                cell_marked[c0] = 0;
                split_cell(P, c0, wl);
            }
            for (int v : touched) { cnt_out[v] = 0; cnt_in[v] = 0; is_touched[v] = 0; }
        }
    }

    void split_cell(Partition& P, int c0, std::deque<int>& wl) {
        int cl = P.clen[c0];
        // gather (sig_out, sig_in, original order, vertex)
        struct Item { int so, si, ord, v; };
        std::vector<Item> items(cl);
        bool uniform = true;
        for (int i = 0; i < cl; ++i) {
            int v = P.lab[c0 + i];
            items[i] = {cnt_out[v], cnt_in[v], i, v};
            if (items[i].so != items[0].so || items[i].si != items[0].si)
                uniform = false;
        }
        if (uniform) return;
        std::stable_sort(items.begin(), items.end(),
                         [](const Item& a, const Item& b) {
                             if (a.so != b.so) return a.so < b.so;
                             return a.si < b.si;
                         });
        // rewrite lab and cell structure
        int start = c0;
        for (int i = 0; i < cl; ++i) {
            P.lab[c0 + i] = items[i].v;
            P.pos[items[i].v] = c0 + i;
        }
        int i = 0;
        while (i < cl) {
            int j = i;
            while (j < cl && items[j].so == items[i].so && items[j].si == items[i].si)
                ++j;
            int ns = c0 + i, nl = j - i;
            P.clen[ns] = nl;
            for (int k = ns; k < ns + nl; ++k) P.cstart[k] = ns;
            wl.push_back(ns);
            i = j;
        }
        (void)start;
    }

    // ---- leaves ---------------------------------------------------------

    void leaf_rep(const Partition& P, std::vector<long long>& rep) {
        rep.clear();
        rep.reserve(n + (g.out_nbr.size()));
        for (int i = 0; i < n; ++i) rep.push_back(g.colors[P.lab[i]]);
        size_t edge_base = rep.size();
        for (int u = 0; u < n; ++u)
            for (int k = g.out_off[u]; k < g.out_off[u + 1]; ++k)
                rep.push_back((long long)P.pos[u] * n + P.pos[g.out_nbr[k]]);
        std::sort(rep.begin() + edge_base, rep.end());
    }

    // record automorphism gamma(v) = ref_lab[new_pos[v]]
    void add_automorphism(const std::vector<int>& ref_lab,
                          const std::vector<int>& new_pos) {
        std::vector<int> gamma(n);
        bool identity = true;
        for (int v = 0; v < n; ++v) {
            gamma[v] = ref_lab[new_pos[v]];
            if (gamma[v] != v) identity = false;
        }
        if (!identity) gens.push_back(std::move(gamma));
    }

    static int common_prefix_len(const std::vector<int>& a,
                                 const std::vector<int>& b) {
        size_t k = 0;
        while (k < a.size() && k < b.size() && a[k] == b[k]) ++k;
        return (int)k;
    }

    // Returns a backjump level (abandon exploration down to that base length)
    // or NO_JUMP.  When a leaf's representation equals the first/best leaf's,
    // the discovered automorphism maps this leaf's whole diverged subtree onto
    // an already-explored sibling subtree at their lowest common ancestor, so
    // everything between can be abandoned (McKay backjumping).
    int handle_leaf(const Partition& P) {
        std::vector<long long> rep;
        leaf_rep(P, rep);
        if (!have_first) {
            have_first = true;
            first_pos = P.pos;
            first_lab = P.lab;
            first_base = base;
            first_rep = rep;
            best_pos = P.pos;
            best_lab = P.lab;
            best_base = base;
            best_rep = std::move(rep);
            return NO_JUMP;
        }
        if (rep == first_rep) {
            add_automorphism(first_lab, P.pos);
            return common_prefix_len(base, first_base);
        }
        if (rep == best_rep) {
            add_automorphism(best_lab, P.pos);
            return common_prefix_len(base, best_base);
        }
        if (rep > best_rep) {
            best_rep = std::move(rep);
            best_pos = P.pos;
            best_lab = P.lab;
            best_base = base;
        }
        return NO_JUMP;
    }

    // ---- search ---------------------------------------------------------

    int first_nonsingleton(const Partition& P) {
        int s = 0;
        while (s < n) {
            if (P.clen[s] > 1) return s;
            s += P.clen[s];
        }
        return -1;
    }

    bool gen_fixes_base(const std::vector<int>& gamma) {
        // reverse order: generators discovered at divergence level l fix the
        // first l base vertices, so mismatches cluster at the deep end
        for (auto it = base.rbegin(); it != base.rend(); ++it)
            if (gamma[*it] != *it) return false;
        return true;
    }

    int search(Partition& P) {
        if (budget_exceeded) return NO_JUMP;
        if (--node_budget < 0) { budget_exceeded = true; return NO_JUMP; }
        int tc = first_nonsingleton(P);
        if (tc < 0) return handle_leaf(P);
        int tl = P.clen[tc];
        std::vector<int> candidates(P.lab.begin() + tc, P.lab.begin() + tc + tl);

        int my_level = (int)base.size();
        UnionFind uf(n);
        size_t gen_cursor = 0;
        std::vector<int> explored;
        for (int v : candidates) {
            if (budget_exceeded) return NO_JUMP;
            if (!explored.empty()) {
                // Fold newly discovered generators that fix our base.  Done
                // lazily (never before the second candidate): with
                // backjumping most nodes only ever visit one candidate, and a
                // base-fixing generator permutes the target cell within
                // itself, so uniting over cell members suffices for pruning.
                while (gen_cursor < gens.size()) {
                    const auto& gamma = gens[gen_cursor++];
                    if (gen_fixes_base(gamma))
                        for (int u : candidates)
                            if (gamma[u] != u) uf.unite(u, gamma[u]);
                }
                bool pruned = false;
                for (int u : explored)
                    if (uf.find(u) == uf.find(v)) { pruned = true; break; }
                if (pruned) continue;
            }
            explored.push_back(v);

            // individualize v within its (current) cell and recurse
            Partition Q = P;
            int s = Q.cstart[Q.pos[v]];
            int L = Q.clen[s];
            int pv = Q.pos[v];
            // move v to the front of the cell
            std::swap(Q.lab[s], Q.lab[pv]);
            Q.pos[Q.lab[pv]] = pv;
            Q.pos[v] = s;
            Q.clen[s] = 1;
            Q.cstart[s] = s;
            if (L > 1) {
                Q.clen[s + 1] = L - 1;
                for (int k = s + 1; k < s + L; ++k) Q.cstart[k] = s + 1;
            }
            std::deque<int> wl;
            wl.push_back(s);
            if (L > 1) wl.push_back(s + 1);
            refine(Q, wl);

            base.push_back(v);
            int jump = search(Q);
            base.pop_back();
            if (jump < my_level) return jump;   // propagate the backjump
            // jump == my_level: this node is the jump target; keep iterating
        }
        return NO_JUMP;
    }
};

}  // namespace

extern "C" {

// Canonical labeling of a vertex-colored digraph.
//   n        : number of vertices
//   colors   : n ints (arbitrary non-negative color ids)
//   m        : number of directed edges
//   edges    : 2m ints, (src, dst) pairs
//   perm_out : n ints; perm_out[v] = position of v in the canonical labeling
// Returns 0 on success, -1 on bad input, -2 if the search budget was exceeded.
int fe_canonical_labeling(int n, const int* colors, long long m,
                          const int* edges, int* perm_out) {
    if (n < 0 || m < 0 || (n > 0 && (!colors || !perm_out)) || (m > 0 && !edges))
        return -1;
    if (n == 0) return 0;

    Graph g;
    g.n = n;
    g.colors.assign(colors, colors + n);
    // build CSR (out and in)
    std::vector<int> out_deg(n, 0), in_deg(n, 0);
    for (long long e = 0; e < m; ++e) {
        int u = edges[2 * e], v = edges[2 * e + 1];
        if (u < 0 || u >= n || v < 0 || v >= n) return -1;
        ++out_deg[u];
        ++in_deg[v];
    }
    g.out_off.assign(n + 1, 0);
    g.in_off.assign(n + 1, 0);
    for (int i = 0; i < n; ++i) {
        g.out_off[i + 1] = g.out_off[i] + out_deg[i];
        g.in_off[i + 1] = g.in_off[i] + in_deg[i];
    }
    g.out_nbr.resize(g.out_off[n]);
    g.in_nbr.resize(g.in_off[n]);
    std::vector<int> oc(g.out_off.begin(), g.out_off.end() - 1);
    std::vector<int> ic(g.in_off.begin(), g.in_off.end() - 1);
    for (long long e = 0; e < m; ++e) {
        int u = edges[2 * e], v = edges[2 * e + 1];
        g.out_nbr[oc[u]++] = v;
        g.in_nbr[ic[v]++] = u;
    }
    // deterministic neighbor order
    for (int i = 0; i < n; ++i) {
        std::sort(g.out_nbr.begin() + g.out_off[i], g.out_nbr.begin() + g.out_off[i + 1]);
        std::sort(g.in_nbr.begin() + g.in_off[i], g.in_nbr.begin() + g.in_off[i + 1]);
    }

    // initial partition: cells ordered by color value, vertices by id within
    Partition P;
    P.lab.resize(n);
    for (int i = 0; i < n; ++i) P.lab[i] = i;
    std::stable_sort(P.lab.begin(), P.lab.end(), [&](int a, int b) {
        return g.colors[a] < g.colors[b];
    });
    P.pos.resize(n);
    P.cstart.resize(n);
    P.clen.assign(n, 0);
    for (int i = 0; i < n; ++i) P.pos[P.lab[i]] = i;
    {
        int i = 0;
        while (i < n) {
            int j = i;
            while (j < n && g.colors[P.lab[j]] == g.colors[P.lab[i]]) ++j;
            P.clen[i] = j - i;
            for (int k = i; k < j; ++k) P.cstart[k] = i;
            i = j;
        }
    }

    Searcher S(g, /*budget=*/8'000'000LL);
    std::deque<int> wl;
    {
        int i = 0;
        while (i < n) {
            wl.push_back(i);
            i += P.clen[i];
        }
    }
    S.refine(P, wl);
    S.search(P);
    if (S.budget_exceeded) return -2;
    if (!S.have_first) return -3;
    std::memcpy(perm_out, S.best_pos.data(), n * sizeof(int));
    return 0;
}

// version tag for cache invalidation of the compiled object
int fe_canon_abi_version(void) { return 1; }

}  // extern "C"

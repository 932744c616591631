"""The port's kernel wrappers (``feinsum_tpu_torch/ops/kernels.py``): their
operand checks and plain versions on CPU tensors, and, in the tests marked
``cuda``, the hand-written kernels (``dg_rows_f32``, ``ew_product_f32``
and its flatten route ``ew_flat_f32``, ``row_reduce_f32``,
``long_reduce_f32``, ``dd_rows``, ``tc_grid_f32``) against their plain
versions on the card; and the default device of the helpers that make
tensors (the card, or an error, unless the caller names the CPU).  This file
imports no JAX, so it runs where only PyTorch is installed; on such a
machine run it without the JAX-importing conftest:

    python -m pytest tests/test_torch_kernels.py --noconftest -m cuda
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

import feinsum_tpu_torch as ft
from feinsum_tpu_torch import suite as S
from feinsum_tpu_torch.ops import _build, kernels

RTOL = 2e-5
# dd_rows computes in float64; its pairs carry about 48 bits
DD_RTOL = 1e-12


def assert_close(got, ref, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _pairs(a):
    """float64 numpy -> (2, ...) float32 [hi, lo] pairs."""
    hi = a.astype(np.float32)
    return np.stack([hi, (a - hi.astype(np.float64)).astype(np.float32)])


def _unpair(t):
    t = t.cpu().numpy()
    return t[0].astype(np.float64) + t[1].astype(np.float64)


def _dd_rows(device, S_=3, I=5, J=7, X=2, E=33, u_has_s=False, seed=0,
             with_f=True):
    """Two fp64 rows as pairs on *device*, and their float64 values."""
    rng = np.random.default_rng(seed)
    rows, values = [], []
    for _ in range(2):
        u = rng.random((S_ if u_has_s else 1, J, E))
        R = rng.random((S_, I, J))
        F = rng.random((X, S_, E)) if with_f else None

        def t(a):
            return None if a is None else torch.from_numpy(_pairs(a)).to(
                device)
        rows.append(kernels.DDRow(u=t(u), R=t(R), F=t(F)))
        values.append((u, R, F))
    return rows, values


def _dd_formula(u, R, F):
    t = np.einsum("sij,sje->sie", R, np.broadcast_to(
        u, (R.shape[0],) + u.shape[1:]))
    if F is None:
        return t.sum(0, keepdims=True)
    return np.einsum("xse,sie->xie", F, t)


def _dg_rows(device, S_=3, I=5, J=7, X=2, u_has_s=False, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.random(shape, dtype=np.float32)).to(device)
    return [kernels.DGRow(u=t(S_ if u_has_s else 1, J, 33), R=t(S_, I, J),
                          F=t(X, S_, 33)) for _ in range(2)]


def test_wrappers_check_their_operands():
    rows = _dg_rows("cpu")
    bad_dtype = [kernels.DGRow(u=rows[0].u.double(), R=rows[0].R.double(),
                               F=rows[0].F.double())]
    with pytest.raises(ft.InvalidParameterError):
        kernels.dg_rows_f32(bad_dtype, block_long=8)
    bad_shape = [kernels.DGRow(u=rows[0].u, R=rows[0].R[:, :, :3],
                               F=rows[0].F)]
    with pytest.raises(ValueError):
        kernels.dg_rows_f32(bad_shape, block_long=8)
    overlapping = [kernels.DGRow(u=rows[0].u, R=rows[0].R,
                                 F=rows[0].F.as_strided((2, 3, 33),
                                                        (1, 1, 1)))]
    with pytest.raises(ValueError):
        kernels.dg_rows_f32(overlapping, block_long=8)
    with pytest.raises(ValueError):      # no kernel and no plain version
        kernels.dg_rows_f32(_dg_rows("meta"), block_long=8)
    with pytest.raises(ValueError):
        kernels.ew_product_f32([[torch.ones(4, 3), torch.ones(3, 4)]])
    with pytest.raises(ValueError):
        kernels.ew_product_f32([[torch.ones(4, 3, device="meta")] * 2])


@pytest.mark.parametrize("u_has_s", [False, True])
def test_dg_rows_plain_is_the_row_formula(u_has_s):
    rows = _dg_rows("cpu", u_has_s=u_has_s, seed=1)
    outs = kernels.dg_rows_f32(rows, out_order=(1, 0, 2),
                                block_long=8)
    for row, out in zip(rows, outs):
        u = row.u.double().expand(3, 7, 33)
        want = np.einsum("xse,sij,sje->ixe", row.F.double().numpy(),
                         row.R.double().numpy(), u.numpy())
        assert out.is_contiguous() and out.shape == (5, 2, 33)
        assert_close(out.numpy(), want)


@pytest.mark.parametrize("u_has_s,with_f", [(False, True), (True, True),
                                             (True, False)])
def test_dd_rows_plain_is_the_row_formula(u_has_s, with_f):
    rows, values = _dd_rows("cpu", u_has_s=u_has_s, with_f=with_f, seed=8)
    outs = kernels.dd_rows(rows, block_long=8)
    for out, (u, R, F) in zip(outs, values):
        assert out.dtype == torch.float32 and out.is_contiguous()
        assert out.shape == (2, 2 if with_f else 1, 5, 33)
        assert_close(_unpair(out), _dd_formula(u, R, F), rtol=DD_RTOL)
    assert kernels.launch_counts["dd_rows"] == 0


def test_dd_rows_checks_its_operands():
    rows, _ = _dd_rows("cpu")
    not_pairs = [kernels.DDRow(u=rows[0].u[0], R=rows[0].R[0],
                               F=rows[0].F[0])]
    with pytest.raises(ValueError):
        kernels.dd_rows(not_pairs, block_long=8)
    as_f64 = [kernels.DDRow(u=rows[0].u.double(), R=rows[0].R.double(),
                            F=rows[0].F.double())]
    with pytest.raises(ft.InvalidParameterError):
        kernels.dd_rows(as_f64, block_long=8)
    with pytest.raises(ValueError):
        kernels.dd_rows(_dd_rows("meta")[0], block_long=8)


# {{{ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is"
                    " false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("u_has_s", [False, True])
@pytest.mark.parametrize("block_long,out_order", [(8, (2, 0, 1)),
                                                  (1024, (0, 1, 2)),
                                                  (100, (1, 2, 0))])
def test_dg_rows_kernel_matches_plain(cuda_device, u_has_s, block_long,
                                      out_order):
    rows = _dg_rows(cuda_device, u_has_s=u_has_s, seed=2)
    before = kernels.launch_counts["dg_rows_f32"]
    got = kernels.dg_rows_f32(rows, out_order=out_order,
                              block_long=block_long)
    torch.cuda.synchronize()
    assert kernels.launch_counts["dg_rows_f32"] == before + 1
    for g, want in zip(got, kernels.dg_rows_plain(rows, out_order)):
        assert_close(g.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("one_launch,launches", [(True, 2), (False, 5)])
def test_dg_rows_kernel_splits_rows(cuda_device, one_launch, launches):
    """Five rows: two launches of at most four rows, or one per row."""
    rows = (_dg_rows(cuda_device, seed=3) * 2
            + _dg_rows(cuda_device, seed=4)[:1])
    before = kernels.launch_counts["dg_rows_f32"]
    got = kernels.dg_rows_f32(rows, one_launch=one_launch, block_long=16)
    torch.cuda.synchronize()
    assert kernels.launch_counts["dg_rows_f32"] == before + launches
    for g, want in zip(got, kernels.dg_rows_plain(rows)):
        assert_close(g.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_dg_rows_kernel_without_factor(cuda_device):
    rows = [kernels.DGRow(u=r.u, R=r.R, F=None)
            for r in _dg_rows(cuda_device, u_has_s=True, seed=5)]
    got = kernels.dg_rows_f32(rows, block_long=32)
    torch.cuda.synchronize()
    for g, want in zip(got, kernels.dg_rows_plain(rows)):
        assert_close(g.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_dg_rows_shared_memory_guard(cuda_device):
    rows = _dg_rows(cuda_device, S_=4, I=200, J=200, u_has_s=True)
    with pytest.raises(ft.InvalidParameterError):
        kernels.dg_rows_f32(rows, block_long=32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(4096, 0), (4097, 0), (4096, 1)])
def test_ew_product_kernel_matches_plain(cuda_device, n, offset):
    """float4 path, ragged length, and a misaligned operand (scalar
    path)."""
    rng = np.random.default_rng(5)
    rows = [[torch.from_numpy(rng.random(n + offset, dtype=np.float32)).to(
        cuda_device)[offset:] for _ in range(3)] for _ in range(5)]
    before = kernels.launch_counts["ew_product_f32"]
    got = kernels.ew_product_f32(rows)
    torch.cuda.synchronize()
    assert kernels.launch_counts["ew_product_f32"] == before + 2
    for g, want in zip(got, kernels.ew_product_plain(rows)):
        assert_close(g.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("u_has_s,with_f", [(False, True), (True, True),
                                             (True, False)])
@pytest.mark.parametrize("block_long,E", [(8, 33), (128, 1000),
                                          (1000, 777), (4096, 777)])
def test_dd_rows_kernel_matches_plain(cuda_device, u_has_s, with_f,
                                      block_long, E):
    rows, _ = _dd_rows(cuda_device, u_has_s=u_has_s, with_f=with_f, E=E,
                       seed=9)
    before = kernels.launch_counts["dd_rows"]
    got = kernels.dd_rows(rows, block_long=block_long)
    torch.cuda.synchronize()
    assert kernels.launch_counts["dd_rows"] == before + 1
    for g, want in zip(got, kernels.dd_rows_plain(rows)):
        assert g.shape == want.shape and g.is_contiguous()
        assert_close(_unpair(g), _unpair(want), rtol=DD_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("one_launch,launches", [(True, 2), (False, 5)])
def test_dd_rows_kernel_splits_rows(cuda_device, one_launch, launches):
    """Five rows: two launches of at most four rows, or one per row."""
    rows = (_dd_rows(cuda_device, seed=10)[0] * 2
            + _dd_rows(cuda_device, seed=11)[0][:1])
    before = kernels.launch_counts["dd_rows"]
    got = kernels.dd_rows(rows, one_launch=one_launch, block_long=16)
    torch.cuda.synchronize()
    assert kernels.launch_counts["dd_rows"] == before + launches
    for g, want in zip(got, kernels.dd_rows_plain(rows)):
        assert_close(_unpair(g), _unpair(want), rtol=DD_RTOL)


@pytest.mark.cuda
def test_dd_rows_shared_memory_guard(cuda_device):
    rows, _ = _dd_rows(cuda_device, S_=4, I=100, J=100, u_has_s=True, E=8)
    assert kernels.dd_rows_smem_bytes(4, 100, 100, True) \
        > kernels.MAX_SMEM_BYTES
    with pytest.raises(ft.InvalidParameterError):
        kernels.dd_rows(rows, block_long=32)


@pytest.mark.cuda
@pytest.mark.parametrize("S_,I,J,u_has_s", [(3, 35, 35, False),
                                            (4, 35, 15, True),
                                            (1, 35, 35, False)])
def test_dd_rows_smem_formula_matches_the_kernel(cuda_device, S_, I, J,
                                                 u_has_s):
    from feinsum_tpu_torch.ops._build import load_library
    assert load_library().dd_rows_smem_bytes(S_, I, J, int(u_has_s)) == \
        kernels.dd_rows_smem_bytes(S_, I, J, u_has_s)


@pytest.mark.cuda
@pytest.mark.parametrize("S_,I,J,u_has_s", [(1, 24, 312, False),
                                            (4, 35, 15, True)])
def test_dg_rows_smem_formula_matches_the_kernel(cuda_device, S_, I, J,
                                                 u_has_s):
    from feinsum_tpu_torch.ops._build import load_library
    assert load_library().dg_rows_f32_smem_bytes(S_, I, J, int(u_has_s)) \
        == kernels.dg_rows_smem_bytes(S_, I, J, u_has_s)


# the fp64 suite's rows, replayed from the dd transform space
@pytest.mark.cuda
@pytest.mark.parametrize("name", [name for name, _ in S.fp64_suite()])
def test_fp64_rows_validate_on_card(cuda_device, name):
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path
    e = dict(S.fp64_suite())[name]
    tr = get_transform_func_from_module_path("dd_pallas_v0").bind_args(
        e, log2_block=9)
    before = kernels.launch_counts["dd_rows"]
    ft.validate_batched_einsum_transform(e, tr, long_dim_length=2000,
                                         device=cuda_device)
    assert kernels.launch_counts["dd_rows"] == before + 1


# {{{ tc_grid_f32

# (A letters, B letters, C letters, lengths, grid, grid_m): ragged M, N and
# K (not multiples of any tile), blocked grid letters, a batch letter, the
# rows on either operand, and an expansion with no contracted letter
TC_CASES = {
    "ragged_gemm": ("ij", "jk", "ik", dict(i=130, j=33, k=70), (), None),
    "ragged_gemm_rows_b": ("ij", "jk", "ki", dict(i=130, j=33, k=70), (),
                           "k"),
    "tccg35_small": ("dfgb", "geac", "abcdef",
                     dict(a=3, b=2, c=5, d=7, e=3, f=9, g=11), (("a", 1),),
                     None),
    "tccg35_blocked": ("dfgb", "geac", "fedcba",
                       dict(a=3, b=2, c=5, d=7, e=3, f=9, g=11),
                       (("a", 3), ("b", 1)), "e"),
    "tccg02_small": ("dca", "bd", "abc", dict(a=6, b=5, c=37, d=70),
                     (("a", 2),), "b"),
    "batch": ("abk", "akc", "cab", dict(a=3, b=40, c=50, k=19), (("a", 1),),
              "c"),
    "expansion": ("i", "k", "ik", dict(i=50, k=77), (), None),
}


def _tc_operands(device, a, b, lengths, seed, permute):
    rng = np.random.default_rng(seed)
    out = []
    for letters in (a, b):
        t = torch.from_numpy(rng.random([lengths[x] for x in letters],
                                        dtype=np.float32)).to(device)
        if permute:     # a stored permutation: reversed axes in memory
            rev = tuple(reversed(range(t.ndim)))
            t = t.permute(*rev).contiguous().permute(*rev)
        out.append(t)
    return out


def test_tc_grid_plain_is_the_contraction():
    a, b, c, lengths, grid, grid_m = TC_CASES["tccg35_blocked"]
    step = kernels.TCStep(a=tuple(a), b=tuple(b), c=tuple(c),
                          lengths=tuple(sorted(lengths.items())), grid=grid,
                          grid_m=grid_m)
    A, B = _tc_operands("cpu", a, b, lengths, 0, True)
    out = kernels.tc_grid_f32(A, B, step)
    assert out.is_contiguous() and kernels.launch_counts["tc_grid_f32"] == 0
    assert_close(out.numpy(), np.einsum(f"{a},{b}->{c}", A.double().numpy(),
                                        B.double().numpy()))
    with pytest.raises(ft.InvalidParameterError):      # a private letter
        kernels.tc_classify(kernels.TCStep(
            a=("i", "j"), b=("j", "k"), c=("k",),
            lengths=(("i", 2), ("j", 3), ("k", 4))))
    with pytest.raises(ValueError):
        kernels.tc_grid_f32(A.double().float()[..., :1], B, step)


def _emulate_tc_grid(A, B, step):
    """``tc_grid_f32``'s addressing run on the host: every cell's rows and
    columns from the offset tables, as the kernel reads and writes them;
    also checks that each output element is written exactly once."""
    shape = kernels.tc_classify(step)
    lengths = dict(step.lengths)
    C = torch.zeros(tuple(lengths[x] for x in step.c), dtype=torch.float64)
    tables, _ = kernels.tc_tables(step, tuple(A.stride()), tuple(B.stride()),
                                  tuple(C.stride()))
    sizes = (shape.Mc, shape.Mc, shape.Nc, shape.Nc, shape.K, shape.K,
             shape.ncells, shape.ncells, shape.ncells)
    am, cm, bn, cn, ak, bk, ba, bb, bc = np.split(tables,
                                                  np.cumsum(sizes)[:-1])

    def memory(t):       # the tensor's storage in memory order
        return np.lib.stride_tricks.as_strided(
            t.numpy(), (t.untyped_storage().nbytes() // t.element_size(),),
            (t.element_size(),)).astype(np.float64)
    rows, cols = (B, A) if shape.swap else (A, B)
    fa, fb, fc = memory(rows), memory(cols), C.numpy().reshape(-1)
    written = np.zeros(fc.shape, dtype=int)
    for cell in range(shape.ncells):
        a = fa[ba[cell] + am[:, None] + ak[None, :]]
        b = fb[bb[cell] + bn[:, None] + bk[None, :]]
        idx = bc[cell] + cm[:, None] + cn[None, :]
        fc[idx] = a @ b.T
        np.add.at(written, idx.ravel(), 1)
    assert (written == 1).all()
    return C


@pytest.mark.parametrize("permute", [False, True])
@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tc_grid_tables_address_the_contraction(case, permute):
    """The host-side offset tables, followed as the kernel follows them,
    give the contraction (the kernel itself runs only on the card)."""
    a, b, c, lengths, grid, grid_m = TC_CASES[case]
    step = kernels.TCStep(a=tuple(a), b=tuple(b), c=tuple(c),
                          lengths=tuple(sorted(lengths.items())), grid=grid,
                          grid_m=grid_m)
    A, B = _tc_operands("cpu", a, b, lengths, 4, permute)
    assert_close(_emulate_tc_grid(A, B, step).numpy(),
                 kernels.tc_grid_plain(A.double(), B.double(), step).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("permute", [False, True])
@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tc_grid_kernel_matches_plain(cuda_device, case, permute):
    a, b, c, lengths, grid, grid_m = TC_CASES[case]
    step = kernels.TCStep(a=tuple(a), b=tuple(b), c=tuple(c),
                          lengths=tuple(sorted(lengths.items())), grid=grid,
                          grid_m=grid_m)
    A, B = _tc_operands(cuda_device, a, b, lengths, 3, permute)
    before = kernels.launch_counts["tc_grid_f32"]
    got = kernels.tc_grid_f32(A, B, step)
    torch.cuda.synchronize()
    assert kernels.launch_counts["tc_grid_f32"] == before + 1
    want = kernels.tc_grid_plain(A, B, step)
    assert got.shape == want.shape and got.is_contiguous()
    assert_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", range(len(kernels.TC_TILES)))
def test_tc_grid_tiles_match_the_kernel(cuda_device, variant):
    lib = _build.load_library()
    assert (lib.tc_grid_f32_tile_rows(variant),
            lib.tc_grid_f32_tile_cols(variant)) == kernels.TC_TILES[variant]


@pytest.mark.cuda
@pytest.mark.parametrize("space,params", [
    ("tc_pallas_v0", dict(n_grid=2, precision_idx=0, use_opt_path=True)),
    ("tc_pallas_v1", dict(n_grid=1, blk0_idx=2, blk1_idx=0, m_pos=3,
                          precision_idx=0)),
    ("tc_pallas_v1", dict(n_grid=2, blk0_idx=9, blk1_idx=1, m_pos=0,
                          precision_idx=0)),
])
def test_tc_spaces_validate_on_card(cuda_device, space, params):
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path
    e = ft.einsum("dfgb,geac->abcdef",
                  ft.array("A", (7, 9, 11, 2), "float32"),
                  ft.array("B", (11, 3, 6, 5), "float32"))
    tr = get_transform_func_from_module_path(space).bind_args(e, **params)
    before = kernels.launch_counts["tc_grid_f32"]
    ft.validate_batched_einsum_transform(e, tr, device=cuda_device)
    assert kernels.launch_counts["tc_grid_f32"] == before + 1

# }}}


# the suite rows, the extended suite's rows (P1-P3 widths, curl, vecmat,
# rowsum) and scale_flat
FUSED_ROWS = dict(S.f32_rows())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dofmajor", "logical"])
@pytest.mark.parametrize("name", sorted(FUSED_ROWS))
def test_rows_validate_on_card(cuda_device, name, layout):
    """The fused route against the numpy oracle on the card, in the
    default dof-major layout and in the logical (element-major) one."""
    e = FUSED_ROWS[name]
    transform = S.default_transform(e)
    if layout == "logical":
        def tr(p):
            return transform(p).with_descriptor(arg_layouts=(),
                                                out_layout=None)
    else:
        tr = transform
    before = dict(kernels.launch_counts)
    ft.validate_batched_einsum_transform(e, tr, long_dim_length=2000,
                                         device=cuda_device)
    assert kernels.launch_counts != before

# }}}


def test_ew_product_plain_is_the_product():
    rng = np.random.default_rng(6)
    ops = [rng.random((5, 9), dtype=np.float32) for _ in range(3)]
    (out,) = kernels.ew_product_f32([[torch.from_numpy(o) for o in ops]])
    assert_close(out.numpy(), ops[0] * ops[1] * ops[2])


# {{{ row_reduce_f32 and the flatten route

def _reduce_rows(device, E=33, J=7, element_major=False, with_w=True,
                 nrows=2, seed=0):
    """Rows of (E, J) u views (dof-major storage unless *element_major*)
    and (J,) weights."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(nrows):
        u = torch.from_numpy(rng.random((E, J), dtype=np.float32)).to(device)
        if not element_major:
            u = u.t().contiguous().t()          # stored (J, E), e stride 1
        w = (torch.from_numpy(rng.random(J, dtype=np.float32)).to(device)
             if with_w else None)
        rows.append(kernels.ReduceRow(u=u, w=w))
    return rows


@pytest.mark.parametrize("element_major", [False, True])
@pytest.mark.parametrize("with_w", [False, True])
def test_row_reduce_plain_is_the_row_formula(element_major, with_w):
    rows = _reduce_rows("cpu", element_major=element_major, with_w=with_w,
                        seed=12)
    outs = kernels.row_reduce_f32(rows, block_long=8)
    for row, out in zip(rows, outs):
        w = row.w.double().numpy() if with_w else np.ones(7)
        assert out.shape == (33,) and out.is_contiguous()
        assert_close(out.numpy(), row.u.double().numpy() @ w)
    assert kernels.launch_counts["row_reduce_f32"] == 0


def test_row_reduce_checks_its_operands():
    rows = _reduce_rows("cpu")
    with pytest.raises(ValueError):       # rows disagree on w
        kernels.row_reduce_f32([rows[0], kernels.ReduceRow(rows[1].u, None)],
                               block_long=8)
    with pytest.raises(ValueError):
        kernels.row_reduce_f32([kernels.ReduceRow(rows[0].u, rows[0].w[:3])],
                               block_long=8)
    with pytest.raises(ft.InvalidParameterError):
        kernels.row_reduce_f32([kernels.ReduceRow(rows[0].u.double(), None)],
                               block_long=8)
    with pytest.raises(ValueError):      # no kernel and no plain version
        kernels.row_reduce_f32(_reduce_rows("meta"), block_long=8)


def test_ew_flat_plain_and_checks():
    rng = np.random.default_rng(13)
    ops = [torch.from_numpy(rng.random(50, dtype=np.float32))
           for _ in range(2)]
    (out,) = kernels.ew_flat_f32([ops], block_long=16)
    assert_close(out.numpy(), ops[0].numpy() * ops[1].numpy())
    assert kernels.launch_counts["ew_flat_f32"] == 0
    with pytest.raises(ValueError):
        kernels.ew_flat_f32([[torch.ones(4, 3)] * 2], block_long=16)
    with pytest.raises(ft.InvalidParameterError):
        kernels.ew_flat_f32([ops], block_long=0)


@pytest.mark.cuda
@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("element_major", [False, True])
@pytest.mark.parametrize("E,J,block_long", [(33, 7, 8), (777, 35, 512),
                                            (1000, 20, 100),
                                            (257, 100, 4096)])
def test_row_reduce_kernel_matches_plain(cuda_device, E, J, block_long,
                                         element_major, with_w):
    """Dof-major and element-major storage (the staged path, and the
    strided one for J = 100, whose tile exceeds 48 KB), ragged blocks."""
    rows = _reduce_rows(cuda_device, E=E, J=J, element_major=element_major,
                        with_w=with_w, seed=14)
    before = kernels.launch_counts["row_reduce_f32"]
    got = kernels.row_reduce_f32(rows, block_long=block_long)
    torch.cuda.synchronize()
    assert kernels.launch_counts["row_reduce_f32"] == before + 1
    for g, want in zip(got, kernels.row_reduce_plain(rows)):
        assert g.shape == (E,) and g.is_contiguous()
        assert_close(g.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("one_launch,launches", [(True, 2), (False, 5)])
def test_row_reduce_kernel_splits_rows(cuda_device, one_launch, launches):
    rows = _reduce_rows(cuda_device, nrows=5, seed=15)
    before = kernels.launch_counts["row_reduce_f32"]
    got = kernels.row_reduce_f32(rows, block_long=16, one_launch=one_launch)
    torch.cuda.synchronize()
    assert kernels.launch_counts["row_reduce_f32"] == before + launches
    for g, want in zip(got, kernels.row_reduce_plain(rows)):
        assert_close(g.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_row_reduce_limits_match_the_kernel(cuda_device):
    lib = _build.load_library()
    assert lib.row_reduce_f32_max_j() == kernels.MAX_REDUCE_J
    assert lib.row_reduce_f32_staged(35, 35, 1) == 1
    assert lib.row_reduce_f32_staged(35, 1, 1000) == 0
    assert lib.row_reduce_f32_staged(100, 100, 1) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset,block_long", [
    (4096, 0, 256), (4097, 0, 1024), (4096, 1, 512), (100_000, 0, 6),
    (36_700_160, 0, 32768)])
def test_ew_flat_kernel_matches_plain(cuda_device, n, offset, block_long):
    """float4 path, ragged length, a misaligned operand and a block length
    not a multiple of 4 (scalar path), and scale_flat's full length."""
    rng = np.random.default_rng(16)
    rows = [[torch.from_numpy(rng.random(n + offset, dtype=np.float32)).to(
        cuda_device)[offset:] for _ in range(2)] for _ in range(2)]
    before = kernels.launch_counts["ew_flat_f32"]
    got = kernels.ew_flat_f32(rows, block_long=block_long)
    torch.cuda.synchronize()
    assert kernels.launch_counts["ew_flat_f32"] == before + 1
    for g, want in zip(got, kernels.ew_product_plain(rows)):
        assert_close(g.cpu().numpy(), want.cpu().numpy())

# }}}


# {{{ long_reduce_f32

# name: (subscripts, A's role, B's role or "same" (B is A) or None (no B),
# c is an output letter, output axes in order)
LR_CASES = {
    "energy": ("ej,ej->", "c", "same", False, ()),
    "per-letter sum": ("ej,ej->j", "c", "c", True, ("c",)),
    "gram": ("ei,ej->ij", "p", "q", False, ("p", "q")),
    "gram transposed": ("ei,ej->ji", "p", "q", False, ("q", "p")),
    "letter sums": ("ej->j", "p", None, False, ("p",)),
    "total": ("ej->", "c", None, False, ()),
    "weighted sums": ("e,ej->j", None, "q", False, ("q",)),
}


def _lr_case(name, device, E=37, element_major=False, nrows=2, seed=0):
    """(rows, shape, wants): *nrows* rows of the case on *device* with
    short letters of lengths 5 (A) and 6 (B, or 5 when shared), stored
    dof-major (e at stride 1) unless *element_major*, and each row's
    float64 numpy value in the output's axis order."""
    subs, a_role, b_role, c_batch, out_axes = LR_CASES[name]
    rng = np.random.default_rng(seed)
    length = {"p": 5, "c": 5, "q": 6, None: 1}

    def operand(role):
        t = torch.from_numpy(rng.random((E, length[role]), dtype=np.float32))
        if not element_major:
            t = t.t().contiguous().t()
        return t.to(device)
    rows, wants = [], []
    ins = subs.split("->")[0].split(",")
    for _ in range(nrows):
        a = operand(a_role)
        b = a if b_role == "same" else (None if b_role is None
                                        else operand(b_role))
        rows.append(kernels.LongReduceRow(a=a, b=b))
        ops = [a, b][:len(ins)]
        wants.append(np.einsum(subs, *[
            (o.double().cpu().numpy() if len(sub) == 2
             else o.double().cpu().numpy()[:, 0]) for o, sub in zip(ops, ins)]))
    shape = kernels.LongReduceShape(
        a_role=a_role, b_role="c" if b_role == "same" else b_role,
        P=length["p"] if "p" in (a_role,) else 1,
        Q=length["q"] if b_role == "q" else 1,
        C=5 if "c" in (a_role, b_role) else 1, c_batch=c_batch,
        out_axes=out_axes)
    return rows, shape, wants


@pytest.mark.parametrize("element_major", [False, True])
@pytest.mark.parametrize("name", sorted(LR_CASES))
def test_long_reduce_plain_is_numpy_einsum(name, element_major):
    rows, shape, wants = _lr_case(name, "cpu", element_major=element_major,
                                  seed=21)
    outs = kernels.long_reduce_f32(rows, shape, block_long=8)
    for out, want in zip(outs, wants):
        assert tuple(out.shape) == shape.out_shape and out.is_contiguous()
        assert_close(out.numpy(), want)
    assert kernels.launch_counts["long_reduce_f32"] == 0


def test_long_reduce_checks_its_operands():
    rows, shape, _ = _lr_case("gram", "cpu")
    with pytest.raises(ValueError):         # rows disagree on B
        kernels.long_reduce_f32([rows[0], kernels.LongReduceRow(rows[1].a,
                                                                None)],
                                shape, block_long=8)
    with pytest.raises(ValueError):         # B's short letter is 6 long
        kernels.long_reduce_f32([kernels.LongReduceRow(rows[0].a,
                                                       rows[0].a)],
                                shape, block_long=8)
    with pytest.raises(ValueError):         # the output axes miss q
        kernels.long_reduce_f32(rows, replace(shape, out_axes=("p",)),
                                block_long=8)
    with pytest.raises(ValueError):         # a batch c must be shared
        kernels.long_reduce_f32(rows, replace(shape, c_batch=True),
                                block_long=8)
    with pytest.raises(ft.InvalidParameterError):
        kernels.long_reduce_f32([kernels.LongReduceRow(
            rows[0].a.double(), rows[0].b.double())], shape, block_long=8)
    meta_rows = [kernels.LongReduceRow(r.a.to("meta"), r.b.to("meta"))
                 for r in rows]
    with pytest.raises(ValueError):         # no kernel and no plain version
        kernels.long_reduce_f32(meta_rows, shape, block_long=8)
    # an outer product takes up to 256 4 x 4 tiles, any other row up to 256
    # output entries
    gram = kernels.LongReduceShape("p", "q", 64, 64, 1, False, ("p", "q"))
    kernels.check_long_reduce_shape(gram)
    with pytest.raises(ft.InvalidParameterError, match="4 x 4 tiles"):
        kernels.check_long_reduce_shape(replace(gram, P=65))
    sums = kernels.LongReduceShape("c", "c", 1, 1, 256, True, ("c",))
    kernels.check_long_reduce_shape(sums)
    with pytest.raises(ft.InvalidParameterError, match="output entries"):
        kernels.check_long_reduce_shape(replace(sums, C=257))


def test_long_reduce_tile_formula():
    assert kernels.long_reduce_tile(35, 0) == 160      # the energy: A alone
    assert kernels.long_reduce_tile(35, 35) == 64      # two (E, 35) tiles
    assert kernels.long_reduce_tile(1, 0) == 256
    assert kernels.long_reduce_tile(6143, 0) == 1
    assert kernels.long_reduce_tile(6144, 1) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("element_major", [False, True])
@pytest.mark.parametrize("E,block_long", [(37, 512), (777, 64), (1003, 256),
                                          (100_003, 512)])
@pytest.mark.parametrize("name", sorted(LR_CASES))
def test_long_reduce_kernel_matches_plain(cuda_device, name, E, block_long,
                                          element_major):
    """Each case in both layouts: E smaller than one block, a ragged tail,
    several blocks and tiles."""
    rows, shape, wants = _lr_case(name, cuda_device, E=E,
                                  element_major=element_major, seed=22)
    before = kernels.launch_counts["long_reduce_f32"]
    got = kernels.long_reduce_f32(rows, shape, block_long=block_long)
    torch.cuda.synchronize()
    assert kernels.launch_counts["long_reduce_f32"] == before + 1
    for g, plain, want in zip(got, kernels.long_reduce_plain(rows, shape),
                              wants):
        assert tuple(g.shape) == shape.out_shape and g.is_contiguous()
        assert_close(g.cpu().numpy(), plain.cpu().numpy())
        assert_close(g.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("one_launch,launches", [(True, 2), (False, 9)])
def test_long_reduce_kernel_splits_rows(cuda_device, one_launch, launches):
    rows, shape, wants = _lr_case("gram", cuda_device, E=999, nrows=9,
                                  seed=23)
    before = kernels.launch_counts["long_reduce_f32"]
    got = kernels.long_reduce_f32(rows, shape, block_long=128,
                                  one_launch=one_launch)
    torch.cuda.synchronize()
    assert kernels.launch_counts["long_reduce_f32"] == before + launches
    for g, want in zip(got, wants):
        assert_close(g.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("element_major", [False, True])
@pytest.mark.parametrize("case", ["gram 64", "sums 256", "energy 256"])
def test_long_reduce_kernel_at_its_limits(cuda_device, case, element_major):
    """The largest rows the kernel takes: a 64 x 64 Gram matrix (256 tiles
    of 4 x 4 entries, one group each), ej,ej->j over 256 letters (one lane
    per entry) and the energy of a 256-wide operand (the smallest tile)."""
    rng = np.random.default_rng(24)
    E = 3001

    def operand(n):
        t = torch.from_numpy(rng.random((E, n), dtype=np.float32))
        return (t if element_major else t.t().contiguous().t()).to(
            cuda_device)
    if case == "gram 64":
        a, b = operand(64), operand(64)
        shape = kernels.LongReduceShape("p", "q", 64, 64, 1, False,
                                        ("p", "q"))
        subs = "ei,ej->ij"
    elif case == "sums 256":
        a, b = operand(256), operand(256)
        shape = kernels.LongReduceShape("c", "c", 1, 1, 256, True, ("c",))
        subs = "ej,ej->j"
    else:
        a = operand(256)
        b = a
        shape = kernels.LongReduceShape("c", "c", 1, 1, 256, False, ())
        subs = "ej,ej->"
    rows = [kernels.LongReduceRow(a=a, b=b)]
    before = kernels.launch_counts["long_reduce_f32"]
    (got,) = kernels.long_reduce_f32(rows, shape, block_long=1024)
    torch.cuda.synchronize()
    assert kernels.launch_counts["long_reduce_f32"] == before + 1
    assert_close(got.cpu().numpy(),
                 kernels.long_reduce_plain(rows, shape)[0].cpu().numpy())
    assert_close(got.cpu().numpy(), np.einsum(
        subs, a.double().cpu().numpy(), b.double().cpu().numpy()))


@pytest.mark.cuda
@pytest.mark.parametrize("shootout", [False, True])
def test_compile_fn_with_archive_raises_when_a_kernel_fails_to_build(
        cuda_device, tmp_path, monkeypatch, shootout):
    """An archived schedule whose kernel does not build (or launch) on the
    card is an error, not a reason to serve the plain program."""
    from feinsum_tpu_torch import sql_utils

    e = ft.einsum("ej,ij->ei", ft.array("u", ("E", 20), "float32"),
                  ft.array("D", (20, 20), "float32"))
    db = str(tmp_path / "archive.sqlite")
    dev = ft.FakeDevice("TPU v5 lite")
    sql_utils.record_facts(e, transform_id="mass_v0",
                           transform_params=S.space_point("mass_v0", e),
                           runtime_in_sec=1e-6, device=dev, db_path=db,
                           long_dim_length=2048)
    rng = np.random.default_rng(25)
    u = torch.from_numpy(rng.random((2048, 20), dtype=np.float32)).to(
        cuda_device)
    D = torch.from_numpy(rng.random((20, 20), dtype=np.float32)).to(
        cuda_device)

    def no_nvcc():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(_build, "load_library", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ft.compile_fn_with_archive(
            lambda u, D: torch.einsum("ej,ij->ei", u, D), [u, D],
            db_path=db, device=dev, long_dim_length=500, shootout=shootout)

# }}}


# {{{ the default device

def test_helpers_take_no_card_unless_asked_for_the_cpu(monkeypatch):
    """``arrays_from_numpy`` and ``generate_input_arrays`` put their tensors
    on the current CUDA card by default; without one they raise unless the
    caller names the CPU."""
    from feinsum_tpu_torch.interop import arrays_from_numpy
    from feinsum_tpu_torch.measure import generate_input_arrays

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = S.make_matvec(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_input_arrays(e, long_dim_length=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        arrays_from_numpy({"x": np.ones(3, np.float32)})
    arrays = generate_input_arrays(e, long_dim_length=8, device="cpu")
    assert {t.device.type for t in arrays.values()} == {"cpu"}
    assert arrays_from_numpy({"x": np.ones(3)}, "cpu")["x"].device.type \
        == "cpu"
    # numpy arrays need no device
    assert isinstance(generate_input_arrays(e, long_dim_length=8,
                                            as_numpy=True)["u"], np.ndarray)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.consumer_args(E=8, ndof=4, nf=2, nfdof=3)


@pytest.mark.cuda
def test_helpers_default_to_the_card(cuda_device):
    from feinsum_tpu_torch.interop import arrays_from_numpy
    from feinsum_tpu_torch.measure import generate_input_arrays

    arrays = generate_input_arrays(S.make_matvec(4), long_dim_length=8)
    assert {t.device.type for t in arrays.values()} == {"cuda"}
    assert arrays_from_numpy({"x": np.ones(3)})["x"].device.type == "cuda"

# }}}


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_name_follows_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path()       # stable for unchanged sources
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "dg_rows.cu", "ew_product.cu", "dd_rows.cu", "tc_grid.cu",
        "row_reduce.cu", "long_reduce.cu"}

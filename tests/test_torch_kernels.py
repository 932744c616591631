"""The port's kernel wrappers (``feinsum_tpu_torch/ops/kernels.py``): their
operand checks and plain versions on CPU tensors, and, in the tests marked
``cuda``, the hand-written kernels (``dg_rows_f32``, ``ew_product_f32``
and its flatten route ``ew_flat_f32``, ``row_reduce_f32``,
``long_reduce_f32``, ``dd_rows``, ``tc_grid_f32``, ``lane_pack_dg_f32``,
``step_block_f32``, ``tc_steps_f32``, the probe kernels
``probe_stream_f32`` and ``probe_apply_f32`` and the 3xTF32 kernels
``dg_rows_3xtf32``, ``tc_grid_3xtf32``, ``lane_pack_dg_3xtf32`` and
``probe_apply_3xtf32``) against their plain
versions on the card; the TF32 rounding the 3x kernels and their plain versions share;
and the default device of the helpers that make tensors (the card, or an
error, unless the caller names the CPU).  This file
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


# {{{ the 3xTF32 kernels (bf16_3x)

# a 3x kernel against its plain version: the same split, summed in another
# order (the tensor cores' accumulate truncates), so relative to the sum of
# the terms' magnitudes
RTOL_3X = 1e-6


def _bits(values) -> list:
    return [int(v) for v in torch.tensor(values, dtype=torch.float32).view(
        torch.int32).numpy().astype(np.uint32)]


def _float(bits: int) -> float:
    return float(torch.tensor([bits], dtype=torch.int64).to(
        torch.int32).view(torch.float32)[0])


# (input bits, rounded bits): ties go away from zero, on the bit pattern
TF32_CASES = {
    "tie up": (0x3F801000, 0x3F802000),
    "negative tie": (0xBF801000, 0xBF802000),
    "below a tie": (0x3F800FFF, 0x3F800000),
    "above a tie": (0x3F801001, 0x3F802000),
    "odd tie": (0x3F803000, 0x3F804000),
    "subnormal tie": (0x00001000, 0x00002000),
    "subnormal below a tie": (0x00000FFF, 0x00000000),
    "largest float overflows": (0x7F7FFFFF, 0x7F800000),
    "lowest float overflows": (0xFF7FFFFF, 0xFF800000),
    "inf": (0x7F800000, 0x7F800000),
    "-inf": (0xFF800000, 0xFF800000),
    "-0": (0x80000000, 0x80000000),
    "exact": (0x40402000, 0x40402000),
}


@pytest.mark.parametrize("case", sorted(TF32_CASES))
def test_tf32_round_on_bit_patterns(case):
    given, want = TF32_CASES[case]
    (got,) = _bits(kernels.tf32_round(torch.tensor([_float(given)])))
    assert got == want, (hex(got), hex(want))
    assert got & 0x1FFF == 0


def test_tf32_round_keeps_nan_and_splits_exactly():
    assert torch.isnan(kernels.tf32_round(torch.tensor([float("nan")])))[0]
    x = torch.from_numpy(np.random.default_rng(30).standard_normal(
        10_000).astype(np.float32) * 1e3)
    hi, lo = kernels.tf32_split(x)
    assert all(b & 0x1FFF == 0 for b in _bits(hi) + _bits(lo))
    err = (hi.double() + lo.double() - x.double()).abs()
    assert float((err / x.double().abs()).max()) <= 2.0 ** -22
    # a product of two TF32 values is exact in float32
    assert torch.equal((hi[:100] * hi[100:200]).double(),
                       hi[:100].double() * hi[100:200].double())


def _close_to_terms(got, want, mag, rtol=RTOL_3X):
    got, want, mag = (np.asarray(t, dtype=np.float64) for t in (got, want,
                                                                  mag))
    assert got.shape == want.shape == mag.shape
    assert float((np.abs(got - want) / np.maximum(mag, 1e-30)).max()) <= rtol


def _abs_rows(rows):
    return [replace(r, **{k: None if v is None else v.abs()
                          for k, v in vars(r).items()}) for r in rows]


@pytest.mark.parametrize("u_has_s", [False, True])
def test_dg_rows_3x_plain_is_the_row_formula(u_has_s):
    rows = _dg_rows("cpu", u_has_s=u_has_s, seed=31)
    outs = kernels.dg_rows_3xtf32(rows, out_order=(1, 0, 2), block_long=8)
    assert not kernels.launch_counts["dg_rows_3xtf32"]
    for row, out in zip(rows, outs):
        u = row.u.double().expand(3, 7, 33)
        want = np.einsum("xse,sij,sje->ixe", row.F.double().numpy(),
                         row.R.double().numpy(), u.numpy())
        assert out.is_contiguous() and out.shape == (5, 2, 33)
        _close_to_terms(out.numpy(), want, want)


def test_einsum_3x_contracts_pairwise():
    rng = np.random.default_rng(32)
    ops = [rng.standard_normal(s).astype(np.float32)
           for s in ((40, 3), (3, 6, 5), (40, 5))]
    got = kernels.einsum_3x("es,sij,ej->ei", *map(torch.from_numpy, ops))
    want = np.einsum("es,sij,ej->ei", *[o.astype(np.float64) for o in ops])
    mag = np.einsum("es,sij,ej->ei", *[np.abs(o.astype(np.float64))
                                        for o in ops])
    _close_to_terms(got.numpy(), want, mag)
    # a float64 step and a single operand run as plain torch.einsum
    a = torch.from_numpy(ops[0]).double()
    assert torch.equal(kernels.einsum_3x("es,es->e", a, a),
                       torch.einsum("es,es->e", a, a))
    assert torch.equal(kernels.einsum_3x("sij->ij", torch.from_numpy(ops[1])),
                       torch.from_numpy(ops[1]).sum(0))


def test_tc_grid_3x_plain_is_the_contraction():
    a, b, c, lengths, grid, grid_m = TC_CASES["tccg35_blocked"]
    step = kernels.TCStep(a=tuple(a), b=tuple(b), c=tuple(c),
                          lengths=tuple(sorted(lengths.items())), grid=grid,
                          grid_m=grid_m)
    A, B = _tc_operands("cpu", a, b, lengths, 33, True)
    out = kernels.tc_grid_3xtf32(A, B, step)
    assert out.is_contiguous() and not kernels.launch_counts["tc_grid_3xtf32"]
    want = np.einsum(f"{a},{b}->{c}", A.double().numpy(), B.double().numpy())
    _close_to_terms(out.numpy(), want, want)


def test_3x_runs_leave_tf32_off():
    """A ``bf16_3x`` program splits in software: TF32 matmul stays off and
    the float32 matmul precision "highest" on both routes."""
    from feinsum_tpu_torch.measure import generate_input_arrays
    e = S.make_div(6)
    arrays = generate_input_arrays(e, long_dim_length=64, seed=34,
                                   device="cpu")
    for backend in ("xla", "pallas"):
        prog = S.default_transform(e)(ft.generate_program(e)).with_descriptor(
            backend=backend, precision="bf16_3x")
        ft.build_executable(prog, long_dim_length=64, device="cpu")(
            ft.apply_layouts(prog, arrays))
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"


def test_dg_rows_3x_smem_formula():
    """The suite's rows fit a Hopper block; S = 4, I = J = 64 with u
    carrying s and four outputs does not."""
    assert kernels.dg_rows_3x_smem_bytes(3, 3, 35, 35, False) \
        <= kernels.MAX_SMEM_BYTES // 2
    assert kernels.dg_rows_3x_smem_bytes(1, 4, 35, 15, True) \
        <= kernels.MAX_SMEM_BYTES // 2
    assert kernels.dg_rows_3x_smem_bytes(4, 4, 64, 64, True) \
        > kernels.MAX_SMEM_BYTES


@pytest.mark.cuda
@pytest.mark.parametrize("X", [1, 2, 3, 4])
@pytest.mark.parametrize("u_has_s", [False, True])
@pytest.mark.parametrize("block_long,out_order,I,J,E", [
    (8, (2, 0, 1), 5, 7, 33), (1024, (0, 1, 2), 35, 35, 2000),
    (100, (1, 2, 0), 60, 15, 777)])
def test_dg_rows_3x_kernel_matches_plain(cuda_device, X, u_has_s,
                                         block_long, out_order, I, J, E):
    rng = np.random.default_rng(35)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device)
    rows = [kernels.DGRow(u=t(3 if u_has_s else 1, J, E), R=t(3, I, J),
                          F=t(X, 3, E)) for _ in range(2)]
    before = kernels.launch_counts["dg_rows_3xtf32"]
    got = kernels.dg_rows_3xtf32(rows, out_order=out_order,
                                 block_long=block_long)
    torch.cuda.synchronize()
    assert kernels.launch_counts["dg_rows_3xtf32"] == before + 1
    for g, want, mag in zip(got, kernels.dg_rows_3x_plain(rows, out_order),
                            kernels.dg_rows_plain(_abs_rows(rows),
                                                  out_order)):
        assert g.is_contiguous()
        _close_to_terms(g.cpu(), want.cpu(), mag.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("one_launch,launches", [(True, 2), (False, 5)])
def test_dg_rows_3x_kernel_splits_rows(cuda_device, one_launch, launches):
    rows = (_dg_rows(cuda_device, seed=36) * 2
            + _dg_rows(cuda_device, seed=37)[:1])
    before = kernels.launch_counts["dg_rows_3xtf32"]
    got = kernels.dg_rows_3xtf32(rows, one_launch=one_launch, block_long=16)
    torch.cuda.synchronize()
    assert kernels.launch_counts["dg_rows_3xtf32"] == before + launches
    for g, want in zip(got, kernels.dg_rows_3x_plain(rows)):
        _close_to_terms(g.cpu(), want.cpu(), want.cpu())


@pytest.mark.cuda
def test_dg_rows_3x_kernel_without_factor(cuda_device):
    rows = [kernels.DGRow(u=r.u, R=r.R, F=None)
            for r in _dg_rows(cuda_device, u_has_s=True, seed=38)]
    got = kernels.dg_rows_3xtf32(rows, block_long=32)
    torch.cuda.synchronize()
    for g, want in zip(got, kernels.dg_rows_3x_plain(rows)):
        _close_to_terms(g.cpu(), want.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("X,S_,I,J,u_has_s", [(3, 3, 35, 35, False),
                                              (1, 4, 35, 15, True),
                                              (1, 1, 60, 35, False),
                                              (4, 4, 64, 64, True)])
def test_dg_rows_3x_smem_formula_matches_the_kernel(cuda_device, X, S_, I,
                                                    J, u_has_s):
    assert _build.load_library().dg_rows_3xtf32_smem_bytes(
        X, S_, I, J, int(u_has_s)) == kernels.dg_rows_3x_smem_bytes(
        X, S_, I, J, u_has_s)


@pytest.mark.cuda
def test_dg_rows_3x_shared_memory_guard(cuda_device):
    rows = _dg_rows(cuda_device, S_=4, I=100, J=100, X=4, u_has_s=True)
    with pytest.raises(ft.InvalidParameterError, match="shared memory"):
        kernels.dg_rows_3xtf32(rows, block_long=32)


@pytest.mark.cuda
@pytest.mark.parametrize("permute", [False, True])
@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tc_grid_3x_kernel_matches_plain(cuda_device, case, permute):
    a, b, c, lengths, grid, grid_m = TC_CASES[case]
    step = kernels.TCStep(a=tuple(a), b=tuple(b), c=tuple(c),
                          lengths=tuple(sorted(lengths.items())), grid=grid,
                          grid_m=grid_m)
    A, B = _tc_operands(cuda_device, a, b, lengths, 39, permute)
    before = kernels.launch_counts["tc_grid_3xtf32"]
    got = kernels.tc_grid_3xtf32(A, B, step)
    torch.cuda.synchronize()
    assert kernels.launch_counts["tc_grid_3xtf32"] == before + 1
    want = kernels.tc_grid_3x_plain(A, B, step)
    assert got.shape == want.shape and got.is_contiguous()
    _close_to_terms(got.cpu(), want.cpu(),
                    kernels.tc_grid_plain(A.abs(), B.abs(), step).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", range(len(kernels.TC_TILES)))
def test_tc_grid_3x_tiles_match_the_kernel(cuda_device, variant):
    lib = _build.load_library()
    assert (lib.tc_grid_3xtf32_tile_rows(variant),
            lib.tc_grid_3xtf32_tile_cols(variant)) == kernels.TC_TILES[variant]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FUSED_ROWS))
def test_rows_validate_on_card_at_bf16_3x(cuda_device, name):
    """The fused route at ``bf16_3x`` against the numpy oracle on the card:
    the rows with a j-dot on ``dg_rows_3xtf32``, the others on their f32
    kernels."""
    e = FUSED_ROWS[name]

    def tr(p):
        return S.default_transform(e)(p).with_descriptor(precision="bf16_3x")
    before = dict(kernels.launch_counts)
    ft.validate_batched_einsum_transform(e, tr, long_dim_length=2000,
                                         device=cuda_device)
    launched = {k for k, n in kernels.launch_counts.items()
                if n != before[k]}
    assert launched
    assert "dg_rows_f32" not in launched


@pytest.mark.cuda
@pytest.mark.parametrize("space,params", [
    ("tc_pallas_v0", dict(n_grid=2, precision_idx=1, use_opt_path=True)),
    ("tc_pallas_v1", dict(n_grid=1, blk0_idx=2, blk1_idx=0, m_pos=3,
                          precision_idx=1)),
    ("tc_pallas_v1", dict(n_grid=2, blk0_idx=9, blk1_idx=1, m_pos=0,
                          precision_idx=1)),
])
def test_tc_spaces_validate_on_card_at_bf16_3x(cuda_device, space, params):
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path
    e = ft.einsum("dfgb,geac->abcdef",
                  ft.array("A", (7, 9, 11, 2), "float32"),
                  ft.array("B", (11, 3, 6, 5), "float32"))
    tr = get_transform_func_from_module_path(space).bind_args(e, **params)
    before = kernels.launch_counts["tc_grid_3xtf32"]
    ft.validate_batched_einsum_transform(e, tr, device=cuda_device)
    assert kernels.launch_counts["tc_grid_3xtf32"] == before + 1

# }}}


# {{{ lane_pack_dg_f32 (the packed DG programs)

# (space, einsum, lane_pack_g): packed DG programs of each variant and
# leading-letter structure (div: variant A; grad: W over (x, r) and three
# outputs; face: u' over f; curl: one W slice for three T slices; mass)
LP_CASES = {
    "div": ("dg_div_v0", lambda: S.make_div(4), 3),
    "div_g32": ("dg_div_v0", lambda: S.make_div(4), 5),
    "grad": ("dg_grad_v0", lambda: S.make_grad(10), 3),
    "face": ("face_mass_v0", lambda: S.make_face_mass(35, 15), 3),
    "curl": ("curl_3d_v0", lambda: S.make_curl(4), 4),
    "mass": ("mass_v0", lambda: S.make_mass(20), 3),
}


def _lp_plan(name, device, E, dofmajor, precision_3x=False, seed=40):
    """(plan, rows) of LP_CASES[name] at E elements, its operands in the
    stored layout on *device*."""
    from feinsum_tpu_torch.codegen.program import get_index_lengths, \
        stored_lengths
    from feinsum_tpu_torch.measure import apply_layouts, \
        generate_input_arrays
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    from feinsum_tpu_torch.ops.lane_pack import expand_residents
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

    space, make, lg = LP_CASES[name]
    e = make()
    prog = get_transform_func_from_module_path(space).bind_args(
        e, **S.space_point(space, e, lane_pack_g=lg, dofmajor=dofmajor,
                           precision_3x=precision_3x))(ft.generate_program(e))
    plan = plan_cuda_launch(prog, stored_lengths(
        prog, get_index_lengths(prog.einsum, E)))
    arrays = generate_input_arrays(e, long_dim_length=E, seed=seed,
                                   device="cpu")
    rows = plan.operands(expand_residents(prog, {
        k: v.to(device) for k, v in apply_layouts(prog, arrays).items()}))
    return plan, rows


def _lp_abs(rows):
    return [replace(r, u=r.u.abs(), T=r.T.abs(), J=r.J.abs(),
                    EXP=r.EXP.abs()) for r in rows]


def test_lane_pack_dg_plain_is_the_three_steps():
    """``lane_pack_dg_plain`` (the CPU route of the wrapper) is V = u'T,
    W = J'EXP and the sum of the terms, as numpy computes them."""
    from feinsum_tpu_torch.ops.lane_pack import lane_pack_dg_shape
    plan, rows = _lp_plan("grad", "cpu", 8 * 40, dofmajor=False)
    assert plan.kernel == "lane_pack_dg_f32"
    shape = kernels.LanePackDGShape(
        u_of_m=(0, 0, 0), j_of_w=tuple(range(9)), exp_of_w=(0,) * 9,
        pairs=tuple(sorted((r, 3 * x + r, x) for x in range(3)
                           for r in range(3))), n_out=3, gi=80)
    outs = kernels.lane_pack_dg_f32(rows, shape, block_long=64,
                                    out_order=(1, 0, 2))
    assert not kernels.launch_counts["lane_pack_dg_f32"]
    (row,), (out,) = rows, outs
    u, T, J, X = (t.double().numpy() for t in (row.u, row.T, row.J,
                                                 row.EXP))
    V = np.einsum("ej,mij->mei", u[0], T)
    W = np.einsum("wek,ki->wei", J, X[0])
    want = np.stack([sum(V[r] * W[3 * x + r] for r in range(3))
                     for x in range(3)]).transpose(1, 0, 2)
    assert out.is_contiguous() and out.shape == (40, 3, 80)
    assert_close(out.numpy(), want)
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path
    e = S.make_grad(10)
    prog = get_transform_func_from_module_path("dg_grad_v0").bind_args(
        e, **S.space_point("dg_grad_v0", e, lane_pack_g=3,
                           dofmajor=False))(ft.generate_program(e))
    assert lane_pack_dg_shape(prog.einsum) == shape


def test_lane_pack_dg_checks_its_operands_and_limits():
    _plan, rows = _lp_plan("div", "cpu", 8 * 20, dofmajor=True)
    shape = kernels.LanePackDGShape(u_of_m=(0, 0, 0), j_of_w=(0, 0, 0),
                                    exp_of_w=(0, 1, 2),
                                    pairs=((0, 0, 0), (1, 1, 0), (2, 2, 0)),
                                    n_out=1, gi=32)
    kernels.lane_pack_dg_f32(rows, shape, block_long=8)
    with pytest.raises(ValueError, match="index maps"):
        kernels.lane_pack_dg_f32(rows, replace(shape, exp_of_w=(0, 1, 3)),
                                 block_long=8)
    with pytest.raises(ValueError, match="index maps"):
        kernels.lane_pack_dg_f32(rows, replace(shape, pairs=(
            (1, 1, 0), (0, 0, 0), (2, 2, 0))), block_long=8)
    with pytest.raises(ValueError, match="shape"):
        kernels.lane_pack_dg_f32(
            [replace(rows[0], T=rows[0].T[:, :, :-1])] + rows[1:], shape,
            block_long=8)
    with pytest.raises(ft.InvalidParameterError, match="at most 16 terms"):
        kernels.check_lane_pack_dg_shape(replace(
            shape, pairs=((0, 0, 0),) * 17))
    with pytest.raises(ft.InvalidParameterError, match="at most 4 T"):
        kernels.check_lane_pack_dg_shape(replace(shape, u_of_m=(0,) * 5))
    assert kernels.lane_pack_dg_smem_bytes(32) == 4 * 16 * (132 + 36)
    assert kernels.lane_pack_dg_smem_bytes(4096, True) \
        == 2 * 4 * 16 * (68 + 68)


def _lp_tol(rows):
    """``RTOL_3X`` grown as sqrt(K / 64) for a contraction K over 64, as
    for the other 3x kernels (the f32 sums of the two orders part by about
    sqrt(K) ulps of the terms)."""
    K = max(rows[0].u.shape[2], rows[0].J.shape[2])
    return RTOL_3X * max(1.0, (K / 64) ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dofmajor", [False, True])
@pytest.mark.parametrize("E_packed,block_long", [(77, 64), (1000, 300),
                                                 (3, 1)])
@pytest.mark.parametrize("name", sorted(LP_CASES))
def test_lane_pack_dg_kernel_matches_plain(cuda_device, name, E_packed,
                                           block_long, dofmajor):
    """``lane_pack_dg_f32`` against its plain version on each packed
    program, in both stored layouts, with ragged E/g tails (77 and 1000
    packed rows against tiles of 64 or 128) and block lengths that are not
    whole tiles."""
    g = 2 ** LP_CASES[name][2]
    plan, rows = _lp_plan(name, cuda_device, g * E_packed, dofmajor)
    assert plan.kernel == "lane_pack_dg_f32"
    from feinsum_tpu_torch.ops.lane_pack import lane_pack_dg_shape
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path
    space, make, lg = LP_CASES[name]
    e = make()
    shape = lane_pack_dg_shape(get_transform_func_from_module_path(
        space).bind_args(e, **S.space_point(space, e, lane_pack_g=lg))(
        ft.generate_program(e)).einsum)
    before = kernels.launch_counts["lane_pack_dg_f32"]
    got = kernels.lane_pack_dg_f32(rows, shape, block_long=block_long,
                                   out_order=(0, 2, 1) if dofmajor
                                   else (0, 1, 2))
    torch.cuda.synchronize()
    assert kernels.launch_counts["lane_pack_dg_f32"] == before + 1
    want = kernels.lane_pack_dg_plain(rows, shape, (0, 2, 1) if dofmajor
                                      else (0, 1, 2))
    for g_, w in zip(got, want):
        assert g_.is_contiguous()
        assert_close(g_.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dofmajor", [False, True])
@pytest.mark.parametrize("name", sorted(LP_CASES))
def test_lane_pack_dg_3x_kernel_matches_plain(cuda_device, name, dofmajor):
    """``lane_pack_dg_3xtf32`` against its plain version relative to the
    sum of the terms' magnitudes, on a ragged tail."""
    g = 2 ** LP_CASES[name][2]
    plan, rows = _lp_plan(name, cuda_device, g * 203, dofmajor,
                          precision_3x=True)
    assert plan.kernel == "lane_pack_dg_3xtf32"
    before = kernels.launch_counts["lane_pack_dg_3xtf32"]
    got = plan.run(rows)
    torch.cuda.synchronize()
    assert kernels.launch_counts["lane_pack_dg_3xtf32"] == before + 1
    for g_, w, mag in zip(got, plan.plain(rows), plan.plain(_lp_abs(rows))):
        _close_to_terms(g_.cpu(), w.cpu(), mag.cpu(),
                        rtol=_lp_tol(rows))


@pytest.mark.cuda
@pytest.mark.parametrize("one_launch,launches", [(True, 2), (False, 5)])
def test_lane_pack_dg_kernel_splits_rows(cuda_device, one_launch, launches):
    """Five rows (div's three and two more) go in launches of at most the
    kernel's four rows."""
    _plan, rows = _lp_plan("div", cuda_device, 8 * 50, dofmajor=True)
    rows = rows + rows[:2]
    shape = kernels.LanePackDGShape(u_of_m=(0, 0, 0), j_of_w=(0, 0, 0),
                                    exp_of_w=(0, 1, 2),
                                    pairs=((0, 0, 0), (1, 1, 0), (2, 2, 0)),
                                    n_out=1, gi=32)
    before = kernels.launch_counts["lane_pack_dg_f32"]
    got = kernels.lane_pack_dg_f32(rows, shape, block_long=64,
                                   one_launch=one_launch)
    torch.cuda.synchronize()
    assert kernels.launch_counts["lane_pack_dg_f32"] == before + launches
    for g_, w in zip(got, kernels.lane_pack_dg_plain(rows, shape)):
        assert_close(g_.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("gi", [8, 32, 33, 4096])
@pytest.mark.parametrize("split", [False, True])
def test_lane_pack_dg_smem_formula_matches_the_kernel(cuda_device, gi,
                                                      split):
    assert _build.load_library().lane_pack_dg_smem_bytes(gi, int(split)) \
        == kernels.lane_pack_dg_smem_bytes(gi, split)
    assert _build.load_library().lane_pack_dg_max_rows() == 4


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LP_CASES))
@pytest.mark.parametrize("precision_3x", [False, True])
def test_lane_pack_programs_validate_on_card(cuda_device, name,
                                             precision_3x):
    """A packed program through ``validate_batched_einsum_transform`` on
    the card: apply_layouts, the residents built on the card, the kernel,
    the packed output against the numpy oracle."""
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path
    space, make, lg = LP_CASES[name]
    e = make()
    tr = get_transform_func_from_module_path(space).bind_args(
        e, **S.space_point(space, e, lane_pack_g=lg,
                           precision_3x=precision_3x))
    kernel = "lane_pack_dg_3xtf32" if precision_3x else "lane_pack_dg_f32"
    before = kernels.launch_counts[kernel]
    ft.validate_batched_einsum_transform(e, tr, long_dim_length=2000,
                                         device=cuda_device)
    assert kernels.launch_counts[kernel] == before + 1

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
        "row_reduce.cu", "long_reduce.cu", "dg_rows_3x.cu", "tc_grid_3x.cu",
        "lane_pack_dg.cu", "step_block.cu", "tc_steps.cu",
        "probe_stream.cu", "probe_apply.cu"}


# {{{ step_block_f32

def _sb_a(name, shape):
    return ft.array(name, shape, "float32")


# programs no row family takes: (einsum, optimal-path schedule)
SB_CASES = {
    "demo_ndof6": (ft.einsum("ij,ejk->eik", _sb_a("A", (6, 6)),
                             _sb_a("B", ("E", 6, 6))), False),
    "demo_ndof35": (ft.einsum("ij,ejk->eik", _sb_a("A", (35, 35)),
                              _sb_a("B", ("E", 35, 35))), False),
    "sumfact_q4": (ft.einsum("ai,bj,ck,eabc->eijk", _sb_a("Ax", (5, 5)),
                             _sb_a("Ay", (5, 5)), _sb_a("Az", (5, 5)),
                             _sb_a("u", ("E", 5, 5, 5))), True),
    "sumfact_q4_one_step": (ft.einsum(
        "ai,bj,ck,eabc->eijk", _sb_a("Ax", (5, 5)), _sb_a("Ay", (5, 5)),
        _sb_a("Az", (5, 5)), _sb_a("u", ("E", 5, 5, 5))), False),
    "broadcast_ndof35": (ft.einsum("ej,e->ej", _sb_a("A", ("E", 35)),
                                   _sb_a("w", ("E",))), False),
    "resident_reduce_ndof35": (ft.einsum("ej,j->", _sb_a("A", ("E", 35)),
                                         _sb_a("w", (35,))), False),
    "two_letter_reduce": (ft.einsum("eij,ejk->ik", _sb_a("P", ("E", 5, 6)),
                                    _sb_a("Q", ("E", 6, 5))), False),
    "gram_ndof120": (ft.einsum("ei,ej->ij", _sb_a("u", ("E", 120)),
                               _sb_a("v", ("E", 120))), False),
    "gram_ndof165": (ft.einsum("ei,ej->ij", _sb_a("u", ("E", 165)),
                               _sb_a("v", ("E", 165))), False),
    "demo_b2": (ft.batched_einsum(
        "ij,ejk->eik", [[_sb_a("A", (5, 5)), _sb_a("B", ("E", 5, 5))],
                        [_sb_a("C", (5, 5)), _sb_a("D", ("E", 5, 5))]]),
        False),
}


def _sb_case(name, device, E, block_long, dofmajor, seed=0):
    """``(rows, table, logical inputs, einsum, program)`` of an SB case."""
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.ops.cuda_emitter import hoist_resident_steps, \
        plan_cuda_launch
    from feinsum_tpu_torch.ops.step_block import plan_step_block
    from feinsum_tpu_torch.tuning.impls._common import fused_pallas_program

    e, hoist = SB_CASES[name]
    prog = fused_pallas_program(ft.generate_program(e), block_long=block_long,
                                hoist=hoist, dofmajor=dofmajor,
                                parallel_grid=False)
    plan = plan_cuda_launch(prog, get_index_lengths(e, E))
    assert plan.kernel == "step_block_f32"
    logical = ft.measure.generate_input_arrays(e, long_dim_length=E,
                                               seed=seed, device=device)
    rows = plan.operands(ft.apply_layouts(prog, logical))
    kp = hoist_resident_steps(prog)[0]
    table = plan_step_block(kp, get_index_lengths(kp.einsum, E))
    return rows, table, logical, e, prog


def test_step_block_on_cpu_runs_the_plain_version():
    """CPU tensors take ``step_block_plain`` (no launch); the wrapper checks
    its operands."""
    rows, table, logical, e, prog = _sb_case("demo_ndof6", "cpu", 40, 16,
                                             True)
    kernels.reset_launch_counts()
    (got,) = kernels.step_block_f32(rows, table, block_long=16)
    assert kernels.launch_counts["step_block_f32"] == 0
    assert_close(got.permute(2, 0, 1).numpy(), np.einsum(
        "ij,ejk->eik", logical["A"].double().numpy(),
        logical["B"].double().numpy()))
    with pytest.raises(ValueError):
        kernels.step_block_f32([rows[0][:1]], table, block_long=16)
    with pytest.raises(ValueError):
        kernels.step_block_f32([[rows[0][0], rows[0][1][:, :, :3]]], table,
                               block_long=16)
    with pytest.raises(ft.InvalidParameterError):
        kernels.step_block_f32([[t.double() for t in rows[0]]], table,
                               block_long=16)


@pytest.mark.cuda
@pytest.mark.parametrize("dofmajor", [False, True])
@pytest.mark.parametrize("E,block_long", [(37, 256), (1003, 64),
                                          (100_003, 512)])
@pytest.mark.parametrize("name", sorted(SB_CASES))
def test_step_block_kernel_matches_plain(cuda_device, name, E, block_long,
                                         dofmajor):
    """Each case in both stored layouts (the kernel's two thread
    mappings): E smaller than one block, a ragged tail, many blocks; against
    ``step_block_plain`` within 2e-5 of max|plain| and the logical einsum
    in float64."""
    rows, table, logical, e, prog = _sb_case(name, cuda_device, E,
                                             block_long, dofmajor, seed=31)
    before = kernels.launch_counts["step_block_f32"]
    got = kernels.step_block_f32(rows, table, block_long=block_long)
    torch.cuda.synchronize()
    assert kernels.launch_counts["step_block_f32"] == before + 1
    subs = e.get_subscripts().replace(" ", "")
    for r, (g, plain) in enumerate(zip(
            got, kernels.step_block_plain(rows, table, block_long))):
        assert g.is_contiguous() and g.shape == plain.shape
        assert_close(g.cpu().numpy(), plain.cpu().numpy())
        want = torch.einsum(subs, *[logical[a.name].double()
                                    for a in e.args[r]])
        if prog.descriptor.out_layout is not None:
            want = want.permute(*prog.descriptor.out_layout)
        assert_close(g.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("one_launch,launches", [(True, 2), (False, 9)])
@pytest.mark.parametrize("reduce", [False, True])
def test_step_block_kernel_splits_rows(cuda_device, one_launch, launches,
                                       reduce):
    """Nine rows: two launches of at most eight rows, or one per row."""
    rows_args = []
    for r in range(9):
        if reduce:
            rows_args.append([_sb_a(f"A{r}", ("E", 5)), _sb_a(f"w{r}", (5,))])
        else:
            rows_args.append([_sb_a(f"A{r}", (5, 5)),
                              _sb_a(f"B{r}", ("E", 5, 5))])
    e = ft.batched_einsum("ej,j->" if reduce else "ij,ejk->eik",
                          rows_args)
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    prog = ft.generate_program(e).with_descriptor(
        backend="pallas", block_long=128,
        multiple_results_in_one_kernel=one_launch)
    plan = plan_cuda_launch(prog, get_index_lengths(e, 999))
    assert plan.kernel == "step_block_f32"
    arrays = ft.measure.generate_input_arrays(e, long_dim_length=999,
                                              seed=32, device=cuda_device)
    rows = plan.operands(arrays)
    before = kernels.launch_counts["step_block_f32"]
    got = plan.run(rows)
    torch.cuda.synchronize()
    assert kernels.launch_counts["step_block_f32"] == before + launches
    for g, want in zip(got, plan.plain(rows)):
        assert_close(g.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_step_block_free_step_on_card(cuda_device):
    """A resident-only step left in the kernel (no hoisting) runs once per
    block in shared memory."""
    from feinsum_tpu_torch.contraction_schedule import (
        ContractionSchedule, EinsumOperand, IntermediateResult)
    e = ft.einsum("rij,ejk->eik", _sb_a("D", (3, 5, 5)),
                  _sb_a("u", ("E", 5, 4)))
    sched = ContractionSchedule(
        ("rij->ij", "ij,ejk->eik"), ("_pre", "_fe_out"),
        ((EinsumOperand(0),), (IntermediateResult("_pre"),
                               EinsumOperand(1))))
    prog = ft.generate_program(e, schedule=sched).with_descriptor(
        backend="pallas", hoist_resident_steps=False, block_long=64)
    ft.validate_batched_einsum_transform(e, lambda p: prog,
                                         long_dim_length=1001,
                                         device=cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("E,block_long", [(37, 256), (100_003, 512)])
def test_step_block_reduce_after_element_step(cuda_device, E, block_long):
    """``ij,ejk->eik`` then ``eik,ek->i``: a reduce after an element step
    on the same sub-tiles (through its offset tables); against
    ``step_block_plain`` and the einsum in float64."""
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.contraction_schedule import (
        ContractionSchedule, EinsumOperand, IntermediateResult)
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    from feinsum_tpu_torch.ops.step_block import plan_step_block
    e = ft.einsum("ij,ejk,ek->i", _sb_a("A", (35, 35)),
                  _sb_a("B", ("E", 35, 20)), _sb_a("w", ("E", 20)))
    sched = ContractionSchedule(
        ("ij,ejk->eik", "eik,ek->i"), ("_t", "_fe_out"),
        ((EinsumOperand(0), EinsumOperand(1)),
         (IntermediateResult("_t"), EinsumOperand(2))))
    prog = ft.generate_program(e, schedule=sched).with_descriptor(
        backend="pallas", hoist_resident_steps=False, block_long=block_long)
    table = plan_step_block(prog, get_index_lengths(e, E))
    assert [(s.kind, s.mode) for s in table.steps] == [
        ("element", "dense"), ("reduce", "general")]
    logical = ft.measure.generate_input_arrays(e, long_dim_length=E,
                                               seed=5, device=cuda_device)
    rows = plan_cuda_launch(prog, get_index_lengths(e, E)).operands(
        ft.apply_layouts(prog, logical))
    (got,) = kernels.step_block_f32(rows, table, block_long=block_long)
    (plain,) = kernels.step_block_plain(rows, table, block_long)
    assert_close(got.cpu().numpy(), plain.cpu().numpy())
    want = torch.einsum("ij,ejk,ek->i", *[logical[n].double()
                                          for n in ("A", "B", "w")])
    assert_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_step_block_shared_memory_guard(cuda_device):
    """A resident over a block's shared memory is refused before launch."""
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    e = ft.einsum("ij,ejk->eik", _sb_a("R", (300, 300)),
                  _sb_a("u", ("E", 300, 2)))
    with pytest.raises(ft.InvalidParameterError, match="shared memory"):
        plan_cuda_launch(ft.generate_program(e).with_descriptor(
            backend="pallas"), get_index_lengths(e, 64))

# }}}


# {{{ the grid letter on step_block_f32 and the row families

# (subscripts, shapes, block, grid_index, kernel): the grid-letter cases of
# tests/test_torch_step_block.py on the card, over several blocks
SB_GRID_CASES = {
    "grid_index_other_letter": ("ij,ejk->eik", ((40, 6), ("E", 6, 6)), 16,
                                "i", "step_block_f32"),
    "two_size_params": ("ij,ejf->eif", ((6, 6), ("E", 6, "F")), 64, None,
                        "step_block_f32"),
    "concrete_4096": ("ij,ejk->eik", ((6, 6), (4096, 6, 6)), 512, None,
                      "step_block_f32"),
    "concrete_4096_matvec": ("ej,ij->ei", ((4096, 6), (5, 6)), 512, None,
                             "dg_rows_f32"),
    "concrete_64": ("ij,ejk->eik", ((6, 6), (64, 6, 6)), 64, None,
                    "step_block_f32"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SB_GRID_CASES))
def test_grid_letter_runs_on_card(cuda_device, name):
    """A program gridded over another letter than its long one, over one of
    two long letters, over a concrete letter, or without a grid runs on its
    kernel against the plain version and the einsum in float64."""
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    subs, shapes, block, grid, kernel = SB_GRID_CASES[name]
    e = ft.einsum(subs, *[_sb_a(n, s) for n, s in zip("AB", shapes)])
    prog = ft.generate_program(e).with_descriptor(
        backend="pallas", block_long=block, grid_index=grid)
    plan = plan_cuda_launch(prog, get_index_lengths(e, 300))
    assert plan.kernel == kernel
    logical = ft.measure.generate_input_arrays(e, long_dim_length=300,
                                               seed=33, device=cuda_device)
    rows = plan.operands(ft.apply_layouts(prog, logical))
    before = kernels.launch_counts[kernel]
    (got,) = plan.run(rows)
    torch.cuda.synchronize()
    assert kernels.launch_counts[kernel] == before + 1
    (want,) = plan.plain(rows)
    assert_close(got.cpu().numpy(), want.cpu().numpy())
    assert_close(got.cpu().numpy(), torch.einsum(subs, *[
        logical[a.name].double() for a in e.args[0]]).cpu().numpy())

# }}}


# {{{ wide-resident matvecs on probe_apply

# (space, einsum, lane_pack_g): packed matvecs and a vecmat whose kron
# resident exceeds dg_rows_f32's shared memory (g·d = 640 and 560), a
# tc_gemm_v0 row whose resident factor does
WIDE_CASES = {
    "matvec20_g32": (lambda: S.make_matvec(20), 5),
    "vecmat35_g16": (lambda: ft.einsum(
        "ej,j->e", ft.array("A", ("E", 35), "float32"),
        ft.array("x", (35,), "float32")), 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("precision_3x", [False, True])
@pytest.mark.parametrize("dofmajor", [False, True])
@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_wide_resident_runs_on_probe_apply(cuda_device, name, dofmajor,
                                           precision_3x):
    """A packed matvec whose kron resident exceeds ``dg_rows_f32``'s shared
    memory runs on ``probe_apply_f32`` (``probe_apply_3xtf32`` at
    ``bf16_3x``), against its plain version, in both stored layouts."""
    from feinsum_tpu_torch.codegen.program import get_index_lengths, \
        stored_lengths
    from feinsum_tpu_torch.measure import apply_layouts, \
        generate_input_arrays
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    from feinsum_tpu_torch.ops.lane_pack import expand_residents
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

    make, lg = WIDE_CASES[name]
    e = make()
    prog = get_transform_func_from_module_path("mass_v0").bind_args(
        e, **S.space_point("mass_v0", e, lane_pack_g=lg, dofmajor=dofmajor,
                           precision_3x=precision_3x))(ft.generate_program(e))
    E = 2 ** lg * 1001
    plan = plan_cuda_launch(prog, stored_lengths(
        prog, get_index_lengths(prog.einsum, E)))
    kernel = "probe_apply_3xtf32" if precision_3x else "probe_apply_f32"
    assert plan.kernel == kernel
    arrays = generate_input_arrays(e, long_dim_length=E, seed=34,
                                   device="cpu")
    rows = plan.operands(expand_residents(prog, {
        k: v.to(cuda_device) for k, v in apply_layouts(prog,
                                                        arrays).items()}))
    before = kernels.launch_counts[kernel]
    got = plan.run(rows)
    torch.cuda.synchronize()
    assert kernels.launch_counts[kernel] == before + 1
    for g_, w in zip(got, plan.plain(rows)):
        assert g_.shape == w.shape
        assert_close(g_.cpu(), w.cpu())


@pytest.mark.cuda
def test_tc_gemm_wide_resident_on_probe_apply(cuda_device):
    """A ``tc_gemm_v0`` row whose (300, 400) resident factor exceeds
    ``dg_rows_f32``'s shared memory validates on ``probe_apply_f32``."""
    from feinsum_tpu_torch.codegen.program import get_index_lengths, \
        stored_lengths
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path
    e = ft.einsum("ik,kj->ij", ft.array("A", (4096, 400), "float32"),
                  ft.array("B", (400, 300), "float32"))
    tr = get_transform_func_from_module_path("tc_gemm_v0").bind_args(
        e, log2_block=8, backend_pallas=True, precision_idx=0, swap=False)
    prog = tr(ft.generate_program(e))
    assert plan_cuda_launch(prog, stored_lengths(prog, get_index_lengths(
        prog.einsum, 1))).kernel == "probe_apply_f32"
    before = kernels.launch_counts["probe_apply_f32"]
    ft.validate_batched_einsum_transform(e, tr, device=cuda_device)
    assert kernels.launch_counts["probe_apply_f32"] > before

# }}}


# {{{ tc_steps_f32

def _ts_program(subs, shapes, grid, blocks=(), permuted=False, rows=1,
                opt=True):
    """A dense program of *rows* rows on ``tc_steps_f32``: the optimal path
    (or the trivial one-step schedule) gridded over *grid* with *blocks*;
    *permuted* stores every operand and the output reversed."""
    names = [[f"{chr(ord('A') + p)}{r}" for p in range(len(shapes))]
             for r in range(rows)]
    e = ft.batched_einsum(subs, [[ft.array(n, s, "float32")
                                  for n, s in zip(row, shapes)]
                                 for row in names])
    prog = (ft.generate_program_with_opt_einsum_schedule(e) if opt
            else ft.generate_program(e)).with_descriptor(
        backend="pallas", grid_index=tuple(grid), grid_blocks=tuple(blocks))
    if permuted:
        prog = prog.with_descriptor(
            arg_layouts=tuple((a.name, tuple(reversed(range(len(idx)))))
                              for row in e.args
                              for a, idx in zip(row, e.in_idx_sets)),
            out_layout=tuple(reversed(range(len(e.out_idx_set)))))
    return e, prog


# ragged extents, a block on a batch letter, stored permutations, b = 2,
# the trivial one-step schedule of four operands, and two suite rows at
# widths the card runs in a moment
TS_CASES = {
    "ragged_chain": ("abc,cd,de->abe", ((3, 5, 7), (7, 5), (5, 3)), "ab",
                     (("b", 5),), False, 1, True),
    "batch_block_triple": ("eij,ejk,ekl->eil",
                           ((120, 3, 5), (120, 5, 7), (120, 7, 3)), "e",
                           (("e", 4),), False, 1, True),
    "permuted_sumfact": ("ai,bj,ck,eabc->eijk",
                         ((3, 5), (5, 7), (7, 3), (600, 3, 5, 7)), "ei",
                         (("e", 2),), True, 1, True),
    "b2_two_operators": ("abcd,de,ef->abcf",
                         ((8, 6, 5, 7), (7, 3), (3, 6)), "ab", (("a", 2),),
                         True, 2, True),
    "trivial_four_operands": ("ai,bj,ck,eabc->eijk",
                              ((3, 5), (5, 7), (7, 3), (40, 3, 5, 7)), "e",
                              (), False, 1, False),
    "sumfact_q4": ("ai,bj,ck,eabc->eijk",
                   ((5, 5), (5, 5), (5, 5), (20_000, 5, 5, 5)), "e",
                   (("e", 8),), False, 1, True),
    "two_operators": ("abcd,de,ef->abcf",
                      ((16, 16, 64, 256), (256, 64), (64, 256)), "ab",
                      (("b", 4),), False, 1, True),
}


def test_tc_steps_on_cpu_runs_the_plain_version():
    """CPU tensors take ``tc_steps_plain`` (no launch); the wrapper checks
    its operands."""
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.ops.tc_emitter import plan_tc_launch
    from feinsum_tpu_torch.ops.tc_steps import plan_tc_steps
    e, prog = _ts_program(*TS_CASES["ragged_chain"])
    table = plan_tc_steps(prog, get_index_lengths(e, 1))
    plan = plan_tc_launch(prog, get_index_lengths(e, 1))
    logical = ft.measure.generate_input_arrays(e, long_dim_length=1, seed=5,
                                               device="cpu")
    (ops,) = plan.operands(ft.apply_layouts(prog, logical))
    kernels.reset_launch_counts()
    got = kernels.tc_steps_f32(ops, table)
    assert kernels.launch_counts["tc_steps_f32"] == 0
    assert got.is_contiguous()
    assert_close(got.numpy(), np.einsum(
        "abc,cd,de->abe", *[logical[a.name].double().numpy()
                            for a in e.args[0]]))
    with pytest.raises(ValueError):
        kernels.tc_steps_f32(ops[:2], table)
    with pytest.raises(ValueError):
        kernels.tc_steps_f32([ops[0][:, :, :3], *ops[1:]], table)
    with pytest.raises(ft.InvalidParameterError):
        kernels.tc_steps_f32([t.double() for t in ops], table)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TS_CASES))
def test_tc_steps_kernel_matches_plain(cuda_device, name):
    """Each case on the card against ``tc_steps_plain`` within 2e-5 of
    max|plain| and against the logical einsum in float64; one launch per
    row."""
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.ops.tc_emitter import plan_tc_launch
    e, prog = _ts_program(*TS_CASES[name])
    plan = plan_tc_launch(prog, get_index_lengths(e, 1))
    assert plan.kernel == "tc_steps_f32"
    logical = ft.measure.generate_input_arrays(e, long_dim_length=1,
                                               seed=33, device=cuda_device)
    rows = plan.operands(ft.apply_layouts(prog, logical))
    before = kernels.launch_counts["tc_steps_f32"]
    got = plan.run(rows)
    torch.cuda.synchronize()
    assert kernels.launch_counts["tc_steps_f32"] == before + e.b
    subs = e.get_subscripts().replace(" ", "")
    for r, (g, plain) in enumerate(zip(got, plan.plain(rows))):
        assert g.is_contiguous() and g.shape == plain.shape
        assert_close(g.cpu().numpy(), plain.cpu().numpy())
        want = torch.einsum(subs, *[logical[a.name].double()
                                    for a in e.args[r]])
        if prog.descriptor.out_layout is not None:
            want = want.permute(*prog.descriptor.out_layout)
        assert_close(g.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_tc_steps_spaces_validate_on_card(cuda_device):
    """A point of each TC space on sum factorization and two operators
    validates on the card against the numpy oracle through
    ``tc_steps_f32``."""
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path
    for e, space, params in (
            (S.make_sum_factorization(E=2000), "tc_pallas_v0",
             dict(n_grid=1, precision_idx=0, use_opt_path=True)),
            (S.make_sum_factorization(E=2000), "tc_pallas_v1",
             dict(n_grid=1, blk0_idx=4, blk1_idx=0, m_pos=3,
                  precision_idx=0, use_opt_path=True)),
            (S.make_two_operators(), "tc_pallas_v1",
             dict(n_grid=2, blk0_idx=0, blk1_idx=2, m_pos=3,
                  precision_idx=0, use_opt_path=True))):
        tr = get_transform_func_from_module_path(space).bind_args(e,
                                                                  **params)
        before = kernels.launch_counts["tc_steps_f32"]
        ft.validate_batched_einsum_transform(e, tr, device=cuda_device)
        assert kernels.launch_counts["tc_steps_f32"] == before + 1

# }}}


# {{{ the probe kernels

def _probe_tensor(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device)


def _probe_apply_rows(device, storage, b, S_, I, K, E, sigma, seed=0):
    """``(rows, R, runs, out_elem_major)`` of the contraction probe: u
    dof-major (K, E), element-major (E, K) viewed (K, E), or dof-major
    under the folded mapping I (runs = 8); J (S, E) for S > 1; sigma
    (I1, I2, E) broadcast over I1 (the kron matvec's jac) or over I2 (the
    lane-reshape probe's j)."""
    from feinsum_tpu_torch.ops.probe_kernels import ApplyRow
    rng = np.random.default_rng(seed)
    R = _probe_tensor(rng, (S_, I, K), device)
    I2 = {35: 7, 280: 8, 640: 10, 20: 5}[I]
    rows = []
    for _ in range(b):
        if storage == "element-major":
            u = _probe_tensor(rng, (E, K), device).t()
        else:
            u = _probe_tensor(rng, (K, E), device)
        J = _probe_tensor(rng, (S_, E), device) if S_ > 1 else None
        sg = None
        if sigma == "jac":
            sg = _probe_tensor(rng, (I2, E), device)[None].expand(
                I // I2, I2, E)
        elif sigma == "lane":
            sg = _probe_tensor(rng, (E, I // I2), device).t()[:, None,
                                                            :].expand(
                I // I2, I2, E)
        rows.append(ApplyRow(u=u, J=J, sigma=sg))
    return (rows, R, 8 if storage == "folded I" else 1,
            storage == "element-major")


PROBE_APPLY_SHAPES = {"div35": (3, 35, 35), "mv20": (1, 20, 20),
                      "kron280": (1, 280, 280), "lane640": (1, 640, 640)}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "3x"])
@pytest.mark.parametrize("sigma", [None, "jac", "lane"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("shape", sorted(PROBE_APPLY_SHAPES))
@pytest.mark.parametrize("storage", ["dof-major", "element-major",
                                     "folded I"])
def test_probe_apply_kernel_matches_plain(cuda_device, storage, shape, b,
                                          sigma, precision):
    """``probe_apply_f32`` / ``probe_apply_3xtf32`` against their plain
    versions on ragged E (777; 776 = 8 x 97 under the folded mapping I), in
    every storage, b = 1 and 3 rows, with sigma and without: f32 within
    2e-5 of max|plain|, 3x within 1e-6 (times sqrt(S K / 64)) of the sum of
    the terms' magnitudes."""
    from feinsum_tpu_torch.ops import probe_kernels as pk
    S_, I, K = PROBE_APPLY_SHAPES[shape]
    E = 776 if storage == "folded I" else 777
    rows, R, runs, out_em = _probe_apply_rows(cuda_device, storage, b, S_,
                                              I, K, E, sigma)
    kern, plain = ((pk.probe_apply_3xtf32, pk.probe_apply_3x_plain)
                   if precision == "3x"
                   else (pk.probe_apply_f32, pk.probe_apply_plain))
    before = kernels.launch_counts[kern.__name__]
    got = kern(rows, R, runs=runs, out_elem_major=out_em)
    assert kernels.launch_counts[kern.__name__] == before + 1
    want = plain(rows, R, out_elem_major=out_em)
    torch.cuda.synchronize()
    mags = [replace(r, u=r.u.abs(), J=None if r.J is None else r.J.abs(),
                    sigma=None if r.sigma is None else r.sigma.abs())
            for r in rows]
    terms = pk.probe_apply_plain(mags, R.abs(), out_elem_major=out_em)
    assert len(got) == b
    for g, w, t in zip(got, want, terms):
        assert g.shape == (I, E)
        assert g.stride() == w.stride()
        if precision == "f32":
            assert_close(g.cpu().numpy(), w.cpu().numpy())
        else:
            over = float(((g - w).abs().double()
                          / t.double().clamp_min(1e-300)).max())
            assert over <= 1e-6 * max(1.0, (S_ * K / 64) ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("runs,block_elems", [(1, 0), (1, 512), (1, 8192),
                                               (8, 0), (8, 2048)])
def test_probe_apply_kernel_tilings(cuda_device, runs, block_elems):
    """The element tilings (elements per thread block, mapping I and III)
    give the plain version's result on the folded div."""
    from feinsum_tpu_torch.ops import probe_kernels as pk
    rows, R, _, _ = _probe_apply_rows(cuda_device, "dof-major", 1, 3, 35,
                                      35, 8 * 1000, None)
    got = pk.probe_apply_f32(rows, R, runs=runs, block_elems=block_elems)
    want = pk.probe_apply_plain(rows, R)
    torch.cuda.synchronize()
    assert_close(got[0].cpu().numpy(), want[0].cpu().numpy())


def _stream_ops(case, device, E=777, seed=0):
    """``(ops, alpha)`` of a stream case."""
    rng = np.random.default_rng(seed)
    if case == "copy":
        return [_probe_tensor(rng, (E, 35), device),
                _probe_tensor(rng, (E, 35), device)], 1.0
    if case == "copy_aligned":
        return [_probe_tensor(rng, (E + 3, 35), device)[:(E + 3) // 4 * 4],
                _probe_tensor(rng, (E + 3, 35), device)[:(E + 3) // 4 * 4]
                ], 1.0
    if case == "copy_offset":
        a = _probe_tensor(rng, (E * 35 + 1,), device)[1:].view(E, 35)
        return [a, _probe_tensor(rng, (E, 35), device)], 1.0
    if case == "copy_offset_flat":
        a = _probe_tensor(rng, (780 * 35 + 1,), device)[1:].view(780, 35)
        return [a, _probe_tensor(rng, (780, 35), device)], 1.0
    if case == "transpose_long":
        return [_probe_tensor(rng, (300, 200), device).t()], 1.0
    if case == "batched_transpose":
        return [_probe_tensor(rng, (3, E, 35), device).permute(0, 2, 1)], 1.0
    if case == "to_dof_major":
        return [_probe_tensor(rng, (E, 35), device).t()], 1.0
    if case == "to_element_major":
        return [_probe_tensor(rng, (35, E), device).t()], 1.0
    if case == "scale":
        return [_probe_tensor(rng, (E, 64), device)], 2.0
    if case.startswith("lane_b"):
        d = int(case[len("lane_b"):])
        rows, g = E, 16
        x = _probe_tensor(rng, (rows, g * d), device).view(rows, g, d)
        j = _probe_tensor(rng, (rows, g), device)[:, :, None].expand(
            rows, g, d)
        return [x, j], 1.0
    if case == "transposed_times_broadcast":
        a = _probe_tensor(rng, (E, 35), device).t()
        w = _probe_tensor(rng, (E,), device)[None].expand(35, E)
        return [a, w], 1.0
    raise KeyError(case)


PROBE_STREAM_CASES = ("copy", "copy_aligned", "copy_offset",
                      "copy_offset_flat", "transpose_long",
                      "batched_transpose", "to_dof_major",
                      "to_element_major", "scale", "lane_b4", "lane_b10",
                      "transposed_times_broadcast")


@pytest.mark.cuda
@pytest.mark.parametrize("block_elems", [0, 4096])
@pytest.mark.parametrize("case", PROBE_STREAM_CASES)
def test_probe_stream_kernel_matches_plain(cuda_device, case, block_elems):
    """``probe_stream_f32`` equals its plain version exactly (the same
    products in the same order) on every path: flat4, scalar (ragged and
    misaligned) and the transposing tile, broadcasts by stride 0."""
    from feinsum_tpu_torch.ops import probe_kernels as pk
    ops, alpha = _stream_ops(case, cuda_device)
    before = kernels.launch_counts["probe_stream_f32"]
    got = pk.probe_stream_f32(ops, alpha=alpha, block_elems=block_elems)
    assert kernels.launch_counts["probe_stream_f32"] == before + 1
    want = pk.probe_stream_plain(ops, alpha=alpha)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, want)

# }}}

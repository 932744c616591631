"""The port's kernel wrappers (``feinsum_tpu_torch/ops/kernels.py``): their
operand checks and plain versions on CPU tensors, and, in the tests marked
``cuda``, the hand-written kernels against their plain versions on the
card.  This file imports no JAX, so it runs where only PyTorch is
installed; on such a machine run it without the JAX-importing conftest:

    python -m pytest tests/test_torch_kernels.py --noconftest -m cuda
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import feinsum_tpu_torch as ft
from feinsum_tpu_torch import suite as S
from feinsum_tpu_torch.ops import _build, kernels

RTOL = 2e-5


def assert_close(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale)


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


# the suite rows and the extended suite's DG rows (P1-P3 widths, curl)
FUSED_ROWS = dict(S.suite() + [(name, e) for name, e in S.extended_suite()
                               if name.startswith("dg_")])


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
        "dg_rows.cu", "ew_product.cu"}

"""The model step's state update (``ops.kernels.step_update``) and the
one-pass pair split (``ops.kernels.pairs_split``): on the CPU, the plain
branch against the PyTorch glue the wave and Maxwell steps ran before it,
bit for bit, the wrapper's refusals, its *out* (the result written into
rows of a larger tensor), rows at two strides and per-group weights (the
viscoelastic ADER step's forms) and the ``pair_bytes`` counts; in the
tests marked ``cuda``, the kernels against their plain versions on the
card bit for bit, and chained model steps against the same steps with the
PyTorch glue.  This file imports no JAX; on a machine without it run

    python -m pytest tests/test_torch_step_update.py --noconftest -m cuda
"""

from __future__ import annotations

import pytest
import torch

import feinsum_tpu_torch as ft
from feinsum_tpu_torch import tracing
from feinsum_tpu_torch.codegen.program import build_executable
from feinsum_tpu_torch.models import common
from feinsum_tpu_torch.models.maxwell import make_maxwell_state
from feinsum_tpu_torch.models.wave import make_wave_state
from feinsum_tpu_torch.ops import dd_emitter, kernels
from feinsum_tpu_torch.ops.dd_emitter import combine_pairs

P = 35
DT = 1e-3


def _rand(*shape, dtype=torch.float32, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (2 * torch.rand(shape, generator=gen, dtype=torch.float64)
            - 1).to(dtype).to(device)


def _pair(*shape, device="cpu", seed=0):
    """A (2, ...) hi/lo pair of random float64 values."""
    return kernels.pairs_split_plain(_rand(*shape, dtype=torch.float64,
                                           seed=seed)).to(device)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.cpu(), b.cpu())


# {{{ the plain branch against the glue it replaces

def _wave_glue(u, v, rows, grad, lift, dt, conv):
    """The wave steps' glue before ``step_update`` (``conv``: the identity,
    or ``combine_pairs`` on pair storage)."""
    vx, vy, vz = rows
    div_v = conv(vx) + conv(vy) + conv(vz)
    return u + dt * (div_v + conv(lift)), v + dt * conv(grad)


def _curl_glue(rows, conv):
    rows = [conv(r) for r in rows]
    return torch.stack([rows[0] - rows[1], rows[2] - rows[3],
                        rows[4] - rows[5]])


# the storages: base and terms float32; both float64 (the models' plain
# per-step route, ``step_update_plain`` alone); a float64 base and float32
# pair terms
STORAGES = {"float32": (torch.float32, False),
            "float64": (torch.float64, False),
            "pairs": (torch.float64, True)}
KERNEL_STORAGES = ("float32", "pairs")


def _updates(storage):
    """The functions that take *storage*: the plain version, and the
    wrapper where its kernel takes it."""
    if storage in KERNEL_STORAGES:
        return kernels.step_update_plain, kernels.step_update
    return (kernels.step_update_plain,)


@pytest.mark.parametrize("storage", sorted(STORAGES))
@pytest.mark.parametrize("E", [1, 7, 64])
def test_wave_forms_equal_the_glue(storage, E):
    dtype, pairs = STORAGES[storage]
    term = (lambda *s, seed: _pair(*s, seed=seed)) if pairs else \
        (lambda *s, seed: _rand(*s, dtype=dtype, seed=seed))
    conv = combine_pairs if pairs else (lambda t: t)
    u, v = _rand(P, E, dtype=dtype, seed=1), _rand(3, P, E, dtype=dtype,
                                                   seed=2)
    rows = [term(P, E, seed=3 + x) for x in range(3)]
    grad, lift = term(3, P, E, seed=6), term(P, E, seed=7)
    want_u, want_v = _wave_glue(u, v, rows, grad, lift, DT, conv)
    grads = [grad[:, x] if pairs else grad[x] for x in range(3)]
    for update in _updates(storage):
        _same(update(u, [*rows, lift], DT), want_u)
        _same(update(v, [grads], DT), want_v)


@pytest.mark.parametrize("storage", sorted(STORAGES))
def test_maxwell_forms_equal_the_glue(storage):
    E = 33
    dtype, pairs = STORAGES[storage]
    conv = combine_pairs if pairs else (lambda t: t)
    e, h = (_rand(3, P, E, dtype=dtype, seed=s) for s in (1, 2))
    rows = [_pair(P, E, seed=3 + k) if pairs
            else _rand(P, E, dtype=dtype, seed=3 + k) for k in range(6)]
    curl = _curl_glue(rows, conv)
    for base, dt, want in ((e, DT, e + DT * curl), (h, -DT, h - DT * curl)):
        for update in _updates(storage):
            _same(update(base, [rows[0::2], rows[1::2]], dt, signs=(1, -1)),
                  want)


def test_a_leading_negative_sign_negates_the_first_term():
    b, t0, t1 = (_rand(4, 9, seed=s) for s in range(3))
    _same(kernels.step_update(b, [t0, t1], 0.25, signs=(-1, 1)),
          b + 0.25 * (-t0 + t1))


def test_the_models_steps_equal_their_glue_on_the_cpu():
    """A chained float32 and float64 wave and Maxwell step, the float64 on
    pairs and on the plain per-step route, against the same steps with the
    glue put back."""
    for cls, make_state in ((ft.WaveOperator3D, make_wave_state),
                            (ft.MaxwellOperator3D, make_maxwell_state)):
        for dtype, use_pallas in (("float32", True), ("float64", True),
                                  ("float64", False)):
            op = cls(dtype=dtype, use_pallas=use_pallas)
            state, geom = make_state(96, dtype=dtype, seed=5, device="cpu")
            got = want = state
            step = op.make_step(96)
            for _ in range(3):
                got = step(got, geom)
            with _glue_steps():
                step = op.make_step(96)
                for _ in range(3):
                    want = step(want, geom)
            for k in got:
                _same(got[k], want[k])


@pytest.mark.parametrize("model", ["wave", "maxwell"])
def test_a_float64_step_is_its_pair_formula(model):
    """A float64 step, its storage chosen by ``common.StepStorage``, bit
    for bit the step written out on pairs: state and geometry split, each
    field's component x read as the view ``pair[:, x]``, and the glue on
    the einsums' pair outputs."""
    E = 64
    split = kernels.pairs_split_plain
    if model == "wave":
        op = ft.WaveOperator3D(dtype="float64")
        state, geom = make_wave_state(E, dtype="float64", seed=7,
                                      device="cpu")
        fns = op.executables(E)
        g = {k: split(t) for k, t in geom.items()}
        us, vp = split(state["u"]), split(state["v"])
        (grad,) = fns["grad"]({"J": g["J"], "D": g["D"], "u": us})
        rows = fns["div"]({"Jx": g["Jx"], "Jy": g["Jy"], "Jz": g["Jz"],
                           "D": g["D"], "vx": vp[:, 0], "vy": vp[:, 1],
                           "vz": vp[:, 2]})
        (flux,) = fns["restrict"]({"R": g["Rface"], "u": us})
        (lift,) = fns["face"]({"L": g["L"], "Fj": g["Fj"], "flux": flux})
        want = dict(zip("uv", _wave_glue(state["u"], state["v"], rows, grad,
                                         lift, DT, combine_pairs)))
    else:
        op = ft.MaxwellOperator3D(dtype="float64")
        state, geom = make_maxwell_state(E, dtype="float64", seed=7,
                                         device="cpu")
        fn = build_executable(op.program, long_dim_length=E)
        g = {k: split(t) for k, t in geom.items()}

        def curl(field):
            fp = split(field)
            return _curl_glue(fn({"Jx": g["Jx"], "Jy": g["Jy"],
                                  "Jz": g["Jz"], "D": g["D"],
                                  "Fx": fp[:, 0], "Fy": fp[:, 1],
                                  "Fz": fp[:, 2]}), combine_pairs)
        e, h = state["E"], state["H"]
        want = {"E": e + DT * curl(h), "H": h - DT * curl(e)}
    got = op.make_step(E, dt=DT)(state, geom)
    assert sorted(got) == sorted(want)
    for k in got:
        _same(got[k], want[k])


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_the_plain_route_updates_with_the_plain_version(dtype, use_pallas):
    """The plain per-step route runs no hand-written kernel, the update's
    neither: its steps update with ``step_update_plain``, the fused
    kernels' steps with ``step_update``."""
    want = kernels.step_update if use_pallas else kernels.step_update_plain
    wave = ft.WaveOperator3D(dtype=dtype, use_pallas=use_pallas)
    curl = ft.MaxwellOperator3D(dtype=dtype, use_pallas=use_pallas)
    assert common.state_update(wave.programs.values()) is want
    assert common.state_update([curl.program]) is want

# }}}


# {{{ refusals

def _bad_cases():
    b, t = _rand(P, 16), _rand(P, 16)
    b3 = _rand(3, P, 16)
    wide = _rand(P, 32)
    return {
        "base dtype": (b.half(), [t], "base"),
        "term dtype": (b, [t.double()], "term 0"),
        "term not a pair": (b.double(), [t], "term 0"),
        "term device": (b, [t.to("meta")], "term 0 lies on meta"),
        "term shape": (b, [t[:, :8]], "term 0: shape"),
        "base E stride": (wide[:, ::2], [t], "base: stride 2 along E"),
        "term E stride": (b, [t.t().contiguous().t()], "term 0: stride"),
        "group term a tensor": (b3, [_rand(3, P, 16)], "term 0: a Tensor"),
        "group count": (b3, [[t, t]], "term 0: 2, expected"),
        "float64 terms": (b.double(), [t.double()], "term 0: .* pairs"),
        "group term": (b3, [[t, t, t[:, :3]]], "term 0 of group 2"),
        "base axes": (b[0], [t[0]], "base: shape"),
        "no term": (b, [], "1 to 4 terms"),
        "five terms": (b, [t] * 5, "1 to 4 terms"),
        "four groups": (_rand(4, P, 16), [_rand(4, P, 16)], "at most 3"),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_the_wrapper_refuses_naming_the_operand(case):
    base, terms, match = _bad_cases()[case]
    with pytest.raises(ft.InvalidParameterError, match=match):
        kernels.step_update(base, terms, DT)


@pytest.mark.parametrize("signs", [(1,), (1, 0), (2, -1)])
def test_the_wrapper_refuses_bad_signs(signs):
    b = _rand(P, 8)
    with pytest.raises(ft.InvalidParameterError, match="signs"):
        kernels.step_update(b, [b, b], DT, signs=signs)


@pytest.mark.parametrize("storage", sorted(STORAGES))
def test_out_takes_the_result_in_rows_of_a_larger_tensor(storage):
    """With *out*, the update writes into it (here a band of rows of a
    larger tensor, as the ADER step's time integral writes its bands) and
    returns it, the same values as a new tensor; the rest of the larger
    tensor is left as it was."""
    dtype, pairs = STORAGES[storage]
    base = _rand(P, 16, dtype=dtype)
    terms = [_pair(P, 16, seed=k) if pairs else _rand(P, 16, dtype=dtype,
                                                      seed=k)
             for k in (1, 2)]
    for update in _updates(storage):
        want = update(base, terms, DT, signs=(1, -1))
        whole = torch.full((2 * P, 16), 7.0, dtype=dtype)
        got = update(base, terms, DT, signs=(1, -1), out=whole[3:3 + P])
        assert got.data_ptr() == whole[3].data_ptr()
        _same(whole[3:3 + P], want)
        assert bool((whole[:3] == 7).all() and (whole[3 + P:] == 7).all())


@pytest.mark.parametrize("case", ["shape", "dtype", "E stride"])
def test_out_is_checked_as_the_base_is(case):
    b, t = _rand(P, 16), _rand(P, 16)
    out = {"shape": torch.empty(P, 8), "dtype": torch.empty(P, 16).double(),
           "E stride": torch.empty(P, 32)[:, ::2]}[case]
    for update in (kernels.step_update, kernels.step_update_plain):
        with pytest.raises(ft.InvalidParameterError, match="out"):
            update(b, [t], DT, out=out)


def test_pairs_split_refuses_what_is_not_float64():
    with pytest.raises(ft.InvalidParameterError, match="float64"):
        kernels.pairs_split(_rand(4, 8))


def test_pairs_split_refuses_a_strided_tensor():
    """``pairs_split`` takes a contiguous tensor; ``split_to_pairs`` makes
    any other one contiguous first."""
    x = _rand(4, 8, dtype=torch.float64)[:, ::2]
    with pytest.raises(ft.InvalidParameterError, match="contiguous"):
        kernels.pairs_split(x)
    _same(dd_emitter.split_to_pairs(x), kernels.pairs_split_plain(x))

# }}}


# {{{ counts

def test_pair_bytes_count_a_split_at_16_and_a_fused_combine_at_8():
    c = tracing.counters
    E = 40
    start = c["pair_bytes"]
    common.to_pairs(_rand(3, P, E, dtype=torch.float64))
    assert c["pair_bytes"] - start == 16 * 3 * P * E
    start = c["pair_bytes"]
    kernels.step_update(_rand(P, E, dtype=torch.float64),
                        [_pair(P, E), _pair(P, E, seed=1)], DT)
    assert c["pair_bytes"] - start == 8 * 2 * P * E
    start = c["pair_bytes"]
    kernels.step_update(_rand(P, E), [_rand(P, E)], DT)   # float32: none
    assert c["pair_bytes"] == start


def test_pairs_split_plain_is_the_two_pass_split():
    x = _rand(5, 77, dtype=torch.float64, seed=9) * 1e3
    got = kernels.pairs_split(x)
    _same(got[0], x.float())
    _same(got[1], (x - x.float().double()).float())
    _same(dd_emitter.split_to_pairs(x), got)

# }}}


# {{{ on the card

class _glue_steps:
    """The models' steps with the PyTorch glue put back: the update's and
    the split's plain versions, on whatever device the tensors lie."""

    def __enter__(self):
        self.saved = (kernels.step_update, kernels.pairs_split)
        kernels.step_update = kernels.step_update_plain
        kernels.pairs_split = kernels.pairs_split_plain

    def __exit__(self, *exc):
        kernels.step_update, kernels.pairs_split = self.saved


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is"
                    " false)")
    return torch.device("cuda")


def _strided(t, pad):
    """*t* (..., R, E) as a view with *pad* more entries between rows."""
    wide = torch.zeros((*t.shape[:-1], t.shape[-1] + pad), dtype=t.dtype,
                       device=t.device)
    wide[..., :t.shape[-1]] = t
    return wide[..., :t.shape[-1]]


def _pad(E, layout):
    """Entries between rows: none, enough for rows on 16 bytes (the
    vector path, with a scalar tail where E % 4 > 0), or rows off 16
    bytes (the scalar path)."""
    return {"contiguous": 0, "row-strided": (-E) % 4 + 4,
            "misaligned": 1 if (E + 1) % 4 else 2}[layout]


@pytest.mark.cuda
def test_the_library_takes_the_wrappers_limits(cuda_device):
    from feinsum_tpu_torch.ops._build import load_library
    lib = load_library()
    assert lib.step_update_max_groups() == kernels.UPDATE_MAX_GROUPS
    assert lib.step_update_max_terms() == kernels.UPDATE_MAX_TERMS


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "row-strided",
                                    "misaligned"])
@pytest.mark.parametrize("nterms", [1, 2, 3, 4])
@pytest.mark.parametrize("storage", KERNEL_STORAGES)
@pytest.mark.parametrize("E", [1, 3, 4099, 1000003])
def test_step_update_equals_its_plain_version_on_the_card(
        cuda_device, E, storage, nterms, layout):
    """Bit for bit: one group and three groups, any signs, pair planes that
    lie apart (``v_pairs[:, x]``), rows with padding between them (on 16
    bytes, and not)."""
    R = 5 if E > 10_000 else P
    dtype, pairs = STORAGES[storage]
    pad = _pad(E, layout)
    signs = tuple((-1) ** (k * (k + 1) // 2) for k in range(nterms))

    def cases(device):
        """The same operands on *device*: one group, and three groups of
        per-group views."""
        base = _strided(_rand(3, R, E, dtype=dtype, seed=E).to(device), pad)
        if pairs:
            # (2, 3, R, E) pairs whose component x is a (2, R, E) view with
            # planes 3 R (E + pad) apart
            terms = [_strided(_pair(3, R, E, seed=k).to(device), pad)
                     for k in range(nterms)]
            one = [t[:, 1] for t in terms]
            per_group = [[t[:, x] for x in range(3)] for t in terms]
        else:
            terms = [_strided(_rand(3, R, E, dtype=dtype,
                                    seed=10 + k).to(device), pad)
                     for k in range(nterms)]
            one = [t[1] for t in terms]
            per_group = [list(t) for t in terms]
        return [(base[1], one), (base, per_group)]

    for (b, ts), (b_dev, ts_dev) in zip(cases("cpu"), cases(cuda_device)):
        want = kernels.step_update_plain(b, ts, -DT, signs=signs)
        before = kernels.launch_counts["step_update"]
        got = kernels.step_update(b_dev, ts_dev, -DT, signs=signs)
        torch.cuda.synchronize()
        assert kernels.launch_counts["step_update"] == before + 1
        assert got.is_contiguous()
        _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(0, 9), (9, 36), (180, 315)])
@pytest.mark.parametrize("E", [3, 4099, 1000003])
def test_step_update_into_out_equals_its_plain_version_on_the_card(
        cuda_device, E, rows):
    """Bit for bit, the result written into a band of rows of a larger
    tensor, as the ADER step's time integral writes its bands of (35 x 9,
    E) rows; the rows around the band are left as they were."""
    lo, hi = rows
    R = hi - lo
    base = _rand(315, E, seed=1)
    terms = [_rand(315, E, seed=2 + k) for k in range(3)]
    want = kernels.step_update_plain(base[lo:hi], [t[lo:hi] for t in terms],
                                     1.0)
    whole = torch.full((315, E), 7.0, device=cuda_device)
    before = kernels.launch_counts["step_update"]
    got = kernels.step_update(base[lo:hi].to(cuda_device),
                              [t[lo:hi].to(cuda_device) for t in terms], 1.0,
                              out=whole[lo:hi])
    torch.cuda.synchronize()
    assert kernels.launch_counts["step_update"] == before + 1
    assert got.data_ptr() == whole[lo].data_ptr() and got.shape == (R, E)
    _same(whole[lo:hi], want)
    rest = torch.cat([whole[:lo], whole[hi:]])
    assert bool((rest == 7).all())


def _visco_update_cases(E: int, device, seed: int = 0) -> list:
    """The viscoelastic ADER step's update forms on the same operands on
    *device*, ``(base, terms, dt, kwargs)`` each: a derivative's 9 of its
    15 columns (rows at two strides) added into the source's output; the
    strain rates weighted by w into the relaxation's output, one group a
    mechanism; the update of Q (three terms, rows at two strides) and of
    Qane (weighted, signs +1, +1, -1)."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return (2 * torch.rand(shape, generator=gen) - 1).to(device)
    X, P, H = rand(20, 15, E), rand(35, 9, E), rand(35, 6, 3, E)
    V, F, Q = rand(35, 15, E), rand(35, 15, E), rand(35, 9, E)
    Qane, Iane, w = rand(35, 6, 3, E), rand(35, 6, 3, E), rand(3, E)

    def mech(t):
        return t.permute(2, 0, 1, 3)
    return [
        (X[:, :9].unsqueeze(0), [[P[:20]]], 1.0, {}),
        (mech(H[:20]), [[X[:, 9:]] * 3], 1.0, {"weights": w}),
        (Q.unsqueeze(0), [[V[:, :9]], [F[:, :9]], [P]], DT, {}),
        (mech(Qane), [[V[:, 9:]] * 3, [F[:, 9:]] * 3, list(mech(Iane))], DT,
         {"signs": (1, 1, -1), "weights": list(w)})]


def test_rows_at_two_strides_and_weights_are_the_formula():
    """A (G, R1, R2, E) base takes its groups' rows at two strides, each
    term a view of that shape per group; *weights* multiply each group's
    sum by its (E,) weight before dt: ``base + dt * (w * sum)``, bit for
    bit the formula in PyTorch, and *out* takes the result in rows of a
    larger tensor (in place too)."""
    for base, terms, dt, kw in _visco_update_cases(7, "cpu"):
        signs = kw.get("signs", (1,) * len(terms))
        got = kernels.step_update(base, terms, dt, **kw)
        assert got.shape == base.shape and got.is_contiguous()
        for g in range(base.shape[0]):
            acc = terms[0][g] * signs[0]
            for s, t in zip(signs[1:], terms[1:]):
                acc = acc + t[g] if s > 0 else acc - t[g]
            if "weights" in kw:
                acc = kw["weights"][g] * acc
            _same(got[g], base[g] + dt * acc)
    # in place: the derivative's rows added into the source's output
    base, terms, dt, kw = _visco_update_cases(7, "cpu")[0]
    want = kernels.step_update(base, terms, dt)
    out = terms[0][0].unsqueeze(0)
    assert kernels.step_update(base, terms, dt, out=out) is out
    _same(out, want)


@pytest.mark.parametrize("case", ["float64", "count", "shape", "stride"])
def test_weights_are_refused_naming_what_is_wrong(case):
    base, terms, dt, kw = _visco_update_cases(5, "cpu")[1]
    w = kw["weights"]
    if case == "float64":
        with pytest.raises(ft.InvalidParameterError, match="weights"):
            kernels.step_update(_rand(3, 5, dtype=torch.float64),
                                [_pair(3, 5)], DT, weights=[w[0]])
        return
    bad = {"count": w[:2], "shape": w[:, :4],
           "stride": torch.rand(3, 10)[:, ::2]}[case]
    with pytest.raises(ft.InvalidParameterError, match="weight"):
        kernels.step_update(base, terms, dt, weights=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [3, 4099, 4100, 1000003])
def test_rows_at_two_strides_and_weights_equal_the_plain_version_on_the_card(
        cuda_device, E):
    """Bit for bit, the viscoelastic step's four update forms (rows at two
    strides; one group a mechanism with its weight; the views on 16 bytes
    where E % 4 = 0, else the scalar path), each one launch."""
    for (b, ts, dt, kw), (b_dev, ts_dev, _, kw_dev) in zip(
            _visco_update_cases(E, "cpu", seed=E),
            _visco_update_cases(E, cuda_device, seed=E)):
        want = kernels.step_update_plain(b, ts, dt, **kw)
        before = kernels.launch_counts["step_update"]
        got = kernels.step_update(b_dev, ts_dev, dt, **kw_dev)
        torch.cuda.synchronize()
        assert kernels.launch_counts["step_update"] == before + 1
        _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "offset", "row-strided"])
@pytest.mark.parametrize("E", [1, 3, 4099, 1000003])
def test_pairs_split_equals_its_plain_version_on_the_card(cuda_device, E,
                                                          layout):
    """Contiguous (the vector path where R E % 4 = 0), 8 bytes off 16 (the
    scalar path), and row-strided, which ``split_to_pairs`` makes
    contiguous and ``pairs_split`` refuses."""
    R = 3 if E > 10_000 else P
    x = _rand(R, E, dtype=torch.float64, seed=E) * 1e5
    splits = [kernels.pairs_split, dd_emitter.split_to_pairs]
    if layout == "offset":
        buf = torch.empty(R * E + 1, dtype=torch.float64, device=cuda_device)
        x_dev = buf[1:].view(R, E)
        x_dev.copy_(x)
    elif layout == "row-strided":
        x_dev = _strided(x.to(cuda_device), _pad(E, layout))
        with pytest.raises(ft.InvalidParameterError, match="contiguous"):
            kernels.pairs_split(x_dev)
        splits = [dd_emitter.split_to_pairs]
    else:
        x_dev = x.to(cuda_device)
    for split in splits:
        before = kernels.launch_counts["pairs_split"]
        got = split(x_dev)
        torch.cuda.synchronize()
        assert kernels.launch_counts["pairs_split"] == before + 1
        _same(got, kernels.pairs_split_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("model", ["wave", "maxwell"])
def test_chained_steps_equal_the_glue_steps_on_the_card(cuda_device, model,
                                                       dtype):
    """8 chained steps of each model, at E = 5,003 (the kernels' scalar
    paths) and 8,192, equal the same steps with the PyTorch glue, bit for
    bit; each step launches ``step_update`` twice, and on pairs
    ``pairs_split`` twice."""
    cls, make_state = {"wave": (ft.WaveOperator3D, make_wave_state),
                       "maxwell": (ft.MaxwellOperator3D,
                                   make_maxwell_state)}[model]
    op = cls(dtype=dtype)
    for E in (5003, 8192):
        state, geom = make_state(E, dtype=dtype, seed=E, device=cuda_device)
        step = op.make_step(E)
        step(state, geom)                # the geometry's pairs held
        got = want = state
        before = dict(kernels.launch_counts)
        for _ in range(8):
            got = step(got, geom)
        torch.cuda.synchronize()
        assert kernels.launch_counts["step_update"] \
            - before["step_update"] == 16
        assert kernels.launch_counts["pairs_split"] \
            - before["pairs_split"] == (16 if dtype == "float64" else 0)
        with _glue_steps():
            glue_step = op.make_step(E)
            for _ in range(8):
                want = glue_step(want, geom)
        torch.cuda.synchronize()
        for k in got:
            _same(got[k], want[k])

# }}}

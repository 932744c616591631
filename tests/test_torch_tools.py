"""The port's measurement scripts (``feinsum_tpu_torch/tools``): the parts
that need no card."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from feinsum_tpu_torch.tools import profile_suite, sweep_block_long


def _ev(device_type, start, end, name="kernel", **annotation):
    return SimpleNamespace(device_type=device_type, name=name,
                           time_range=SimpleNamespace(start=start, end=end),
                           **annotation)


@pytest.mark.parametrize("events,busy", [
    # a host operator spanning its kernel is not device time
    ([_ev(DeviceType.CPU, 0, 100), _ev(DeviceType.CUDA, 10, 40)], 30),
    # overlapping and nested device intervals count once, gaps not at all
    ([_ev(DeviceType.CUDA, 50, 70), _ev(DeviceType.CUDA, 0, 20),
      _ev(DeviceType.CUDA, 10, 30), _ev(DeviceType.CUDA, 55, 60)], 50),
    ([_ev(DeviceType.CPU, 0, 5)], 0),
    # a span's shadow on the device covers the gap between the launches it
    # holds; it is no device operation (marked, or by the program's prefix)
    ([_ev(DeviceType.CUDA, 0, 10), _ev(DeviceType.CUDA, 20, 30),
      _ev(DeviceType.CUDA, 0, 30, "feinsum.kernel:probe_apply_f32",
          is_user_annotation=True)], 20),
    ([_ev(DeviceType.CUDA, 0, 10), _ev(DeviceType.CUDA, 20, 30),
      _ev(DeviceType.CUDA, 0, 30, "feinsum.exec:ei,ij->ej")], 20),
    ([_ev(DeviceType.CUDA, 0, 30, "bench.step", is_user_annotation=True)],
     0),
])
def test_device_busy_counts_device_intervals_once(events, busy):
    assert profile_suite.device_busy_us(events) == busy
    assert sum(map(profile_suite.is_device_op, events)) == sum(
        ev.device_type == DeviceType.CUDA and ev.name == "kernel"
        for ev in events)


def test_sweep_covers_the_suite_value():
    from feinsum_tpu_torch.suite import BLOCK_LONG

    assert BLOCK_LONG in sweep_block_long.BLOCKS


def test_tc_sweep_covers_the_tuner_seeds():
    """``suite.TCCG_SEEDS`` (the points ``chip_smoke.py`` seeds the tuner
    with) are points of ``sweep_tc_grid``, and every sweep point on the
    TCCG rows binds or is refused by a guard."""
    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch.suite import TCCG_SEEDS, tccg_suite
    from feinsum_tpu_torch.tools import sweep_tc_grid
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

    v1 = get_transform_func_from_module_path("tc_pallas_v1")
    rows = dict(tccg_suite())
    assert set(TCCG_SEEDS) == {name for name, e in rows.items()
                               if len(e.out_idx_set) >= 3}
    for name, seeds in TCCG_SEEDS.items():
        e = rows[name]
        points = sweep_tc_grid.points(e)
        n_bound = 0
        for params in points:
            try:
                v1.bind_args(e, **params)(ft.generate_program(e))
                n_bound += 1
            except ft.InvalidParameterError:
                pass
        assert n_bound > len(points) // 2
        for seed in seeds:
            assert {**seed, "precision_idx": 0} in points, (name, seed)


@pytest.mark.parametrize("layout", ["dof-major", "logical"])
def test_step_block_mappings_rows_plan_onto_the_kernel(layout):
    """Every row of ``step_block_mappings`` (``chip_smoke.py`` phase 19's),
    in both stored layouts, plans onto ``step_block_f32`` and its plain
    version meets the einsum on CPU tensors."""
    import torch

    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.measure import apply_layouts, \
        generate_input_arrays
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    from feinsum_tpu_torch.tools import step_block_mappings as sbm

    rows = [("demo", sbm.demo_einsum(), False)] + sbm.step_block_rows()
    assert [n for n, _, _ in rows[1:]] == [
        "sumfact_q4", "sumfact_q4_one_step", "sumfact_q4_b2",
        "broadcast_ndof35", "resident_reduce_ndof35", "gram_ndof120"]
    for name, e, hoist in rows:
        program = sbm.programs(e, hoist)[layout]
        plan = plan_cuda_launch(program, get_index_lengths(e, 40))
        assert plan.kernel == "step_block_f32", name
        logical = generate_input_arrays(e, long_dim_length=40, seed=1,
                                        device="cpu")
        outs = plan.plain(plan.operands(apply_layouts(program, logical)))
        subs = e.get_subscripts().replace(" ", "")
        for r, got in enumerate(outs):
            want = torch.einsum(subs, *[logical[a.name].double()
                                        for a in e.args[r]])
            if program.descriptor.out_layout is not None:
                want = want.permute(*program.descriptor.out_layout)
            torch.testing.assert_close(got.double(), want, rtol=2e-5,
                                       atol=2e-5 * float(want.abs().max()))

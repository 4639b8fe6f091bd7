"""The roofline, MFU and idle-share arithmetic on hand-made shapes and
device intervals."""

from __future__ import annotations

import importlib.util

import pytest

from tcbench import run, trace, yardstick


def reader(name: str):
    spec = importlib.util.spec_from_file_location("m", run.TCBENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_attention_bound_takes_the_larger_of_operations_and_bytes():
    # (2, 8, 35640, 35640, 40): 4 B H S^2 D = 3.25e12 operations, 3.29 ms
    ops_s = 4 * 2 * 8 * 35640 ** 2 * 40 / 989e12
    assert yardstick.attention_bound_s(2, 8, 35640, 35640, 40) == pytest.approx(ops_s)
    # one query against 4096 keys: the bytes of k and v bound it
    by_s = 2 * 1 * 8 * 40 * (2 * 1 + 2 * 4096) / 3.35e12
    assert yardstick.attention_bound_s(1, 8, 1, 4096, 40) == pytest.approx(by_s)


def test_match_bound_counts_inputs_once_and_both_outputs():
    assert yardstick.match_bound_s(2, 23760, 23760, 320) == pytest.approx(
        2 * 2 * 23760 * 23760 * 320 / 989e12)
    assert yardstick.match_bound_s(1, 100, 1, 64) == pytest.approx(
        (2 * 64 * 101 + 8 * 100) / 3.35e12)


def test_mfu_and_roofline_shares():
    assert yardstick.step_mfu(989e12, 2.0) == pytest.approx(50.0)
    assert yardstick.roofline_share(1.0, 4.0) == pytest.approx(25.0)
    assert yardstick.roofline_share(1.0, 0.0) is None


def _trace():
    dev = [(0.0, 100.0, "flash_fwd_wgmma_kernel<40>"), (50.0, 150.0, "elementwise_kernel"),
           (300.0, 400.0, "match_argmax_kernel"), (400.0, 500.0, "sm90_xmma_fprop_conv"),
           (700.0, 800.0, "nvjet_tst_gemm"), (800.0, 810.0, "Memcpy DtoH (Device -> Pinned)")]
    host = [(140.0, 320.0, "aten::index"), (150.0, 250.0, "aten::nonzero"),
            (500.0, 700.0, "cudaLaunchKernel")]
    return trace.Trace(dev, host, steps=2, wall_s=1000e-6)


def test_busy_time_is_the_union_of_device_intervals():
    tr = _trace()
    assert tr.busy() == [[0.0, 150.0], [300.0, 500.0], [700.0, 810.0]]
    assert tr.busy_s() == pytest.approx(460e-6)
    assert reader("device_idle_share.sampling")(tr, {}) == pytest.approx(54.0)


def test_groups_and_gaps():
    tr = _trace()
    g = tr.by_group()
    assert g["flash_attention"] == pytest.approx(100e-6) and g["match_argmax"] == pytest.approx(1e-4)
    assert g["convolution"] == pytest.approx(1e-4) and g["gemm"] == pytest.approx(1e-4)
    assert g["other"] == pytest.approx(110e-6)
    assert tr.kernels() == 5
    assert reader("launches_per_step.sampling")(tr, {}) == 2.5
    # the 150-300 gap's middle (225) lies inside aten::nonzero, the innermost
    assert tr.idle_gaps(10) == [("aten::nonzero", pytest.approx(150e-6)),
                                ("cudaLaunchKernel", pytest.approx(200e-6))][::-1]
    assert reader("unet_other_ms_per_step.sampling")(tr, {}) == pytest.approx(0.055)


def test_kernel_rooflines_from_the_reference_shapes():
    tr = _trace()
    work = {"attention_calls": [(1, 8, 1000, 1000, 40)], "match_calls": [(1, 900, 300, 320)],
            "flops_per_step": 1e9}
    k1 = reader("k1_roofline.sampling")(tr, work)
    assert k1 == pytest.approx(100 * yardstick.attention_bound_s(1, 8, 1000, 1000, 40) / 50e-6)
    k2 = reader("k2_roofline.sampling")(tr, work)
    assert k2 == pytest.approx(100 * yardstick.match_bound_s(1, 900, 300, 320) / 50e-6)
    assert reader("k1_ms_per_step.sampling")(tr, work) == pytest.approx(0.05)
    assert reader("step_mfu.sampling")(tr, work) == pytest.approx(
        100 * 1e9 / (500e-6 * 989e12))


def test_readers_without_their_kernels_return_nothing():
    tr = trace.Trace([(0.0, 10.0, "elementwise_kernel")], [], steps=1, wall_s=1e-3)
    work = {"attention_calls": [(1, 8, 1000, 1000, 40)], "match_calls": [(1, 9, 3, 32)]}
    assert reader("k1_roofline.sampling")(tr, work) is None
    assert reader("k2_roofline.sampling")(tr, work) is None
    assert reader("k1_ms_per_step.sampling")(tr, work) is None

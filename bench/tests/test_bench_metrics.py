"""The metric arithmetic: the 95th percentile over all calls, the rate over
the whole window, the peak a call adds, the busy union and the idle gaps of
a trace, and the shares of the roofline."""

import pytest
import torch

from bench import harness, plugins
from bench import trace as tracing


HAND = plugins.hand_kernel_names(plugins.hand_kernels(plugins.BENCH))


def metric(name):
    return plugins.load_module(plugins.BENCH, "metrics", name)


def fake_run(**kw):
    cell = harness.load_cell("rs8.encode")
    run = harness.Run(cell, width=1000)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_p95_is_a_measured_value_by_nearest_rank():
    assert harness.p95(range(1, 101)) == 95
    assert harness.p95([5.0]) == 5.0
    assert harness.p95([3, 1, 2]) == 3
    assert harness.p95(list(range(20))) == 18


def test_call_p95_takes_every_call():
    run = fake_run(call_s=[0.001] * 95 + [0.010] * 5)
    assert metric("call_p95_ms").read(run) == pytest.approx(1.0)
    run = fake_run(call_s=[0.001] * 94 + [0.010] * 6)
    assert metric("call_p95_ms").read(run) == pytest.approx(10.0)
    assert metric("call_p95_ms").read(fake_run()) is None


def test_rate_is_over_the_whole_window():
    # K = 8 rows of 1000 residues, 4 B each, 50 calls over 2 s, however long the calls were
    run = fake_run(call_s=[0.001] * 50, window_s=2.0)
    assert metric("coded_GBps").read(run) == pytest.approx(8 * 1000 * 4 * 50 / 2.0 / 1e9)


def test_peak_added_is_read_only_on_a_card():
    assert metric("peak_added_GB").read(fake_run()) is None
    assert metric("peak_added_GB").read(fake_run(peak_added=3_000_000_000)) == pytest.approx(3.0)


def ev(name, on_device, s, e):
    return (name, on_device, s, e)


def fake_trace():
    C, G = False, True
    return [
        ev(tracing.WINDOW, C, 0, 1000),
        ev(tracing.CALL, C, 10, 400), ev(tracing.CALL, C, 500, 900),
        ev("aten::mul", C, 20, 30), ev("cudaLaunchKernel", C, 22, 24), ev("aten::add", C, 600, 700),
        ev(tracing.CALL, G, 10, 400),  # the range's own device row is no kernel
        ev("elementwise_kernel<mul>", G, 50, 150),
        ev("gf_matmul_rows", G, 100, 200),  # overlaps the one before: counted once in busy
        ev("Memcpy DtoD", G, 300, 350),
        ev("butterfly_mac_rows_kernel", G, 520, 620),
        ev("index_select_kernel", G, 950, 980),  # after the calls: not inside one
        ev("elementwise_kernel<add>", G, 990, 1100),  # runs past the window: clipped
    ]


def test_busy_is_the_union_and_gaps_are_named_by_the_host():
    t = tracing.summarize(fake_trace(), hand=HAND)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.calls == 2
    # union: [50, 200] + [300, 350] + [520, 620] + [950, 980] + [990, 1000]
    assert t.busy_s == pytest.approx((150 + 50 + 100 + 30 + 10) * 1e-6)
    assert t.op_seconds(in_call=True) == pytest.approx((100 + 100 + 50 + 100) * 1e-6)
    assert t.op_seconds(in_call=True, names=HAND) == pytest.approx(200e-6)
    top = dict(t.top_ops())
    assert top["copies: Memcpy DtoD"] == pytest.approx(50e-6)
    assert top["gathers: index_select_kernel"] == pytest.approx(30e-6)
    assert top["hand_kernels: gf_matmul_rows"] == pytest.approx(100e-6)
    assert top["elementwise: elementwise_kernel<add>"] == pytest.approx(10e-6)  # clipped at the window's end
    # gaps, named at their middle: [0, 50] at 25 inside aten::mul (the innermost range open there);
    # [200, 300] and [620, 950] inside a call only; [350, 520] and [980, 990] outside any range
    gaps = dict(t.top_gaps())
    assert gaps == pytest.approx({"in a call: between the program's ops": 430e-6,
                                  "between calls: host outside any range": 180e-6,
                                  "in a call: aten::mul": 50e-6})
    assert list(gaps)[0] == "in a call: between the program's ops"
    assert sum(s for _, s in t.gaps) == pytest.approx(t.window_s - t.busy_s)


def test_per_layer_readers():
    t = tracing.summarize(fake_trace(), hand=HAND)
    run = fake_run(trace=t)
    assert metric("device_idle").read(run) == pytest.approx(100 * (1 - t.busy_s / t.window_s))
    assert metric("eager_ms").read(run) == pytest.approx((100 + 50) * 1e-6 / 2 * 1e3)
    assert metric("kernel_roofline").read(run) is None  # a CPU run names no card's peak
    assert metric("device_idle").read(fake_run()) is None
    run = fake_run(trace=t, kind="NVIDIA H100 80GB HBM3", call_s=[0.002, 0.004])
    least = (8 + 8) * 1000 * 4 / 3.35e12
    assert metric("kernel_roofline").read(run) == pytest.approx(100 * least / 100e-6)  # 200 us of hand kernels in 2 calls
    assert metric("encode_mfu").read(run) == pytest.approx(100 * least / 0.003)


def test_a_trace_without_one_window_is_refused():
    with pytest.raises(RuntimeError, match="windows"):
        tracing.summarize([ev("gf_matmul_rows", True, 0, 1)])


def test_least_bytes_count_each_row_once():
    run = fake_run()
    assert run.least_bytes() == (8 + 8) * 1000 * 4


def test_the_peak_table_names_the_card():
    assert harness.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert harness.peak_bytes_per_s("a card the table lacks") is None


def test_records_read_a_profile():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.WINDOW):
            torch.ones(10).mul_(2)
    recs = tracing.records(prof)
    (window,) = [r for r in recs if r[0] == tracing.WINDOW]
    assert window[1] is False and window[3] > window[2]
    assert any(r[0] == "aten::mul_" and window[2] <= r[2] <= r[3] <= window[3] for r in recs)


def test_kinds():
    assert tracing.kernel_kind("void gf_matmul_rows<4>(...)", HAND) == "hand_kernels"
    assert tracing.kernel_kind("butterfly_mac_rows_kernel", HAND) == "hand_kernels"
    assert tracing.kernel_kind("butterfly_mac_rows_kernel") == "elementwise"  # named by no kernel file
    assert tracing.kernel_kind("void at::native::index_elementwise_kernel", HAND) == "gathers"
    assert tracing.kernel_kind("Memcpy DtoD (Device -> Device)", HAND) == "copies"
    assert tracing.kernel_kind("void at::native::vectorized_elementwise_kernel<4, mul>", HAND) == "elementwise"


def test_the_hand_kernels_are_the_files_of_kernels():
    assert {k["name"] for k in plugins.hand_kernels(plugins.BENCH)} == {"gf_matmul", "butterfly_mac"}
    assert set(HAND) == {"gf_matmul", "butterfly_mac"}


def test_hand_launches_reads_the_counters_the_files_name():
    mod = metric("hand_launches")
    run = fake_run(kernels=[{"name": "a", "launch_counter": "bench.tests.test_bench_metrics:Counter.launches"}])
    Counter.launches = 10
    mod.before_window(run)
    Counter.launches = 31
    run.attempted = 7
    assert mod.read(run) == pytest.approx(3.0)
    assert mod.read(fake_run(attempted=7)) is None  # no file names a counter


class Counter:
    launches = 0

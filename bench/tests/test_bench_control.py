"""The comparison that decides ``correct``, driven through whole runs on the
CPU at small sizes: the program and the exact reference in its place come
out correct; the control (the reference in a lower precision) and every
fault planted under the timed path come out not correct."""

import time

import pytest

from bench import control, harness
from bench.tests.small import SMALL

SEED = 2**31 + 977


def run(workload, what, seed=SEED):
    traffic = harness.load_cell(workload, overrides=SMALL[workload]).traffic
    return harness.run_cell(workload, seed, 0.2, False, t_start=time.perf_counter(), device="cpu",
                            overrides=SMALL[workload], entry=control.stand_in(what, traffic, seed),
                            log=lambda *a: None)


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("what", ["program", "exact"])
def test_sound_runs_are_correct(workload, what):
    r = run(workload, what)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_is_not_correct(workload):
    # float32 for every cell; a float64 product of two 31-bit residues is inexact too
    for what in ("float32",) + (("float64",) if workload.startswith("dft64") else ()):
        r = run(workload, what)
        assert not r["correct"]
        assert r["checks"]["mismatched_elements"]["value"] > 0


def test_float64_is_exact_on_limbs():
    """A 16-bit limb times a 31-bit coefficient fits float64's mantissa, so
    float64 is no lower precision for the coded checkpoint: its control is
    float32."""
    assert run("rs8.encode", "float64")["correct"]


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("fault", control.FAULTS)
def test_every_fault_is_not_correct(workload, fault):
    r = run(workload, fault)
    assert not r["correct"], fault
    assert r["checks"]["mismatched_elements"]["value"] > 0


def test_a_call_that_raises_is_failed_and_not_correct():
    def entry(config, device):
        payload = harness.plugins.load_module(harness.plugins.BENCH, "payloads", config["payload"]["kind"])

        def call(x):
            call.n += 1
            if call.n > 4:  # after the warm-up
                raise RuntimeError("planted")
            return x

        call.n = 0
        return payload.to_program, call

    r = harness.run_cell("dft64.encode", SEED, 0.1, False, t_start=time.perf_counter(), device="cpu",
                         overrides=SMALL["dft64.encode"], entry=entry, log=lambda *a: None)
    assert r["failed"] == r["attempted"] >= 1
    assert not r["correct"]


def test_a_window_longer_than_the_sample_ring_is_correct():
    """More sampled calls than the ring on the device holds: it is copied to
    the host whenever full, and every sample still matches."""
    w = "rs8.encode"
    over = {**SMALL[w], "traffic": {"sampled_share": 1.0}}
    r = harness.run_cell(w, SEED, 1.5, False, t_start=time.perf_counter(), device="cpu", overrides=over,
                         log=lambda *a: None)
    assert r["attempted"] > 256
    assert r["correct"], r["checks"]


def test_a_call_that_returns_another_calls_columns_is_not_correct():
    """Where a call encodes a part of a payload (the mix's ``call_columns``),
    its output is compared with the reference's columns of that part: one
    that returns the coded rows of the first part every time is caught."""
    w = "dft64.rounds"
    traffic = harness.load_cell(w, overrides=SMALL[w]).traffic
    program = control.stand_in("exact", traffic, SEED)

    def entry(config, device):
        to_program, call = program(config, device)
        first = []

        def stale(x):
            first.append(call(x)) if not first else None
            return first[0].clone()

        return to_program, stale

    r = harness.run_cell(w, SEED, 0.2, False, t_start=time.perf_counter(), device="cpu", overrides=SMALL[w],
                         entry=entry, log=lambda *a: None)
    assert r["attempted"] > 8
    assert not r["correct"]
    assert r["checks"]["mismatched_elements"]["value"] > 0

"""Differential tests of the port's serving path (``repro_torch.serve``,
``repro_torch.launch.serve``) against ``repro.serve`` on the CPU.

* The scheduler, the length buckets and the seeded Poisson traces are pure
  Python and numpy: equal to the reference's.
* Greedy tokens of ``ContinuousEngine`` and of the fixed-batch ``Engine``
  equal the reference engines' on the same trace and parameters, at the
  float32 smoke config (logit error ~1e-6 against a spread of ~0.16, so a
  top-1 flip is not expected; one would be a fault, not a tolerance).
* Within the port: continuous batching equals one request at a time, greedy
  and sampled; EOS trimming, lengths, the report and the metrics; coded
  serving (K = 3, R = 2) gives bit-identical tokens for every survivor
  subset, staggered kills, sampled replay and ``collective=True``; the
  guard's coded shards of a state carried across equal the reference
  guard's bit for bit.
* The launcher runs with ``--smoke --device cpu``.

Sampled tokens are not compared with the reference: the port draws them
from its own counter-based stream (``serve/engine.py``), not ``jax.random``.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import smoke_config as r_smoke_config
from repro.models import build_model as r_build_model
from repro.obs.metrics import MetricsRegistry as RMetricsRegistry
from repro.serve import CodedServeGuard as RCodedServeGuard
from repro.serve import ContinuousEngine as RContinuousEngine
from repro.serve import Engine as REngine
from repro.serve import LengthBand as RLengthBand
from repro.serve import Request as RRequest
from repro.serve import SlotScheduler as RSlotScheduler
from repro.serve import bucket_for as r_bucket_for
from repro.serve import poisson_trace as r_poisson_trace
from repro.serve.engine import _percentiles_ms as r_percentiles_ms
from repro.serve.engine import _request_seed as r_request_seed
from repro_torch import tree
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve import (
    DEFAULT_BUCKETS,
    CodedServeGuard,
    ContinuousEngine,
    Engine,
    FaultInjector,
    LengthBand,
    ProcessHostPool,
    Request,
    SlotScheduler,
    bucket_for,
    poisson_trace,
)
from repro_torch.serve.engine import _percentiles_ms, _request_seed
from repro_torch.train import make_decode_step, make_prefill_step

PROMPTS = [[5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 6, 2, 9, 10, 1], [2], [7, 5, 5, 5, 1, 2]]
MAX_NEW = 6
K, R = 3, 2  # N = 5 coded hosts: killing each 2-subset forces every 3-survivor set
WAIT_S = 30


@functools.lru_cache(maxsize=2)
def _pair(dtype: str = "float32"):
    """(reference model, reference params, port model, port params) of the
    Qwen3-1.7B smoke config, two layers, the parameters carried across."""
    rcfg = r_smoke_config("qwen3-1.7b").replace(n_layers=2, dtype=dtype)
    rm = r_build_model(rcfg)
    rp = rm.init(jax.random.key(0))
    m = build_model(smoke_config("qwen3-1.7b").replace(n_layers=2, dtype=dtype))
    return rm, rp, m, params_from_reference(jax.tree.map(np.asarray, rp), m, device="cpu")


@functools.lru_cache(maxsize=2)
def _engine(n_slots: int = 2):
    _, _, m, p = _pair()
    return ContinuousEngine(m, p, n_slots=n_slots, max_len=32, buckets=(8, 16), max_new_tokens=8,
                            metrics=MetricsRegistry())


def _reqs(prompts=PROMPTS, cls=Request, **kw):
    return [cls(id=f"r{i}", prompt=p, max_new_tokens=MAX_NEW, **kw) for i, p in enumerate(prompts)]


def _toks(report) -> dict:
    return {r.id: tuple(r.tokens) for r in report.results}


@functools.lru_cache(maxsize=4)
def _baseline(greedy: bool = True, temperature: float = 1.0):
    return _toks(_engine().serve(_reqs(), greedy=greedy, sync_every=2, seed=0, temperature=temperature))


# ---------------------------------------------------------------------------
# scheduler + traffic: equal to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("buckets", [DEFAULT_BUCKETS, (8, 16), (128, 256, 512)])
def test_bucket_for_equals_the_reference(buckets):
    for plen in range(1, max(buckets) + 1):
        assert bucket_for(plen, buckets) == r_bucket_for(plen, buckets)
    for bad in (0, max(buckets) + 1):
        with pytest.raises(ValueError):
            bucket_for(bad, buckets)
        with pytest.raises(ValueError):
            r_bucket_for(bad, buckets)


def test_scheduler_follows_the_reference_step_for_step():
    mine, ref = SlotScheduler(2), RSlotScheduler(2)
    for i, arr in enumerate([0.0, 0.0, 0.0, 5.0, 5.0]):
        mine.submit(Request(id=f"r{i}", prompt=[1], arrival_s=arr))
        ref.submit(RRequest(id=f"r{i}", prompt=[1], arrival_s=arr))
    script = [("assign", 0.0), ("assign", 0.0), ("assign", 0.0), ("retire", 0), ("assign", 0.0),
              ("retire", 1), ("assign", 0.0), ("assign", 5.0), ("retire", 0), ("assign", 6.0), ("retire", 1),
              ("retire", 0)]
    for op, arg in script:
        if op == "assign":
            a, b = mine.next_assignment(arg), ref.next_assignment(arg)
            assert (a is None) == (b is None)
            if a is not None:
                assert a[0] == b[0] and a[1].id == b[1].id
        else:
            assert mine.retire(arg).id == ref.retire(arg).id
        assert (mine.occupied, mine.free, mine.pending, mine.has_work, mine.next_arrival_s()) == \
            (ref.occupied, ref.free, ref.pending, ref.has_work, ref.next_arrival_s())
    assert not mine.has_work
    with pytest.raises(ValueError):
        SlotScheduler(0)


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("mix", ["default", "two-band"])
def test_poisson_trace_equals_the_reference(seed, mix):
    kw = {} if mix == "default" else {
        "mix": (LengthBand(16, 128, 0.6), LengthBand(129, 512, 0.4)), "max_new_tokens": 32, "vocab_size": 151936}
    rkw = dict(kw)
    if "mix" in kw:
        rkw["mix"] = tuple(RLengthBand(b.lo, b.hi, b.weight) for b in kw["mix"])
    got, want = poisson_trace(12, 8.0, seed=seed, **kw), r_poisson_trace(12, 8.0, seed=seed, **rkw)
    assert [(r.id, r.prompt, r.max_new_tokens, r.arrival_s, r.seed) for r in got] == \
        [(r.id, r.prompt, r.max_new_tokens, r.arrival_s, r.seed) for r in want]


def test_request_seed_and_percentiles_equal_the_reference():
    for req in (Request(id="a", prompt=[1]), Request(id="req-0007", prompt=[1]), Request(id="x", prompt=[1], seed=77)):
        assert _request_seed(req) == r_request_seed(RRequest(id=req.id, prompt=req.prompt, seed=req.seed))
    for samples in ([], [0.5], [0.001, 0.2, 0.03, 0.4]):
        assert _percentiles_ms(samples) == r_percentiles_ms(samples)


# ---------------------------------------------------------------------------
# greedy tokens: equal to the reference engines (float32)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_slots, sync_every", [(2, 2), (3, 3), (1, 4)])
def test_continuous_greedy_tokens_equal_the_reference(n_slots, sync_every):
    rm, rp, _, _ = _pair()
    ref = RContinuousEngine(rm, rp, n_slots=n_slots, max_len=32, buckets=(8, 16), max_new_tokens=8,
                            metrics=RMetricsRegistry())
    want = _toks(ref.serve(_reqs(cls=RRequest), greedy=True, sync_every=sync_every))
    got = _toks(_engine(n_slots).serve(_reqs(), greedy=True, sync_every=sync_every))
    assert got == want


def test_poisson_trace_served_greedy_equals_the_reference():
    """A seeded trace (ragged prompt lengths over three buckets, staggered
    budgets) through both continuous engines: the same tokens."""
    mix = (LengthBand(2, 8, 0.5), LengthBand(9, 24, 0.5))
    trace = poisson_trace(8, 2000.0, mix=mix, max_new_tokens=6, vocab_size=503, seed=1)
    rtrace = r_poisson_trace(8, 2000.0, mix=tuple(RLengthBand(b.lo, b.hi, b.weight) for b in mix),
                             max_new_tokens=6, vocab_size=503, seed=1)
    rm, rp, m, p = _pair()
    kw = dict(n_slots=3, max_len=40, buckets=(8, 16, 32), max_new_tokens=6)
    want = RContinuousEngine(rm, rp, metrics=RMetricsRegistry(), **kw).serve(rtrace, greedy=True, sync_every=2)
    got = ContinuousEngine(m, p, metrics=MetricsRegistry(), **kw).serve(trace, greedy=True, sync_every=2)
    assert _toks(got) == _toks(want)
    assert [r.gen_len for r in got.results] == [r.max_new_tokens for r in trace]
    assert got.prefill_compiles == want.prefill_compiles


def test_fixed_engine_greedy_tokens_equal_the_reference():
    rm, rp, m, p = _pair()
    got = Engine(m, p, max_len=24, metrics=MetricsRegistry()).generate(PROMPTS, max_new_tokens=5)
    want = REngine(rm, rp, max_len=24, metrics=RMetricsRegistry()).generate(PROMPTS, max_new_tokens=5)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.steps == want.steps


def test_continuous_equals_fixed_batch():
    _, _, m, p = _pair()
    res = Engine(m, p, max_len=32, metrics=MetricsRegistry()).generate(PROMPTS, max_new_tokens=MAX_NEW)
    fixed = {f"r{b}": tuple(res.tokens[b, : len(PROMPTS[b]) + MAX_NEW].tolist()) for b in range(len(PROMPTS))}
    assert _baseline() == fixed


# ---------------------------------------------------------------------------
# within the port: batching invariance, EOS, lengths, metrics
# ---------------------------------------------------------------------------


def _one_at_a_time(model, params, prompts, max_new, buckets, max_len):
    """Each prompt alone through the prefill callable + B=1 decode steps
    (greedy). The engine must reproduce this exactly."""
    pf = make_prefill_step(model, into_cache=True)
    dec = make_decode_step(model)
    V = model.cfg.vocab_size
    out = []
    for p in prompts:
        b = bucket_for(len(p), buckets)
        cache = model.init_cache(1, max_len, device="cpu")
        tb = torch.zeros((1, b), dtype=torch.int32)
        tb[0, : len(p)] = torch.tensor(p)
        last, cache = pf(params, cache, tb, 0, len(p))
        toks = [int(torch.argmax(last[0, :V]))]
        pos = len(p)
        for _ in range(max_new - 1):
            lg, cache = dec(params, cache, torch.tensor([[toks[-1]]], dtype=torch.int32),
                            torch.tensor([pos], dtype=torch.int32))
            toks.append(int(torch.argmax(lg[0, 0, :V])))
            pos += 1
        out.append(list(p) + toks)
    return out


def test_continuous_matches_one_at_a_time():
    _, _, m, p = _pair()
    rep = _engine().serve(_reqs(), greedy=True, sync_every=2)
    assert [r.tokens for r in rep.results] == _one_at_a_time(m, p, PROMPTS, MAX_NEW, (8, 16), 32)
    assert rep.prefill_compiles <= 2
    assert all(r.gen_len == MAX_NEW for r in rep.results)
    assert all(r.ttft_s >= 0 and r.e2e_s >= r.ttft_s for r in rep.results)


def test_sampled_decoding_batch_invariant():
    """Token i of a request comes from counter i of its own stream, so the
    slot-scheduled run equals each request served alone; an explicit seed
    overrides the id-derived stream; the stream depends on the serve seed."""
    _, _, m, p = _pair()
    batched = ContinuousEngine(m, p, n_slots=3, max_len=32, buckets=(8, 16), max_new_tokens=8,
                               metrics=MetricsRegistry())
    solo = ContinuousEngine(m, p, n_slots=1, max_len=32, buckets=(8, 16), max_new_tokens=8,
                            metrics=MetricsRegistry())
    reqs = [Request(id=f"r{i}", prompt=q, max_new_tokens=5) for i, q in enumerate(PROMPTS)]
    rep = batched.serve(reqs, greedy=False, seed=3, temperature=0.8, sync_every=2)
    got = _toks(rep)
    for req in reqs:
        assert got[req.id] == tuple(solo.serve([req], greedy=False, seed=3, temperature=0.8).results[0].tokens)
    assert got != _toks(batched.serve(reqs, greedy=False, seed=4, temperature=0.8, sync_every=2))
    greedy = _toks(batched.serve(reqs, greedy=True, sync_every=2))
    assert got != greedy  # sampling at temperature 0.8 does draw other tokens
    seeded = [Request(id=f"s{i}", prompt=q, max_new_tokens=5, seed=77) for i, q in enumerate(PROMPTS[:2])]
    rep2 = batched.serve(seeded, greedy=False, seed=3, temperature=0.8)
    rep3 = solo.serve([Request(id="other-id", prompt=PROMPTS[0], max_new_tokens=5, seed=77)],
                      greedy=False, seed=3, temperature=0.8)
    assert rep2.results[0].tokens == rep3.results[0].tokens
    with pytest.raises(ValueError, match="temperature"):
        batched.serve(reqs, greedy=False, temperature=0.0)


def test_sampling_draws_from_the_softmax():
    """The counter-based Gumbel stream samples ``softmax(logits / T)``: over
    4,000 counters the frequencies of a 4-way distribution are within 0.03."""
    from repro_torch.serve.engine import _sample

    lg = torch.log(torch.tensor([[0.1, 0.2, 0.3, 0.4]])).repeat(4000, 1)
    rng = torch.tensor([[5, 9]], dtype=torch.int32).repeat(4000, 1)
    draws = _sample(lg, 1.0, rng, torch.arange(4000, dtype=torch.int32))
    freq = torch.bincount(draws.long(), minlength=4).float() / 4000
    np.testing.assert_allclose(freq.numpy(), [0.1, 0.2, 0.3, 0.4], rtol=0, atol=0.03)
    again = _sample(lg, 1.0, rng, torch.arange(4000, dtype=torch.int32))
    assert torch.equal(draws, again)


def test_continuous_eos_trims_generation():
    eng = ContinuousEngine(*_pair()[2:], n_slots=2, max_len=24, buckets=(8,), max_new_tokens=8,
                           metrics=MetricsRegistry())
    reqs = _reqs(PROMPTS[:3])
    free = eng.serve(reqs, greedy=True, sync_every=2)
    r0 = free.results[0]
    gen0 = r0.tokens[r0.prompt_len:]
    eos = gen0[2]
    first = gen0.index(eos)
    rep = eng.serve(reqs, greedy=True, eos_id=eos, sync_every=2)
    t0 = rep.results[0]
    assert t0.gen_len == first + 1
    assert t0.tokens == r0.tokens[: r0.prompt_len + first + 1]
    for a, b in zip(rep.results, free.results):
        assert a.tokens == b.tokens[: a.prompt_len + a.gen_len]
        assert a.gen_len == MAX_NEW or a.tokens[-1] == eos


def test_engine_lengths_and_generated_only_throughput():
    _, _, m, p = _pair()
    reg = MetricsRegistry()
    res = Engine(m, p, max_len=24, metrics=reg).generate(PROMPTS[:3], max_new_tokens=4)
    plens = np.array([len(q) for q in PROMPTS[:3]])
    np.testing.assert_array_equal(res.prompt_lens, plens)
    np.testing.assert_array_equal(res.lengths, plens + 4)
    snap = reg.snapshot()
    wall_s = snap["serve.generate_ms"]["value"] / 1e3
    assert snap["serve.tokens_per_s"]["value"] == pytest.approx(12 / wall_s, rel=1e-6)
    assert snap["serve.steps"]["value"] == res.steps


def test_engine_lengths_eos_trimmed_and_sampled():
    _, _, m, p = _pair()
    free = Engine(m, p, max_len=24, metrics=MetricsRegistry()).generate(PROMPTS[:2], max_new_tokens=5)
    p0 = len(PROMPTS[0])
    gen0 = free.tokens[0, p0: p0 + 5].tolist()
    eos = gen0[1]
    first = gen0.index(eos)
    reg = MetricsRegistry()
    res = Engine(m, p, max_len=24, metrics=reg).generate(PROMPTS[:2], max_new_tokens=5, eos_id=eos,
                                                        eos_check_every=100)
    assert res.lengths[0] == p0 + first + 1
    for b in range(2):
        assert res.lengths[b] <= len(PROMPTS[b]) + 5
    snap = reg.snapshot()
    gen_total = int((res.lengths - res.prompt_lens).sum())
    assert snap["serve.tokens_per_s"]["value"] == pytest.approx(gen_total / (snap["serve.generate_ms"]["value"] / 1e3),
                                                                rel=1e-6)
    assert snap["serve.eos_syncs_saved"]["value"] > 0
    eng = Engine(m, p, max_len=24, metrics=MetricsRegistry())
    s1, s2 = (eng.generate(PROMPTS[:2], max_new_tokens=5, greedy=False, seed=1) for _ in range(2))
    np.testing.assert_array_equal(s1.tokens, s2.tokens)
    for b, q in enumerate(PROMPTS[:2]):
        assert s1.tokens[b, : len(q)].tolist() == q


def test_continuous_metrics_report_and_spans():
    _, _, m, p = _pair()
    reg, tracer = MetricsRegistry(), Tracer()
    eng = ContinuousEngine(m, p, n_slots=2, max_len=32, buckets=(8, 16), max_new_tokens=8, metrics=reg,
                           tracer=tracer)
    reqs = [Request(id=f"r{i}", prompt=q, max_new_tokens=4) for i, q in enumerate(PROMPTS)]
    rep = eng.serve(reqs, greedy=True, sync_every=2)
    snap = reg.snapshot()
    assert snap["serve.prefill_compiles"]["value"] == rep.prefill_compiles == 1  # every prompt fits bucket 8
    assert snap["serve.decode_steps"]["value"] == rep.decode_steps
    assert snap["serve.ttft_ms"]["count"] == snap["serve.e2e_ms"]["count"] == len(reqs)
    assert snap["serve.prefill_us"]["count"] == len(reqs)
    assert snap["serve.decode_chunk_us"]["count"] == rep.decode_steps // 2
    assert 0.0 <= rep.slot_occupancy <= 1.0 and rep.tokens_per_s > 0
    assert snap["serve.tokens_per_s"]["value"] == rep.tokens_per_s
    rec = rep.to_record()
    assert rec["ttft_ms"]["p50"] <= rec["ttft_ms"]["p99"] and rec["n_requests"] == len(reqs)
    assert "coded" not in rec and rep.recoveries == 0 and rep.requests_recovered == 0
    names = {s.name for s in tracer.spans}
    assert names == {"serve.prefill", "serve.decode_chunk"}
    eng.serve(reqs, greedy=True, sync_every=2)
    assert eng.prefill_compiles == rep.prefill_compiles  # built once, reused
    eng.serve(reqs[:1], greedy=False, sync_every=2)
    assert eng.prefill_compiles == rep.prefill_compiles + 1  # one more for (bucket, sampled)


def test_engine_refuses_bad_requests_and_a_mesh(capsys):
    eng = _engine()
    with pytest.raises(ValueError, match="exceeds largest prefill bucket"):
        eng.serve([Request(id="long", prompt=[1] * 17, max_new_tokens=2)])
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.serve([Request(id="big", prompt=[1], max_new_tokens=9)])
    # the launcher: a mesh runs only under torchrun with as many ranks; with
    # --coded too it is refused for that alone, as the reference's launcher
    # refuses a mesh only for want of devices (tests/test_torch_coded_mesh.py
    # serves --mesh 2x2 --coded on four ranks)
    with pytest.raises(SystemExit):
        serve_main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--mesh", "2x4"])
    assert "--mesh 2x4 needs 8 ranks: run it under torchrun --nproc-per-node 8" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve_main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--mesh", "2x2", "--coded", "3,2"])
    err = capsys.readouterr().err
    assert "--mesh 2x2 needs 4 ranks: run it under torchrun --nproc-per-node 4" in err and "ROADMAP" not in err


# ---------------------------------------------------------------------------
# coded serving (K = 3, R = 2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("killed", list(itertools.combinations(range(K + R), R)))
def test_coded_serve_every_survivor_subset_bit_identical(killed):
    """Killing each R-subset of hosts mid-trace (⇔ every survivor subset of
    size K reconstructs): the tokens equal the unfailed run's."""
    guard = CodedServeGuard(K=K, R=R, injector=FaultInjector(kills=tuple((1, h) for h in killed)), device="cpu")
    rep = _engine().serve(_reqs(), greedy=True, sync_every=2, guard=guard)
    assert sorted(guard.alive) == [h for h in range(K + R) if h not in killed]
    assert _toks(rep) == _baseline()
    assert rep.recoveries == R and rep.coded["injected_faults"] == R
    assert len(guard.recovery_us) >= 1


def test_coded_serve_staggered_kills_metrics_and_spans():
    reg, tracer = MetricsRegistry(), Tracer()
    _, _, m, p = _pair()
    eng = ContinuousEngine(m, p, n_slots=2, max_len=32, buckets=(8, 16), max_new_tokens=8, metrics=reg,
                           tracer=tracer)
    guard = CodedServeGuard(K=K, R=R, injector=FaultInjector(kills=((1, 0), (5, 4))), device="cpu")
    rep = eng.serve(_reqs(), greedy=True, sync_every=2, guard=guard)
    assert _toks(rep) == _baseline()
    snap = reg.snapshot()
    assert snap["serve.recoveries"]["value"] == 2
    assert snap["serve.recovery_us"]["count"] == 2
    assert snap["serve.recovery_us"]["p50"] <= snap["serve.recovery_us"]["p99"]
    assert snap["serve.snapshots"]["value"] == rep.coded["snapshots"] == rep.decode_steps // 2  # one a chunk
    assert rep.requests_recovered >= 1
    spans = [s for s in tracer.spans if s.name == "serve.recovery"]
    assert len(spans) == 2 and all(s.dur_us > 0 for s in spans)
    assert rep.to_record()["coded"]["recoveries"] == 2


def test_coded_serve_sampled_replay_bit_identical():
    """temperature > 0: the sampling seeds and counters live in the encoded
    state, so the replayed chunk resamples the SAME tokens."""
    base = _baseline(greedy=False, temperature=0.7)
    guard = CodedServeGuard(K=K, R=R, injector=FaultInjector(kills=((2, 1),)), device="cpu")
    rep = _engine().serve(_reqs(), greedy=False, sync_every=2, seed=0, temperature=0.7, guard=guard)
    assert _toks(rep) == base and base != _baseline()
    assert rep.recoveries == 1


def test_coded_serve_collective_and_sigkilled_host():
    """The encode through the compiled round schedule, and a coded shard
    held by a real OS process that is SIGKILLed mid-decode."""
    guard = CodedServeGuard(K=K, R=R, injector=FaultInjector(kills=((1, 3),)), collective=True, device="cpu")
    rep = _engine().serve(_reqs(), greedy=True, sync_every=2, guard=guard)
    assert _toks(rep) == _baseline() and rep.recoveries == 1
    with ProcessHostPool(K + R) as pool:
        guard = CodedServeGuard(K=K, R=R, injector=FaultInjector(kills=((1, 2),)), hosts=pool, device="cpu")
        rep = _engine().serve(_reqs(), greedy=True, sync_every=2, guard=guard)
        assert not pool.alive(2)
        assert _toks(rep) == _baseline() and rep.recoveries == 1
    for p in pool.procs:
        p.wait(timeout=WAIT_S)
        assert p.poll() is not None


def test_coded_serve_beyond_tolerance_raises():
    guard = CodedServeGuard(K=K, R=R, injector=FaultInjector(kills=((1, 0), (1, 1), (1, 2))), device="cpu")
    with pytest.raises(RuntimeError, match="need K=3"):
        _engine().serve(_reqs(), greedy=True, sync_every=2, guard=guard)


def _reference_engine_state(rm, rp, n_slots=2, max_len=16, G=4):
    """A (cache, state) pair as the reference engine holds it mid-decode: a
    prompt prefilled into slot 1, and the per-slot state with a bool mask
    and uint32 PRNG key data."""
    cache = rm.init_cache(n_slots, max_len)
    tb = np.zeros((1, 8), np.int32)
    tb[0, :5] = PROMPTS[0]
    _, cache = rm.prefill_into_cache(rp, cache, jnp.asarray(tb), 1)
    key = jax.random.key_data(jax.random.fold_in(jax.random.key(0), 12345))
    state = {
        "last_tok": jnp.asarray([0, 17], jnp.int32),
        "pos": jnp.asarray([0, 5], jnp.int32),
        "active": jnp.asarray([False, True]),
        "gen_buf": jnp.asarray(np.arange(n_slots * G).reshape(n_slots, G), jnp.int32),
        "gen_count": jnp.asarray([0, 1], jnp.int32),
        "max_gen": jnp.asarray([0, 4], jnp.int32),
        "rng": jnp.zeros((n_slots, 2), jnp.uint32).at[1].set(key),
    }
    return cache, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_guard_snapshot_of_a_carried_state_equals_the_reference(dtype):
    """The coded shards of the reference engine's (cache, state) — bf16 or
    f32 KV slabs, a bool mask, uint32 key data — carried across, equal the
    reference guard's bit for bit; so do those of the port's own state
    layout holding the same bits (int32 seeds in place of uint32 keys)."""
    rm, rp, m, _ = _pair(dtype)
    cache, state = _reference_engine_state(rm, rp)
    ref = RCodedServeGuard(K=K, R=R)
    ref.snapshot(cache, state, tick=0)
    port_cache, port_state = state_from_reference(jax.tree.map(np.asarray, (cache, state)), device="cpu")
    assert port_state["active"].dtype == torch.bool
    guard = CodedServeGuard(K=K, R=R, device="cpu")
    guard.snapshot(port_cache, port_state, tick=0)
    assert sorted(guard.group._mem) == sorted(ref.group._mem) == list(range(K + R))
    for j in range(K + R):
        np.testing.assert_array_equal(guard.group._mem[j], np.asarray(ref.group._mem[j]))
    # the port engine's own state dict, holding the same bits
    eng = ContinuousEngine(m, _pair(dtype)[3], n_slots=2, max_len=16, buckets=(8,), max_new_tokens=4,
                           metrics=MetricsRegistry())
    mine = eng.init_state()
    assert sorted(mine) == sorted(state) and mine["rng"].dtype == torch.int32
    for k, v in port_state.items():
        mine[k].copy_(v.view(torch.int32) if k == "rng" else v)
    own = CodedServeGuard(K=K, R=R, device="cpu")
    own.snapshot(port_cache, mine, tick=0)
    for j in range(K + R):
        np.testing.assert_array_equal(own.group._mem[j], np.asarray(ref.group._mem[j]))
    back = own.recover([0, 4])
    for a, b in zip(tree.leaves(back), tree.leaves((port_cache, mine))):
        assert a.dtype == b.dtype and torch.equal(a, b) if a.dtype == torch.bool else \
            torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def test_guard_on_another_device_is_refused():
    guard = CodedServeGuard(K=K, R=R, device="meta")
    with pytest.raises(ValueError, match="the guard runs on meta"):
        _engine().serve(_reqs(), guard=guard)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--coded", "3,2", "--kill", "2:0", "--kill", "6:4"], ["--engine", "fixed"]])
def test_launcher_smoke_on_the_cpu(extra, capsys):
    out = serve_main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--prompts", "1,2,3;4,5;9,9,9,9",
                      "--max-new", "6", "--max-len", "32", *extra])
    text = capsys.readouterr().out
    if "fixed" in extra:
        assert out.tokens.shape == (3, 10) and "on cpu" in text
        return
    assert [len(r.tokens) for r in out.results] == [9, 8, 10]
    assert "prefill graphs, on cpu" in text and "cli-2: [9, 9, 9, 9" in text
    if extra:
        assert out.recoveries == 2 and out.coded["injected_faults"] == 2
        assert "2 hosts recovered from" in text


def test_launcher_refuses_a_mesh_kill_without_coded_and_coded_fixed(capsys, tmp_path):
    """A mesh whose size is not the world's is refused naming both sizes
    (a world of one rank here); --kill without --coded, and --coded with the
    fixed engine, are refused."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        with pytest.raises(SystemExit):
            serve_main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--mesh", "2x4"])
    finally:
        dist.destroy_process_group()
    assert "--mesh 2x4 holds 8 ranks; the world has 1" in capsys.readouterr().err
    for argv in (["--kill", "2:0"], ["--engine", "fixed", "--coded", "3,2"]):
        with pytest.raises(SystemExit):
            serve_main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", *argv])

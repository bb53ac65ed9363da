"""Serving engines: fixed-batch (legacy) and continuous-batching.

Two tiers share the model's decode and prefill callables:

* :class:`Engine` — the fixed-capacity batch: prompts are right-padded and
  refed token by token through the decode step, then new tokens are sampled
  until max length or EOS. One long prompt or one slow finisher stalls the
  whole batch; it stays as the measured baseline and the fall-back for
  the models with no one-pass prefill (recurrent, encoder-decoder, VLM).

* :class:`ContinuousEngine` — continuous batching. A **separate prefill
  callable** (``train.train_loop.make_prefill_step(into_cache=True)`` →
  ``models.model.Model.prefill_into_cache``) writes a whole prompt's K/V
  into one cache slot in a single forward pass and returns the first
  sampled token; prompts are right-padded to a length **bucket**, and one
  prefill callable is built per (bucket, sampling mode), counted in
  ``serve.prefill_compiles`` (the reference compiles one graph for each). A
  :class:`~repro_torch.serve.scheduler.SlotScheduler` keeps a fixed pool of
  decode slots fed from a FIFO arrival queue — when a slot hits EOS or its
  token budget it is retired and the next queued request is prefilled into
  that slot **mid-decode**, without draining the batch. The decode tick
  keeps per-slot position counters and an active-slot mask on the device
  and updates the cache and the state in place; the host syncs only every
  ``sync_every`` ticks (one fetch of the bool mask), and once after each
  prefill, where the first token is materialised (TTFT).

Sampling (``greedy=False``) draws token i of a request from a counter-based
generator on the device: Gumbel noise hashed from the request's seed pair
(kept in the ``rng`` state leaf, int32 (S, 2)) and i, so a request's tokens
never depend on batch composition and a replay after recovery resamples the
same tokens. The streams differ from ``jax.random``'s: sampled tokens are
equal within this package, greedy tokens equal the reference's.

On a mesh of ranks (``mesh=``, a ``launch.mesh.RankMesh`` of more than
one rank) every rank runs the same engine: the host-side scheduler, the
per-slot state and the sampling stay whole on every rank, the parameters
and the decode cache are DTensors placed by ``train.train_loop``'s
``param_shardings`` and ``cache_shardings`` under the engine's rules, and
the logits a step returns are gathered whole (``full_tensor``) before the
argmax or the draw, so every rank picks the same tokens. A coded guard
(``serve(guard=)``) runs on every rank too: it reads the meshed cache by its
global value, and after a recovery the engine places the rebuilt cache back
on the mesh under ``cache_shardings`` before the replay.

Observability (``repro_torch.obs``): ``serve.steps`` / ``serve.generate_ms``
/ ``serve.tokens_per_s`` (generated tokens only in BOTH engines) /
``serve.eos_syncs_saved`` on the fixed path; ``serve.prefill_compiles`` /
``serve.decode_steps`` / ``serve.ttft_ms`` / ``serve.e2e_ms`` /
``serve.slot_occupancy`` on the continuous path. Passing ``tracer=`` wraps
prefills and decode chunks in spans and feeds the ``serve.step_us`` /
``serve.prefill_us`` / ``serve.decode_chunk_us`` histograms (a device sync
per span — opt-in).
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .. import tree
from ..models.model import Model
from ..train.train_loop import (
    cache_shardings,
    make_decode_step,
    make_prefill_step,
    param_shardings,
    place,
)
from .scheduler import (
    DEFAULT_BUCKETS,
    Request,
    RequestResult,
    SlotScheduler,
    bucket_for,
)


def _request_seed(req: Request) -> int:
    """The request's sampling-stream seed: explicit ``req.seed`` or a
    stable hash of its id — never a function of batch composition."""
    if req.seed is not None:
        return int(req.seed)
    return zlib.crc32(req.id.encode()) & 0x7FFFFFFF


def _percentiles_ms(samples_s: list[float]) -> dict:
    if not samples_s:
        return {"p50": 0.0, "p99": 0.0}
    ms = np.asarray(samples_s) * 1e3
    return {"p50": float(np.percentile(ms, 50)), "p99": float(np.percentile(ms, 99))}


# ---------------------------------------------------------------------------
# the counter-based sampling stream
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _int32(x: int) -> int:
    """The low 32 bits of ``x`` as a signed int32 value."""
    x &= _M32
    return x - (1 << 32) if x >= (1 << 31) else x


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for int64 ``h`` in [0, 2^32) and a 32-bit constant,
    in two 16-bit halves of ``c`` so no product leaves int64."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser: a bijection of [0, 2^32) that mixes
    every input bit into every output bit."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _sample(lg: torch.Tensor, temperature: float, rng: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """Token ``counter[s]`` of stream ``rng[s]`` for each row of ``lg``
    (S, V) float32: ``argmax(lg / temperature + Gumbel noise)`` — a draw from
    ``softmax(lg / temperature)`` — with the noise hashed on the device from
    (``rng[s, 0]``, ``rng[s, 1]``, ``counter[s]``, vocabulary index).
    Returns (S,) int32."""
    V = lg.shape[-1]
    h = _fmix32(rng[:, 0].long() & _M32)
    h = _fmix32(h ^ (rng[:, 1].long() & _M32))
    h = _fmix32(h ^ (counter.long() & _M32))
    v = torch.arange(V, dtype=torch.int64, device=lg.device)
    h = _fmix32((h[:, None] + _mul32(v, 0x9E3779B9)) & _M32)
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # in (0, 1), exact in float32
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(lg / temperature + gumbel, dim=-1).to(torch.int32)


def _sync(device: torch.device) -> None:
    """Wait for the device (the reference's ``block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(params) -> torch.device:
    return tree.leaves(params)[0].device


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full tensor, the same on every rank; a tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _on_mesh(model, params, mesh, rules):
    """(mesh, params): ``params`` placed on ``mesh`` by ``param_shardings``
    (DTensors already on them stay where they are); a mesh of one rank is
    no mesh."""
    if mesh is None or mesh.device_mesh is None or mesh.device_mesh.size() == 1:
        return None, params
    return mesh, place(params, param_shardings(model, mesh, rules))


def _init_cache(model, batch: int, max_len: int, device, mesh, rules):
    """The zero decode cache; on a mesh, each leaf placed by
    ``cache_shardings``."""
    cache = model.init_cache(batch, max_len, device=device)
    return cache if mesh is None else place(cache, cache_shardings(model, mesh, rules, cache))


@dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, total)
    steps: int
    #: per-sequence prompt + generated length, trimmed at the first EOS in
    #: the generated region (the EOS token itself counts)
    lengths: np.ndarray  # (B,)
    prompt_lens: np.ndarray  # (B,)


class Engine:
    """Fixed-batch engine (the baseline, and the recurrent, encoder-decoder
    and VLM fall-back). Runs on the device that holds
    ``params``; ``rules`` (``dist.sharding.ShardingRules``) reach the model
    through its decode step; with ``mesh`` the parameters and the cache are
    placed on its ranks."""

    def __init__(
        self,
        model: Model,
        params,
        max_len: int = 256,
        tracer=None,
        metrics=None,
        rules=None,
        mesh=None,
    ):
        self.model = model
        self.mesh, self.params = _on_mesh(model, params, mesh, rules)
        self.rules = rules
        self.max_len = max_len
        self.device = _device_of(self.params)
        self._step = make_decode_step(model, rules, mesh=self.mesh)
        self._tracer = tracer
        self._metrics = metrics

    def _registry(self):
        if self._metrics is not None:
            return self._metrics
        from ..obs.metrics import get_registry

        return get_registry()

    def generate(
        self,
        prompts: list[list[int]],
        max_new_tokens: int = 32,
        eos_id: int | None = None,
        greedy: bool = True,
        seed: int = 0,
        eos_check_every: int = 8,
    ) -> GenerationResult:
        B = len(prompts)
        cfg = self.model.cfg
        dev = self.device
        plen = np.array([len(p) for p in prompts])
        total = int(plen.max()) + max_new_tokens
        assert total <= self.max_len
        toks = np.zeros((B, total), dtype=np.int32)
        for b, p in enumerate(prompts):
            toks[b, : len(p)] = p
        cache = _init_cache(self.model, B, self.max_len, dev, self.mesh, self.rules)
        if self.model.is_encdec:
            # stub frames: zeros (a real system: the audio frontend's output)
            cache["enc_out"].zero_()
        toks_t = torch.from_numpy(toks).to(dev)
        plen_t = torch.from_numpy(plen).to(dev)
        # the batch's sampling streams: (seed, row), token t of row b at counter t
        rng = torch.stack([torch.full((B,), _int32(seed), dtype=torch.int32),
                           torch.arange(B, dtype=torch.int32)], dim=1).to(dev)
        reg = self._registry()
        tracer = self._tracer
        steps = 0
        last_t = 0
        t_start = time.perf_counter()
        for t in range(total - 1):
            cur = toks_t[:, t : t + 1]
            pos = torch.full((B,), t, dtype=torch.int32, device=dev)
            if tracer is not None:
                with tracer.span("serve.step", step=steps, pos=t, batch=B) as sp:
                    logits, cache = self._step(self.params, cache, cur, pos)
                    _sync(dev)
                reg.histogram("serve.step_us").observe(sp.dur_us)
            else:
                logits, cache = self._step(self.params, cache, cur, pos)
            steps += 1
            last_t = t
            lg = _whole(logits)[:, 0, : cfg.vocab_size]
            if greedy:
                nxt = torch.argmax(lg, dim=-1).to(torch.int32)
            else:
                nxt = _sample(lg, 1.0, rng, torch.full((B,), t, dtype=torch.int32, device=dev))
            # only overwrite positions beyond each prompt
            write = (t + 1) >= plen_t
            toks_t[:, t + 1] = torch.where(write, nxt, toks_t[:, t + 1])
            if eos_id is not None:
                # the all-sequences-done check is a device→host sync; batch
                # it every eos_check_every steps (and on the last step) so
                # the decode loop stays asynchronous in between
                due = steps % max(eos_check_every, 1) == 0 or t == total - 2
                if due:
                    if bool(torch.all(torch.any(toks_t == eos_id, dim=1))):
                        break
                else:
                    reg.counter("serve.eos_syncs_saved").inc()
        toks_np = toks_t.cpu().numpy()
        wall_s = time.perf_counter() - t_start
        # generated-tokens-only accounting: columns 0..last_t+1 are filled;
        # a sequence's generated region is [plen, last_t+2), EOS-trimmed
        filled = last_t + 2
        gen = np.clip(filled - plen, 0, max_new_tokens)
        if eos_id is not None:
            for b in range(B):
                region = toks_np[b, plen[b] : plen[b] + gen[b]]
                hits = np.nonzero(region == eos_id)[0]
                if hits.size:
                    gen[b] = hits[0] + 1
        reg.counter("serve.steps").inc(steps)
        reg.gauge("serve.generate_ms").set(wall_s * 1e3)
        if wall_s > 0:
            reg.gauge("serve.tokens_per_s").set(float(gen.sum()) / wall_s)
        return GenerationResult(
            tokens=toks_np,
            steps=steps,
            lengths=plen + gen,
            prompt_lens=plen,
        )


@dataclass
class ServeReport:
    """Outcome of one :meth:`ContinuousEngine.serve` run: per-request
    results (arrival order) + the latency/throughput aggregates."""

    results: list[RequestResult]
    wall_s: float
    tokens_per_s: float  # generated tokens only
    ttft_ms: dict  # {"p50", "p99"}
    e2e_ms: dict  # {"p50", "p99"}
    slot_occupancy: float  # mean occupied-slot fraction over decode ticks
    prefill_compiles: int  # engine-lifetime prefill callable count
    decode_steps: int
    #: guard.stats() when the run was coded (K/R, injected_faults,
    #: recoveries, requests_recovered, recovery_us percentiles)
    coded: dict | None = None

    @property
    def recoveries(self) -> int:
        return int(self.coded["recoveries"]) if self.coded else 0

    @property
    def requests_recovered(self) -> int:
        return int(self.coded["requests_recovered"]) if self.coded else 0

    def to_record(self) -> dict:
        """JSON-ready engine row."""
        rec = {
            "tokens_per_s": self.tokens_per_s,
            "ttft_ms": dict(self.ttft_ms),
            "e2e_ms": dict(self.e2e_ms),
            "slot_occupancy": self.slot_occupancy,
            "prefill_compiles": self.prefill_compiles,
            "decode_steps": self.decode_steps,
            "n_requests": len(self.results),
            "wall_s": self.wall_s,
        }
        if self.coded is not None:
            rec["coded"] = dict(self.coded)
        return rec


class ContinuousEngine:
    """Continuous-batching engine: one prefill callable per length bucket +
    slot-scheduled decode with mid-stream insertion. Runs on the device that
    holds ``params``; ``rules`` (``dist.sharding.ShardingRules``) reach the
    model through its prefill and decode steps; with ``mesh`` the
    parameters and the cache are placed on its ranks."""

    def __init__(
        self,
        model: Model,
        params,
        n_slots: int = 4,
        max_len: int = 256,
        buckets=None,
        max_new_tokens: int = 32,
        tracer=None,
        metrics=None,
        rules=None,
        mesh=None,
    ):
        if not model.supports_prefill:
            raise NotImplementedError(
                f"{model.cfg.name}: one-pass prefill needs per-position cache "
                "rows (recurrent/encdec/VLM models serve via the fixed-batch "
                "Engine)"
            )
        if buckets is None:
            buckets = tuple(b for b in DEFAULT_BUCKETS if b <= max_len) or (max_len,)
        if max(buckets) > max_len:
            raise ValueError(f"bucket {max(buckets)} exceeds max_len {max_len}")
        self.model = model
        self.mesh, self.params = _on_mesh(model, params, mesh, rules)
        self.device = _device_of(self.params)
        self.n_slots = n_slots
        self.max_len = max_len
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.max_new_tokens = max_new_tokens
        self._tracer = tracer
        self._metrics = metrics
        self.rules = rules
        self._prefill_fns: dict = {}  # (bucket, greedy) -> prefill callable
        self._tick_fns: dict = {}  # greedy -> decode tick

    # -- observability ------------------------------------------------------
    def _registry(self):
        if self._metrics is not None:
            return self._metrics
        from ..obs.metrics import get_registry

        return get_registry()

    @property
    def prefill_compiles(self) -> int:
        """Prefill callables built over this engine's lifetime — bounded by
        len(buckets) per sampling mode by construction (the reference's
        compiled-graph count)."""
        return len(self._prefill_fns)

    # -- the device-side steps ------------------------------------------------
    def _tick_for(self, greedy: bool):
        tick = self._tick_fns.get(greedy)
        if tick is None:
            tick = self._make_tick(greedy)
            self._tick_fns[greedy] = tick
        return tick

    def _make_tick(self, greedy: bool):
        decode = make_decode_step(self.model, self.rules, mesh=self.mesh)
        V = self.model.cfg.vocab_size
        G = self.max_new_tokens

        def tick(params, cache, state, eos_id: int, temperature: float):
            """One decode step of every slot; ``cache`` and ``state`` are
            updated in place."""
            logits, cache = decode(params, cache, state["last_tok"][:, None], state["pos"])
            lg = _whole(logits)[:, 0, :V]
            if greedy:
                nxt = torch.argmax(lg, dim=-1).to(torch.int32)
            else:
                # per-slot streams: token i of a request is drawn at counter
                # i of its own stream — independent of batch composition
                nxt = _sample(lg, temperature, state["rng"], state["gen_count"])
            active = state["active"]
            nxt = torch.where(active, nxt, state["last_tok"])
            gc = state["gen_count"]
            # masked append: retired slots write nothing, cost no host sync
            write = (torch.arange(G, device=gc.device)[None, :] == gc[:, None]) & active[:, None]
            gen_buf = torch.where(write, nxt[:, None], state["gen_buf"])
            step = active.to(torch.int32)
            gc = gc + step
            pos = state["pos"] + step
            still = gc < state["max_gen"]
            if eos_id >= 0:
                still = still & (nxt != eos_id)
            state["last_tok"].copy_(nxt)
            state["pos"].copy_(pos)
            state["active"].copy_(active & still)
            state["gen_buf"].copy_(gen_buf)
            state["gen_count"].copy_(gc)
            return cache, state

        return tick

    def _prefill_for(self, bucket: int, greedy: bool):
        key = (bucket, greedy)
        pf = self._prefill_fns.get(key)
        if pf is None:
            pf = self._make_prefill(greedy)
            self._prefill_fns[key] = pf
            self._registry().counter("serve.prefill_compiles").inc()
        return pf

    def _make_prefill(self, greedy: bool):
        raw = make_prefill_step(self.model, into_cache=True, rules=self.rules, mesh=self.mesh)
        V = self.model.cfg.vocab_size

        def prefill(params, cache, state, tokens, slot: int, plen: int, req_max: int, eos_id: int,
                    rng_row: tuple[int, int], temperature: float):
            """Prefill one request into ``slot`` and set its state row, in
            place."""
            last, cache = raw(params, cache, tokens, slot, plen)
            lg = _whole(last)[:, :V]
            if greedy:
                t0 = torch.argmax(lg, dim=-1).to(torch.int32)
            else:
                # token 0 of this request's stream (see _make_tick)
                rng = torch.tensor([rng_row], dtype=torch.int32).to(lg.device)
                t0 = _sample(lg, temperature, rng, torch.zeros((1,), dtype=torch.int32, device=lg.device))
            done = t0 == eos_id if eos_id >= 0 else torch.zeros_like(t0, dtype=torch.bool)
            if req_max <= 1:
                done = torch.ones_like(done)
            state["last_tok"][slot] = t0[0]
            state["pos"][slot] = plen
            state["active"][slot] = ~done[0]
            state["gen_buf"][slot] = 0
            state["gen_buf"][slot, 0] = t0[0]
            state["gen_count"][slot] = 1
            state["max_gen"][slot] = req_max
            state["rng"][slot, 0] = rng_row[0]
            state["rng"][slot, 1] = rng_row[1]
            return cache, state

        return prefill

    # -- serve loop ---------------------------------------------------------
    def _validate(self, req: Request) -> None:
        plen = len(req.prompt)
        bucket_for(plen, self.buckets)  # raises if no bucket covers it
        if req.max_new_tokens < 1 or req.max_new_tokens > self.max_new_tokens:
            raise ValueError(
                f"{req.id}: max_new_tokens {req.max_new_tokens} outside "
                f"[1, {self.max_new_tokens}]"
            )
        if plen + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"{req.id}: prompt {plen} + budget {req.max_new_tokens} "
                f"exceeds max_len {self.max_len}"
            )

    def init_state(self) -> dict:
        """The per-slot decode state, on the engine's device: ``last_tok``,
        ``pos``, ``gen_count``, ``max_gen`` int32 (S,), ``active`` bool (S,),
        ``gen_buf`` int32 (S, max_new_tokens) and ``rng`` int32 (S, 2), the
        request's sampling seed pair."""
        S, G, dev = self.n_slots, self.max_new_tokens, self.device

        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return {"last_tok": z(S), "pos": z(S), "active": z(S, dtype=torch.bool), "gen_buf": z(S, G),
                "gen_count": z(S), "max_gen": z(S), "rng": z(S, 2)}

    def serve(
        self,
        requests: list[Request],
        greedy: bool = True,
        eos_id: int | None = None,
        seed: int = 0,
        sync_every: int = 4,
        temperature: float = 1.0,
        guard=None,
    ) -> ServeReport:
        """Run a trace of requests to completion; returns a ServeReport with
        per-request results in arrival order.

        ``sync_every`` is the decode-chunk length between host syncs: one
        bool-mask fetch per chunk detects retirements (a finished slot may
        run up to ``sync_every - 1`` masked ticks before harvest — the
        latency/throughput knob).

        ``guard`` (a :class:`repro_torch.serve.coded.CodedServeGuard` on the
        engine's device) makes the run straggler-tolerant: the decode-path
        state is LCC-encoded to N = K + R coded hosts before every chunk,
        host faults are polled at the chunk sync, and a lost host triggers
        exact reconstruction from any K survivors + a deterministic chunk
        replay — in-flight requests are recovered, not dropped, and the
        token streams stay bit-identical to an unfailed run.
        """
        if not greedy and temperature <= 0:
            raise ValueError(f"sampling needs temperature > 0, got {temperature}")
        if guard is not None and guard.device.type != self.device.type:
            raise ValueError(f"the guard runs on {guard.device}, the engine on {self.device}")
        reg = self._registry()
        tracer = self._tracer
        dev = self.device
        ordered = sorted(requests, key=lambda r: (r.arrival_s, r.id))
        sched = SlotScheduler(self.n_slots)
        for r in ordered:
            self._validate(r)
            sched.submit(r)
        S = self.n_slots
        cache = _init_cache(self.model, S, self.max_len, dev, self.mesh, self.rules)
        state = self.init_state()
        eos = -1 if eos_id is None else int(eos_id)
        temp = float(temperature)
        tick = self._tick_for(greedy)
        if guard is not None:
            guard.attach(reg, tracer)
        meta: dict[int, tuple[Request, float]] = {}  # slot -> (req, ttft_s)
        results: dict[str, RequestResult] = {}
        ticks_active = ticks_total = decode_steps = 0
        t0 = time.perf_counter()

        def now() -> float:
            return time.perf_counter() - t0

        def run_chunk(cache, state):
            for _ in range(sync_every):
                cache, state = tick(self.params, cache, state, eos, temp)
            return cache, state, state["active"].cpu().numpy()

        while sched.has_work:
            # 1. refill free slots with every arrived request (mid-decode
            #    insertion: the rest of the batch is untouched)
            while (a := sched.next_assignment(now())) is not None:
                slot, req = a
                plen = len(req.prompt)
                bucket = bucket_for(plen, self.buckets)
                pf = self._prefill_for(bucket, greedy)
                toks = np.zeros((1, bucket), np.int32)
                toks[0, :plen] = req.prompt
                rng_row = (_int32(seed), _int32(_request_seed(req)))
                args = (self.params, cache, state, torch.from_numpy(toks).to(dev), slot, plen,
                        req.max_new_tokens, eos, rng_row, temp)
                if tracer is not None:
                    with tracer.span("serve.prefill", slot=slot, bucket=bucket, plen=plen) as sp:
                        cache, state = pf(*args)
                        _sync(dev)
                    reg.histogram("serve.prefill_us").observe(sp.dur_us)
                else:
                    cache, state = pf(*args)
                    # first token is materialized here — that's TTFT
                    _sync(dev)
                ttft = now() - req.arrival_s
                meta[slot] = (req, ttft)
                reg.histogram("serve.ttft_ms").observe(ttft * 1e3)
            occ = sched.occupied
            if not occ:
                nxt_arr = sched.next_arrival_s()
                if nxt_arr is None:
                    break  # queue drained, all slots retired
                wait = nxt_arr - now()
                if wait > 0:
                    time.sleep(wait)
                continue
            # 2. one decode chunk: sync_every ticks, then a single host sync
            #    on the active mask to detect retirements. Under a guard the
            #    chunk-start state was LCC-encoded first, so a host lost
            #    mid-chunk costs one reconstruct + replay.
            if guard is not None:
                guard.snapshot(cache, state, tick=decode_steps)
            if tracer is not None:
                with tracer.span("serve.decode_chunk", ticks=sync_every, occupied=len(occ)) as sp:
                    cache, state, active_now = run_chunk(cache, state)
                reg.histogram("serve.decode_chunk_us").observe(sp.dur_us)
            else:
                cache, state, active_now = run_chunk(cache, state)
            decode_steps += sync_every
            ticks_active += len(occ) * sync_every
            ticks_total += S * sync_every
            if guard is not None:
                dead = guard.poll(decode_steps)
                if dead:
                    # exact chunk-start state from any K survivors, then a
                    # deterministic replay (the sampling seeds live in the
                    # state) — the replayed tokens are bit-identical
                    cache, state = guard.recover(dead, requests_in_flight=len(occ))
                    if self.mesh is not None:  # the whole cache, back on the mesh
                        cache = place(cache, cache_shardings(self.model, self.mesh, self.rules, cache))
                    cache, state, active_now = run_chunk(cache, state)
            # 3. harvest + retire finished slots (they refill next iteration)
            finished = [s for s in occ if not active_now[s]]
            if finished:
                gen_counts = state["gen_count"].cpu().numpy()
                gen_buf = state["gen_buf"].cpu().numpy()
                for s in finished:
                    req, ttft = meta.pop(s)
                    sched.retire(s)
                    g = int(gen_counts[s])
                    e2e = now() - req.arrival_s
                    results[req.id] = RequestResult(
                        id=req.id,
                        tokens=list(req.prompt) + gen_buf[s, :g].tolist(),
                        prompt_len=len(req.prompt),
                        gen_len=g,
                        ttft_s=ttft,
                        e2e_s=e2e,
                    )
                    reg.histogram("serve.e2e_ms").observe(e2e * 1e3)
        wall_s = now()
        out = [results[r.id] for r in ordered]
        gen_total = sum(r.gen_len for r in out)
        occupancy = (ticks_active / ticks_total) if ticks_total else 0.0
        tokens_per_s = (gen_total / wall_s) if wall_s > 0 else 0.0
        reg.counter("serve.decode_steps").inc(decode_steps)
        reg.gauge("serve.slot_occupancy").set(occupancy)
        reg.gauge("serve.tokens_per_s").set(tokens_per_s)
        return ServeReport(
            results=out,
            wall_s=wall_s,
            tokens_per_s=tokens_per_s,
            ttft_ms=_percentiles_ms([r.ttft_s for r in out]),
            e2e_ms=_percentiles_ms([r.e2e_s for r in out]),
            slot_occupancy=occupancy,
            prefill_compiles=self.prefill_compiles,
            decode_steps=decode_steps,
            coded=guard.stats() if guard is not None else None,
        )

"""Continuous batching over the globally paged pool: ``ServeEngine(paged=
True)`` served by ``serve_continuous``, one call per chunk of the trace.

Set-up makes the weights from the seed on the device, builds the engine,
gives each tenant of the mix an extent of ``rows`` requests at
``max_len``, and serves the warm-up chunk (every prefill shape of the
mix, the decode step, a drain running both).  The window then serves
whole chunks back to back, each ending in the driver's own copy of the
tokens to the host, and ends at the chunk end nearest to ``--seconds``
(after one chunk at least).  Every chunk is the same trace, so how many
the window holds leaves its mix as it was.

Timing: the manager's ``run_queued`` is wrapped on the instance, and a
CUDA event is recorded on the current stream right after each drain (the
step graphs replay on it: ``StepGraph.run`` replays on the caller's
stream).  Every event is read against the chunk's start event once the
chunk is over.  Which drain prefilled a request comes from the span
ledger's cycle stamps; a request emits one token a drain from there.
"""

from __future__ import annotations

import gc
import importlib
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import generator as T
from perfbench.harness import Context, DrainRecord, Record, ReqRecord
from perfbench.reference import schedule as S


class DrainClock:
    """Wraps one manager's ``run_queued``: per drain, the drain-cycle
    clock before it, the host wall inside it and, after it, a device
    completion stamp.  With a traced span ``(first, stop)`` of the chunk's
    drains it starts the profiler as drain ``first`` begins, stamps the
    span and each of its drains on the profiler's clock (the host's wall
    clock, ``time.time_ns``), and stops the profiler once drain
    ``stop - 1`` has finished on the device."""

    def __init__(self, mgr, device: torch.device):
        self.mgr = mgr
        self.cuda = device.type == "cuda"
        self.events: List = []
        self.log: List[tuple] = []
        self.span = None
        self.tracer = None
        self._orig = mgr.run_queued
        mgr.run_queued = self.drain

    def _event(self, k: int):
        while len(self.events) <= k:
            self.events.append(torch.cuda.Event(enable_timing=True))
        return self.events[k]

    def start(self, span=None, tracer=None) -> None:
        self.log = []
        self.span, self.tracer = span, tracer
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def close(self) -> None:
        """End the traced span (at its last drain, or the chunk's end)."""
        if self.tracer is not None and self.tracer.running:
            torch.cuda.synchronize()
            self.tracer.stop()
        self.span = None

    def drain(self) -> None:
        k = len(self.log)
        traced = self.span is not None and self.span[0] <= k < self.span[1]
        if traced and k == self.span[0]:
            self.tracer.start()
        cycle = self.mgr.telemetry.cycle
        w0 = time.time_ns()
        t0 = time.perf_counter()
        self._orig()
        t1 = time.perf_counter()
        if traced:
            self.tracer.drains.append((w0, time.time_ns()))
        if self.cuda:
            self._event(k).record()
            self.log.append((cycle, t1 - t0, None))
        else:
            self.log.append((cycle, t1 - t0, (t1 - self._start) * 1e3))
        if traced and k == self.span[1] - 1:
            self.close()

    def done_ms(self) -> List[float]:
        if not self.cuda:
            return [ms for _, _, ms in self.log]
        torch.cuda.synchronize()
        return [self._start.elapsed_time(self.events[k])
                for k in range(len(self.log))]


def _port_cfg(ctx: Context):
    if ctx.port_cfg is not None:
        return ctx.port_cfg
    from repro_torch.configs import get_config
    cfg = get_config(ctx.spec["port"]["arch"])
    check_port(ctx.spec, cfg)
    return cfg


def check_port(spec: dict, cfg) -> None:
    """The port's configuration is the file's: every width and count the
    file states, as the port names it."""
    pairs = {"num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
             "num_attention_heads": cfg.n_heads,
             "num_key_value_heads": cfg.n_kv_heads,
             "head_dim": cfg.head_dim, "intermediate_size": cfg.d_ff,
             "vocab_size": cfg.vocab, "rope_theta": cfg.rope_theta,
             "hidden_act": cfg.act,
             "tie_word_embeddings": cfg.tie_embeddings,
             "use_qkv_bias": cfg.qkv_bias, "torch_dtype": cfg.dtype}
    wrong = {k: (spec[k], v) for k, v in pairs.items() if spec[k] != v}
    if wrong:
        raise SystemExit(f"the port's {cfg.name} differs from "
                         f"configs/{spec['name']}.json: {wrong}")


def _caps(tr: dict) -> Dict[str, int]:
    return {t["name"]: t["rows"] for t in tr["tenants"]}


def _serve_chunk(engine, clock: DrainClock, reqs, span=None, tracer=None):
    from repro_torch.launch.serve import serve_continuous
    rids = [engine.submit(r.tenant, r.prompt, max_new=r.max_new,
                          arrive=r.arrive) for r in reqs]
    clock.start(span, tracer)
    out = serve_continuous([engine])[0]
    clock.close()
    return rids, out


def _joins(mgr, clock: DrainClock, rids) -> Dict[int, int]:
    """rid -> drain of the chunk that prefilled it, from the span
    ledger's cycle stamps."""
    drain_of = {}
    for k, (cycle, _, _) in enumerate(clock.log):
        drain_of[cycle] = k
    want = set(rids)
    out = {}
    for sp in mgr.telemetry.spans.closed:
        if sp.rid in want:
            c0 = next((s[1] for s in sp.segments if s[0] == "prefill"),
                      None)
            out[sp.rid] = drain_of.get(c0, -1) if c0 is not None else -1
    return out


def _records(k: int, reqs, rids, out, joins, clock: DrainClock,
             done: List[float]):
    """The chunk's request and drain records, from what the program
    returned and when each drain finished on the device."""
    rr = []
    for r, rid in zip(reqs, rids):
        j = joins.get(rid, -1)
        toks = list(out.get(rid, []))
        x = ReqRecord(chunk=k, tenant=r.tenant, prompt_len=len(r.prompt),
                      max_new=r.max_new, arrive=r.arrive, join=j,
                      tokens=toks)
        x.due_ms = done[min(r.arrive, len(done)) - 1] if r.arrive > 0 \
            else 0.0
        if 0 <= j and j + len(toks) <= len(done):
            x.token_ms = done[j:j + len(toks)]
        rr.append(x)
    by_join: Dict[int, List[ReqRecord]] = {}
    for x in rr:
        if x.join >= 0:
            by_join.setdefault(x.join, []).append(x)
    for j, xs in by_join.items():
        p = max(x.prompt_len for x in xs)
        for x in xs:
            x.plen = p
    drains = []
    for d, (_, host_s, _) in enumerate(clock.log):
        joiners = [x.prompt_len for x in by_join.get(d, [])]
        kv = [x.plen + (d - x.join) for x in rr
              if x.join >= 0 and x.join < d < x.join + len(x.tokens)]
        drains.append(DrainRecord(
            chunk=k, index=d, done_ms=done[d], host_s=host_s,
            joiners=joiners, plen=max(joiners, default=0), kv_lens=kv))
    return rr, drains


def _captures(mgr) -> int:
    st = mgr.jit_cache_stats()
    return st["graphs"] + st["graph_evictions"]


def _one_more(elapsed: float, chunks: int, seconds: float) -> bool:
    """Whether one more chunk, as long as the mean so far, ends the
    window nearer to ``seconds``."""
    return elapsed + 0.5 * elapsed / chunks < seconds


def _mark(ctx: Context, dev, phase: str) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ctx.marks.append((phase, time.perf_counter()))


def run(ctx: Context) -> Record:
    spec, tr = ctx.spec, ctx.traffic
    from repro_torch.launch.serve import ServeEngine
    ref = importlib.import_module(f"perfbench.reference.{spec['family']}")
    dev = torch.device(ctx.device)
    cfg = _port_cfg(ctx)
    _mark(ctx, dev, "program imported")
    weights = ref.make_weights(spec, ctx.seed, dev)
    _mark(ctx, dev, "weights")
    engine = ServeEngine(cfg, max_batch=tr["rows"], max_len=tr["max_len"],
                         paged=True, params=weights, device=dev)
    for t in tr["tenants"]:
        engine.register_tenant(t["name"], t["rows"] * engine.pages_per_req)
    mgr = engine.manager
    clock = DrainClock(mgr, dev)
    vocab = spec["vocab_size"]
    _mark(ctx, dev, "engine and pool")
    _serve_chunk(engine, clock, T.warmup_chunk(tr, ctx.seed, vocab))
    _mark(ctx, dev, "warm-up")
    rec = Record(spec=spec, traffic=tr)
    captures0 = _captures(mgr)
    t_win = time.perf_counter()
    rec.setup_s = t_win - ctx.t0
    chunks, prompts = [], []
    tracer = span = None
    if ctx.trace and dev.type == "cuda":
        from perfbench.trace import Tracer
        tracer = Tracer()
        span = (tr["trace"]["first_drain"],
                tr["trace"]["first_drain"] + tr["trace"]["drains"])
    k = 0
    while k == 0 or _one_more(time.perf_counter() - t_win, k, ctx.seconds):
        reqs = T.chunk(tr, ctx.seed, k, vocab)
        traced = tracer is not None and k == 0
        rids, out = _serve_chunk(engine, clock, reqs,
                                 span if traced else None, tracer)
        done = clock.done_ms()
        joins = _joins(mgr, clock, rids)
        rr, dd = _records(k, reqs, rids, out, joins, clock, done)
        if traced:
            for d in dd:
                if span[0] <= d.index < span[1]:
                    d.traced = d.index - span[0]
        rec.reqs += rr
        rec.drains += dd
        chunks.append(reqs)
        prompts += [r.prompt for r in reqs]
        k += 1
    # the window leaves out the profiler's own start and stop
    rec.window_s = time.perf_counter() - t_win \
        - (tracer.overhead_s if tracer else 0.0)
    rec.captures = _captures(mgr) - captures0
    if tracer is not None:
        rec.trace = tracer.reduce()
    if dev.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    # the program's state goes before the reference runs
    del engine, mgr, clock
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(ctx, rec, chunks, prompts, weights, ref, dev)
    return rec


def check(ctx: Context, rec: Record, chunks, prompts, weights, ref,
          dev) -> None:
    """Hold the window's output to the reference: the admission schedule
    worked out again from the trace, every request's token count, and the
    reference's logits at every served token of a sample of requests
    drawn from the seed, the longest among them."""
    tr, lim = ctx.traffic, ctx.limits
    rec.attempted = len(rec.reqs)
    rec.failed = sum(1 for x in rec.reqs
                     if len(x.tokens) != x.max_new or x.join < 0)
    mismatch = 0
    for k, reqs in enumerate(chunks):
        sched = S.simulate(reqs, tr["rows"], _caps(tr))
        mine = [x for x in rec.reqs if x.chunk == k]
        mismatch += sum(1 for x, j, p in zip(mine, sched.join, sched.plen)
                        if x.join != j or x.plen != p)
    rec.checks["schedule_mismatches"] = {
        "value": mismatch, "limit": lim["schedule_mismatches"]["limit"]}
    done = [i for i, x in enumerate(rec.reqs)
            if len(x.tokens) == x.max_new and x.join >= 0]
    if not done:
        rec.checks["widest_gap"] = {"value": float("inf"),
                                    "limit": lim["widest_gap"]["limit"]}
        return
    longest = max(done, key=lambda i: (len(rec.reqs[i].tokens), -i))
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng([ctx.seed % (1 << 64), 3])
    n = min(tr["check"]["requests"] - 1, len(rest))
    sample = [longest] + sorted(rng.choice(rest, size=n, replace=False)
                                .tolist() if n else [])
    ref.precision_off_tf32()
    widest, n_tok, control = 0.0, 0, 0.0
    for i in sample:
        x = rec.reqs[i]
        g = ref.served_gaps(ctx.spec, weights, prompts[i], x.plen,
                            x.tokens, dev)
        widest = max(widest, float(g.max()))
        n_tok += len(x.tokens)
        if ctx.control:
            g = ref.served_gaps(ctx.spec, weights, prompts[i], x.plen,
                                x.tokens, dev, control=True)
            control = max(control, float(g.max()))
    rec.checks["widest_gap"] = {"value": widest,
                                "limit": lim["widest_gap"]["limit"]}
    if ctx.control:
        rec.control_widest_gap = control
    rec.checked_tokens = n_tok

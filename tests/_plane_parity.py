"""Shared helpers of the control-plane mirrors
(``tests/test_torch_elastic.py``, ``test_torch_tenantclass.py``,
``test_torch_violations.py``,
``test_torch_spans.py``, ``test_torch_telemetry.py``).

A scenario is written once against a framework adapter and run on the
reference and on the port (the CPU), as ``tests/_tenant_parity.py`` does
for the tenant-kernel plane; these adapters add the serving plane: the
reduced stablelm-3b on the reference's weights (seed 0), the port's
engines on ``params_from_jax`` of them, compiled or eager.  The
``*_view`` functions turn what a run left behind into plain values the
two sides are compared on field by field: closed spans and the span
ledger, the registry's logical snapshot and its Prometheus text without
the wall-clock series, the trace's events without their timestamps, the
elastic manager's events, stats and bounds, and the violation log.
"""

from __future__ import annotations

import copy
import importlib

import numpy as np
import torch

import repro.core as RJ
import repro_torch.core as RT
from _tenant_parity import JAX, TORCH, _JaxFW, _TorchFW
from _torch_parity import np_of, params_np
from repro.configs import get_config as get_config_j
from repro.launch import serve as SJ
from repro_torch.configs import get_config as get_config_t
from repro_torch.launch import serve as ST
from repro_torch.models.convert import params_from_jax

CFG_J = get_config_j("stablelm-3b").reduced()
CFG_T = get_config_t("stablelm-3b").reduced()


class _TorchJitFW(_TorchFW):
    """The port with its launches compiled (``jit_trusted=True``, each
    launch through its step graph) or eager (``False``)."""

    def __init__(self, jit: bool):
        self.jit = jit
        self.name = f"torch[{'compiled' if jit else 'eager'}]"

    def manager(self, **kw):
        kw["jit_trusted"] = self.jit
        return RT.GuardianManager(device="cpu", **kw)


COMPILED, EAGER = _TorchJitFW(True), _TorchJitFW(False)
SIDES = {"compiled": COMPILED, "eager": EAGER}


_REF_RUNS = {}


def on_both(side, scenario, cache: bool = True):
    """``scenario(fw)`` on the reference and on the port's ``side``
    (``"compiled"`` or ``"eager"``).  The reference's result is kept per
    scenario (its code object), so a test parametrised over the port's
    sides runs the reference once; ``cache=False`` for a scenario that
    closes over drawn values."""
    key = scenario.__code__
    if not cache:
        ref = scenario(JAX)
    elif key in _REF_RUNS:
        ref = _REF_RUNS[key]
    else:
        ref = _REF_RUNS[key] = scenario(JAX)
    return ref, scenario(SIDES[side])


def module(fw, name: str):
    """``repro.core.<name>`` or ``repro_torch.core.<name>`` (a module, not
    the function a package may export under the same name)."""
    pkg = "repro" if fw is JAX else "repro_torch"
    return importlib.import_module(f"{pkg}.core.{name}")


# -- the serving plane ------------------------------------------------------

_PARAMS = {}


def reference_params():
    """The reduced stablelm-3b's reference weights (``seed=0``, as every
    reference engine below draws them), as port params on the CPU."""
    if "t" not in _PARAMS:
        eng = SJ.ServeEngine(CFG_J, max_batch=2, max_len=16, seed=0)
        _PARAMS["t"] = params_from_jax(params_np(eng.params), device="cpu")
    return _PARAMS["t"]


class Serve:
    """A serving side: the reference (``fw`` is ``JAX``) or the port,
    compiled or eager, with ``make_shared_manager`` / ``ServeEngine`` /
    ``serve_continuous`` / ``serve_engines`` of its package."""

    def __init__(self, fw):
        self.fw = fw
        self.ref = fw is JAX or isinstance(fw, _JaxFW)
        self.sv = SJ if self.ref else ST

    def manager(self, n, **kw):
        if self.ref:
            return SJ.make_shared_manager(n, **kw)
        return ST.make_shared_manager(n, device="cpu",
                                      jit_trusted=self.fw.jit, **kw)

    def engine(self, **kw):
        if self.ref:
            return SJ.ServeEngine(CFG_J, **kw)
        if kw.get("manager") is None:
            kw.setdefault("jit_steps", self.fw.jit)
        return ST.ServeEngine(CFG_T, device="cpu",
                              params=reference_params(), **kw)

    def continuous(self, engines, **kw):
        return self.sv.serve_continuous(engines, **kw)

    def lockstep(self, engines, **kw):
        return self.sv.serve_engines(engines, **kw)


SERVE_REF = Serve(JAX)
SERVE_SIDES = {"compiled": Serve(COMPILED), "eager": Serve(EAGER)}


# -- comparison views -------------------------------------------------------

def spans_view(tel) -> dict:
    """Every closed span's ``to_dict()`` (no wall-clock field in it), the
    ledger's ``to_dict()``, its totals and open count."""
    return {"closed": [sp.to_dict() for sp in tel.spans.closed],
            "ledger": tel.spans.to_dict(),
            "totals": dict(tel.spans.totals),
            "open": tel.spans.open_count()}


def prometheus_logical(reg) -> str:
    """``to_prometheus()`` with the wall-clock (timing) series removed."""
    timing = {f"guardian_{n}" for n in reg._timing_names}

    def metric(line):
        name = line.split()[2] if line.startswith("# TYPE") \
            else line.split("{")[0].split(" ")[0]
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in timing:
                return name[:-len(suffix)]
        return name

    return "\n".join(ln for ln in reg.to_prometheus().splitlines()
                     if metric(ln) not in timing)


def trace_view(trace) -> list:
    """``to_chrome()``'s events as (phase, name, track, cycle, flow id),
    timestamps left out."""
    evs = trace.to_chrome()["traceEvents"]
    tracks = {e["tid"]: e["args"]["name"] for e in evs
              if e.get("ph") == "M" and e["name"] == "thread_name"}
    return [(e["ph"], e["name"], tracks.get(e.get("tid"), "guardian"),
             e.get("args", {}).get("cycle"), e.get("id"))
            for e in evs if e.get("ph") != "M"]


def telemetry_view(tel) -> dict:
    """The recorder's logical surface: registry snapshot and Prometheus
    text without timing, the trace's events, its counts, the spans."""
    return {"snapshot": tel.registry.snapshot(include_timing=False),
            "prometheus": prometheus_logical(tel.registry),
            "trace": trace_view(tel.trace),
            "emitted": tel.trace.emitted, "dropped": tel.trace.dropped,
            "spans": spans_view(tel)}


def bounds_view(mgr) -> dict:
    """The bounds table: each live partition's (base, size)."""
    tab = mgr.bounds
    return {t: (p.base, p.size) for t, p in sorted(
        ((t, tab.lookup(t)) for t in tab.tenants()), key=lambda x: x[0])}


def elastic_view(mgr) -> dict:
    el = mgr.elastic
    return {"events": list(el.events), "stats": dict(el.stats),
            "bounds": bounds_view(mgr),
            "waitlist": [w.tenant_id for w in el.waitlist]}


def violog_view(mgr) -> dict:
    log = mgr.violog
    snap = np_of(log.snapshot())
    return {"snapshot": snap.tolist(),
            "rows": {t: log.row_of(t) for t in sorted(log.tenants())},
            "capacity": log.capacity}


def logical_report(report) -> dict:
    """``metrics_report()`` with its wall-clock figures zeroed (the
    tenants' request latencies, the drain cycles' wall time, the launch
    path's nanoseconds), counts kept — what the dashboard's text is
    compared on."""
    rep = copy.deepcopy(report)

    def zero(p):
        return {k: (v if k == "count" else 0.0) for k, v in p.items()}

    for row in rep.get("tenants", {}).values():
        row["latency"] = zero(row["latency"])
    if "drain" in rep:
        rep["drain"] = zero(rep["drain"])
    if "launch" in rep:
        rep["launch"] = {k: 0.0 for k in rep["launch"]}
    return rep


def arena_bytes(mgr) -> np.ndarray:
    return np_of(mgr.arena.buf).copy()


def to_np(x):
    """numpy of a JAX array or torch tensor; anything else as it is."""
    if isinstance(x, torch.Tensor) or type(x).__module__.startswith("jax"):
        return np_of(x)
    return x


__all__ = ["JAX", "TORCH", "COMPILED", "EAGER", "SIDES", "RJ", "RT",
           "on_both",
           "CFG_J", "CFG_T", "Serve", "SERVE_REF", "SERVE_SIDES", "module",
           "reference_params", "spans_view", "prometheus_logical",
           "trace_view", "telemetry_view", "bounds_view", "elastic_view",
           "violog_view", "logical_report", "arena_bytes", "to_np"]

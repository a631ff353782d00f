"""The harness: finds a cell and everything that belongs to it by name,
hands it to its driver, reads every metric of the run through the
metric's own reader, and assembles the result line.

Files, all found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: the model's published configuration, what the
  port changes, and the port's architecture to serve;
* ``traffic/<traffic>.json``: the mix, including the ``driver`` that
  serves it (``drivers/<driver>.py``);
* ``checks/<cell>.json``: each number the output check compares, with
  its limit and the readings it was set from;
* ``metrics/<metric>.py``: one reader per metric, ``read(record)``
  returning a number or None where the run gives it nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT.parent) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


@dataclasses.dataclass
class Context:
    """What a driver needs for one run."""
    cell: str
    spec: dict                  # configs/<config>.json
    traffic: dict               # traffic/<traffic>.json
    limits: dict                # checks/<cell>.json
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = 0.0             # process start on the host clock
    port_cfg: Any = None        # the program's config (tests: reduced)
    #: (phase, host clock at its end) through set-up, for the run's log
    marks: List[tuple] = dataclasses.field(default_factory=list)
    #: set only by control.py: also read the float8 control over the
    #: checked sample (the benchmark's runs never do)
    control: bool = False


@dataclasses.dataclass
class ReqRecord:
    chunk: int
    tenant: str
    prompt_len: int
    max_new: int
    arrive: int
    join: int = -1              # drain (of its chunk) that prefilled it
    plen: int = 0               # its padded prompt length
    tokens: List[int] = dataclasses.field(default_factory=list)
    due_ms: float = 0.0         # device clock of its chunk
    token_ms: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DrainRecord:
    chunk: int
    index: int
    done_ms: float              # device completion, from the chunk start
    host_s: float               # host wall inside run_queued
    joiners: List[int]          # real prompt lengths prefilled here
    plen: int                   # their padded length (0: no prefill)
    kv_lens: List[int]          # attended length of each decoding row
    traced: int = -1            # its index among the traced drains


@dataclasses.dataclass
class Record:
    """One run's timeline, for the metric readers."""
    spec: dict
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    reqs: List[ReqRecord] = dataclasses.field(default_factory=list)
    drains: List[DrainRecord] = dataclasses.field(default_factory=list)
    captures: int = 0
    trace: Any = None           # trace.Reduced of the traced chunk
    memory_peak_bytes: int = 0
    checks: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checked_tokens: int = 0
    control_widest_gap: Optional[float] = None


def read_metric(name: str, rec: Record) -> Optional[float]:
    mod = importlib.import_module(f"perfbench.metrics.{name}")
    return mod.read(rec)


def driver(traffic: dict):
    return importlib.import_module(f"perfbench.drivers.{traffic['driver']}")


def context(bench: dict, cell_name: str, **kw) -> Context:
    cell = cell_of(bench, cell_name)
    return Context(cell=cell_name,
                   spec=load_json(ROOT / "configs" / f"{cell['config']}.json"),
                   traffic=load_json(ROOT / "traffic"
                                     / f"{cell['traffic']}.json"),
                   limits=load_json(ROOT / "checks" / f"{cell_name}.json"),
                   **kw)


def metrics_of(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]


def loaded_forbidden() -> List[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def result(bench: dict, ctx: Context, rec: Record, device: dict) -> dict:
    """The result line: the cell's metrics of this kind of run, each read
    by its own reader (a metric with nothing to read is left out), and
    the numbers compared with their limits, last."""
    metrics = {}
    for m in metrics_of(bench, ctx.cell, ctx.trace):
        v = read_metric(m["name"], rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = rec.failed == 0 and all(
        c["value"] <= c["limit"] for c in rec.checks.values())
    out = {"correct": correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": device}
    if ctx.trace and rec.trace is not None:
        out["breakdown"] = {
            "device_ops": rec.trace.top_ops(10),
            "idle_gaps": [[n, s] for n, s in rec.trace.gaps[:10]]}
    out["checks"] = rec.checks
    return out


def run(ctx: Context) -> Record:
    """Serve the cell through its traffic's driver (set-up, warm-up, the
    window, then the output check)."""
    return driver(ctx.traffic).run(ctx)

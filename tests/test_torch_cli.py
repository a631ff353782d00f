"""The port's command lines against the reference's: ``python -m
repro_torch.launch.serve`` (slab lockstep serving) and ``python -m
repro_torch.top`` with its renderer ``repro_torch.launch.dashboard``.

The serve CLI runs in-process on the reference's weights (``main(argv,
params=)``) for the four serve-smoke argument sets of
``.github/workflows/ci.yml`` and the README's quickstart: the same request
lines, decode steps, scheduler launches and mean step width as
``repro.launch.serve.main``.  The dashboard renders one reference
``metrics_report()`` to the same text in both packages."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_parity import params_np  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch import dashboard as DJ  # noqa: E402
from repro.launch import serve as SJ  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro_torch import top as TOP  # noqa: E402
from repro_torch.launch import dashboard as DT  # noqa: E402
from repro_torch.launch import serve as ST  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the serve smokes of .github/workflows/ci.yml and README.md's quickstart
ARGSETS = {
    "mixed_policies": "--tenants 3 --requests 3 --tokens 4 "
                      "--policies modulo,check",
    "baseline": "--tenants 2 --requests 2 --tokens 4",
    "eager": "--tenants 2 --requests 2 --tokens 4 --no-jit",
    "multi_engine": "--engines 2 --tenants 1 --requests 2 --tokens 4",
    "readme": "--tenants 3 --requests 2 --tokens 4 --classes lc,be",
}


def _argv(name):
    return ["--arch", "stablelm-3b", "--reduced"] + ARGSETS[name].split()


def _run(main, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv, **kw)
    return out.getvalue()


_SUMMARY = re.compile(
    r"(\d+) requests, (\d+) tokens each, [\d.]+s total, (\d+) decode "
    r"steps, (\d+) scheduler launches, mean step width ([\d.]+)")


def _parts(text):
    """The printed lines but the wall time: request and tenant lines, and
    (requests, tokens, decode steps, launches, mean width)."""
    lines = text.splitlines()
    summary = [m.groups() for m in map(_SUMMARY.fullmatch, lines) if m]
    assert len(summary) == 1, text
    return [ln for ln in lines if not _SUMMARY.fullmatch(ln)], summary[0]


@pytest.fixture(scope="module")
def reference_weights():
    cfg = get_config("stablelm-3b").reduced()
    return params_from_jax(
        params_np(get_model(cfg).init(jax.random.PRNGKey(0))),
        device="cpu")


@pytest.fixture(scope="module")
def reference_runs():
    """The reference CLI's output per argument set, computed on first
    use."""
    runs = {}

    def run(name):
        if name not in runs:
            runs[name] = _run(SJ.main, _argv(name))
        return runs[name]

    return run


@pytest.mark.parametrize("name", sorted(ARGSETS))
def test_serve_cli_prints_the_reference_lines(name, reference_weights,
                                              reference_runs):
    """``main(argv + ["--device", "cpu"])`` on the reference's weights
    prints the reference's request (and tenant) lines; decode steps,
    scheduler launches and mean step width are equal."""
    got = _parts(_run(ST.main, _argv(name) + ["--device", "cpu"],
                      params=reference_weights))
    want = _parts(reference_runs(name))
    assert got == want
    assert any(ln.startswith("engine0 req 0: [") for ln in got[0])


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-350m"])
def test_serve_cli_serves_the_recurrent_families(arch):
    """``--arch zamba2-7b --reduced`` (the hybrid) and ``--arch xlstm-350m
    --reduced`` (the xLSTM) on the reference's seed-0 weights print the
    reference's request and tenant lines, decode steps, scheduler
    launches and mean step width, on the slab layout."""
    argv = ["--arch", arch, "--reduced"] + ARGSETS["baseline"].split()
    params = params_from_jax(params_np(get_model(
        get_config(arch).reduced()).init(jax.random.PRNGKey(0))),
        device="cpu")
    got = _parts(_run(ST.main, argv + ["--device", "cpu"], params=params))
    assert got == _parts(_run(SJ.main, argv))
    assert any(ln.startswith("engine0 req 0: [") for ln in got[0])


def test_serve_cli_writes_the_bench_row_and_trace(tmp_path,
                                                  reference_weights):
    """``--bench-out`` appends the reference's CSV row (its launches and
    mean width) and ``--trace-out`` writes a Perfetto trace."""
    bench, trace = tmp_path / "bench.csv", tmp_path / "trace.json"
    text = _run(ST.main, _argv("baseline") + [
        "--device", "cpu", "--bench-out", str(bench), "--bench-name",
        "serve.smoke.baseline", "--trace-out", str(trace)],
        params=reference_weights)
    row = bench.read_text().strip().split(",")
    assert row[0] == "serve.smoke.baseline" and float(row[1]) > 0
    assert row[2] == "requests=2;tokens=8;launches=5;mean_width=0.0"
    events = json.loads(trace.read_text())
    assert events["traceEvents"]
    assert f"trace: {trace} (" in text


def test_serve_cli_parses_the_reference_flags_and_the_device():
    """Every flag of the reference's ``main``, with its default, plus
    ``--device`` defaulting to the card."""
    args = ST.parse_args([])
    assert vars(args) == {
        "arch": "stablelm-3b", "reduced": False, "tenants": 3,
        "requests": 6, "tokens": 16, "no_guard": False, "no_jit": False,
        "engines": 1, "policies": "", "classes": "", "bench_out": None,
        "bench_name": "serve.smoke", "trace_out": None, "device": "cuda"}


def test_serve_cli_builds_shared_managers_and_guards(reference_weights):
    """``build_engines``: ``--engines 2`` co-hosts two slab engines on one
    manager of 32 slots, sharing the given weights; ``--no-guard`` builds
    engines that fence nothing; ``--no-jit`` an eager manager."""
    args = ST.parse_args(_argv("multi_engine") + ["--device", "cpu"])
    engines = ST.build_engines(args, params=reference_weights)
    assert len(engines) == 2 and engines[0].manager is engines[1].manager
    assert engines[0].manager.bounds.total_slots == 32
    assert all(e.params is reference_weights and not e.paged
               for e in engines)
    (eng,) = ST.build_engines(ST.parse_args(
        ["--reduced", "--no-guard", "--no-jit", "--device", "cpu"]),
        params=reference_weights)
    assert not eng.guard_enabled and not eng.manager.jit_trusted
    eng.register_tenant("t", 2)
    assert eng._guard_for_rows([None] * 8) is None


def test_serve_module_runs_as_a_command():
    """``python -m repro_torch.launch.serve ... --device cpu`` runs in a
    process of its own (its own weights, seed 0) and prints one request
    line per request."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "stablelm-3b", "--reduced", "--tenants", "2", "--requests", "2",
         "--tokens", "2", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert sum(ln.startswith("engine0 req ") for ln in lines) == 2
    assert _SUMMARY.fullmatch(lines[-1])


# ---------------------------------------------------------------------------
# The dashboard
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_report():
    """One reference ``metrics_report()`` and its registry: the
    reference's own demo (``repro.top``) driven a few cycles."""
    from repro import top as TJ

    mgr, clients, ptrs = TJ.build_demo(3)
    TJ.drive(mgr, clients, ptrs, 3)
    return mgr.metrics_report(), mgr.telemetry.registry


def test_format_report_renders_the_reference_text(reference_report):
    """``format_report`` of one reference report gives the reference's
    text, with and without the registry's sparklines."""
    report, registry = reference_report
    assert DT.format_report(report) == DJ.format_report(report)
    assert DT.format_report(report, registry=registry) == \
        DJ.format_report(report, registry=registry)
    assert DT.format_tenants(report) == DJ.format_tenants(report)


@pytest.mark.parametrize("values", [[], [0, 0], [1, 2, 3, 8, 0.5],
                                    [5.0], [-1, 3, 1e6]])
def test_sparkline_matches_reference(values):
    assert DT.sparkline(values) == DJ.sparkline(values)


def test_format_report_of_a_sparse_report_matches_reference():
    """A report missing panels (an operator's partial scrape) renders the
    same defaults in both packages."""
    report = {"tenants": {"t0": {"state": "active", "policy": "check",
                                 "class": "latency_critical",
                                 "partition": {"base": 4, "size": 4},
                                 "latency": {"count": 2, "p50": 1500.0,
                                             "p99": 2.5e6},
                                 "slo": {"attained": 1, "violated": 1}}},
              "trace": {"events": 3, "emitted": 9, "dropped": 6,
                        "capacity": 3},
              "slo": {"classes": {"best_effort": {
                  "attained": 2, "violated": 1, "attainment": 0.667,
                  "causes": {"hold": 1}}}}}
    assert DT.format_report(report) == DJ.format_report(report)


def test_top_snapshot_renders_on_the_cpu(capsys, tmp_path):
    """``python -m repro_torch.top --snapshot --device cpu`` drives the
    demo (a PyTorch tenant kernel per tenant, one policy each) and renders
    every panel; ``--json`` and ``--prom`` dump the report and the
    exposition."""
    trace = tmp_path / "trace.json"
    assert TOP.main(["--snapshot", "--device", "cpu", "--cycles", "2",
                     "--trace-out", str(trace)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("guardian flight recorder — 3 tenant(s)")
    for panel in ("tenants", "scheduler", "drain cycles", "jit cache",
                  "elastic", "memory", "launch path", "violations",
                  "slo ledger", "trace"):
        assert f"── {panel} " in out
    for i, pol in enumerate(TOP.DEMO_POLICIES):
        assert re.search(rf"tenant{i}\s+active\s+{pol}", out)
    assert json.loads(trace.read_text())["traceEvents"]
    assert TOP.main(["--json", "--device", "cpu", "--cycles", "1",
                     "--tenants", "2"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert sorted(report["tenants"]) == ["tenant0", "tenant1"]
    assert TOP.main(["--prom", "--device", "cpu", "--cycles", "1"]) == 0
    assert "# TYPE" in capsys.readouterr().out


def test_top_demo_launches_fence_and_land():
    """The demo's tenant kernel runs fenced under each policy: after ``n``
    cycles every tenant's 16 slots hold the recurrence's value, the same
    in every tenant."""
    mgr, clients, ptrs = TOP.build_demo(3, device="cpu")
    TOP.drive(mgr, clients, ptrs, 3)
    want = np.zeros(16, np.float32)
    for _ in range(3):
        want = want * np.float32(1.0001) + np.float32(1.0)
    for c, p in zip(clients, ptrs):
        got = c.memcpy_d2h(p, 16)
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_multi_tenant_serving_example_prints_the_reference_lines():
    """``repro_torch.examples.multi_tenant_serving`` (``--device cpu``, on
    the reference's weights) prints every line of the reference's
    ``examples/multi_tenant_serving.py``: the partitions, the co-located
    generations, solo = co-located, and the forged slot that leaves the
    victim's KV rows as they were."""
    import importlib.util
    from repro_torch.examples import multi_tenant_serving as MT
    spec = importlib.util.spec_from_file_location(
        "multi_tenant_serving_ref",
        os.path.join(ROOT, "examples", "multi_tenant_serving.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        ref.main()
    cfg = get_config("stablelm-3b").reduced()
    params = params_from_jax(params_np(get_model(cfg).init(
        jax.random.PRNGKey(0))), device="cpu")
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        res = MT.main(["--device", "cpu"], params=params)
    assert got.getvalue() == want.getvalue()
    assert res["solo_identical"] and not res["victim_changed"]

"""``python -m repro_torch.lint``: the port's static bounds audit against its
committed baseline (``results/lint_torch.baseline.json``).  Mirrors the
lint tests of ``tests/test_verifier.py``."""

import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch import lint  # noqa: E402
from repro_torch.core.verifier import verify  # noqa: E402


def test_lint_strict_passes_against_the_committed_baseline(capsys):
    assert lint.main(["--strict"]) == 0
    out = capsys.readouterr().out
    assert "0 problem(s)" in out
    for name, _ in lint.NOT_PORTED:
        assert f"== {name}\n  NOT PORTED" in out
    baseline = json.loads(lint.DEFAULT_BASELINE.read_text())
    assert sorted(baseline) == sorted(n for n, _ in lint.AUDITS)


def test_lint_strict_fails_below_the_baseline(tmp_path, monkeypatch,
                                              capsys):
    """An audit whose proven fraction fell below its baseline's makes
    ``--strict`` exit nonzero (here: the gather audited without its
    fence)."""
    def unfenced():
        from repro_torch.kernels import ref

        def kernel(table, base, mask, idx):
            return table, ref.gather_rows_ref(table, idx, 0, -1)
        return verify(kernel, (torch.zeros(256, 8),
                               torch.zeros((), dtype=torch.int32),
                               torch.zeros((), dtype=torch.int32),
                               torch.zeros(16, dtype=torch.int32)),
                      bound_argnums=(1, 2))

    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"kernels.gather_rows": {
        "fenced": 0, "fully_proven": True, "mode": "row", "proven": 1,
        "proven_fraction": 1.0, "refuted": 0, "sites": 1}}))
    args = ["--strict", "--only", "kernels.gather", "--baseline", str(base)]
    assert lint.main(args) == 0
    monkeypatch.setattr(lint, "AUDITS", (("kernels.gather_rows",
                                          unfenced),))
    assert lint.main(args) == 1
    assert "proven fraction regressed 1.0 -> 0.0" in capsys.readouterr().out


def test_lint_kernel_audits_fully_proven():
    """Mirror of ``test_lint_kernel_audits_fully_proven``: the gather,
    scatter and paged-attention plain versions audit fully proven with at
    least one site each."""
    summaries, errors = lint.run_audits(only="kernels.")
    assert not errors
    for name in ("kernels.gather_rows", "kernels.scatter_pages",
                 "kernels.paged_attention"):
        assert summaries[name]["fully_proven"], summaries[name]
        assert summaries[name]["sites"] >= 1


def test_lint_slab_serve_steps_fully_proven():
    """The slab serve steps are audited (``NOT_PORTED`` is empty: the
    train step is audited too) and fully proven: the prefill's 4 sites (each layer's K
    and V slab read of the ``permute`` write, by the fenced slot id) and
    the decode's 16 (each layer's append — slot, page and offset, K and V
    — and K1's two declared loads over the slab view).  The reference
    audits the same steps over a ``scan``: 6 / 6 proven in its prefill
    (its inverse-page scatters are sites; the port forms them by
    comparison) and 2 / 4 in its decode, whose append index holds the
    scan's layer carry (``results/lint.baseline.json``)."""
    assert [n for n, _ in lint.NOT_PORTED] == []
    summaries, errors = lint.run_audits(only="steps.serve.")
    assert not errors
    assert {n: (s["proven"], s["sites"]) for n, s in summaries.items()
            if n in ("steps.serve.prefill", "steps.serve.decode")} == \
        {"steps.serve.prefill": (4, 4), "steps.serve.decode": (16, 16)}
    ref = json.loads((lint.DEFAULT_BASELINE.parent
                      / "lint.baseline.json").read_text())
    assert (ref["steps.serve.prefill"]["proven"],
            ref["steps.serve.prefill"]["sites"]) == (6, 6)
    assert (ref["steps.serve.decode"]["proven"],
            ref["steps.serve.decode"]["sites"]) == (2, 4)
    baseline = json.loads(lint.DEFAULT_BASELINE.read_text())
    for name in ("steps.serve.prefill", "steps.serve.decode"):
        assert baseline[name] == summaries[name]


def test_lint_train_step_audit():
    """The train step is audited as the reference's ``_audit_train_step``
    builds it (reduced stablelm-3b at (32, 2), remat off, the params as
    the arena): the embedding gather (K3) and its scatter-add gradient
    (K3's backward, a declared store into the table's rows) both PROVEN,
    their ids inside the train guard's 256-row vocab partition — 2 / 2,
    where the reference reads 1 / 1: its scatter-add goes into a fresh
    zeros buffer, which its verifier does not count as the params."""
    summaries, errors = lint.run_audits(only="steps.train")
    assert not errors
    assert (summaries["steps.train"]["proven"],
            summaries["steps.train"]["sites"]) == (2, 2)
    step, operands = lint.train_fixture()
    assert (step.guard.vocab.base, step.guard.vocab.size) == (0, 256)
    proof = verify(step.fn, operands, arena_argnums=(0,), mode="extent")
    assert [(s.prim, s.kind.name, s.verdict, s.interval)
            for s in proof.sites] == [
        ("gather_rows", "GATHER", "proven", "[0, 255]"),
        ("gather_rows_backward", "SCATTER", "proven", "[0, 255]")]
    ref = json.loads((lint.DEFAULT_BASELINE.parent
                      / "lint.baseline.json").read_text())["steps.train"]
    assert (ref["proven"], ref["sites"]) == (1, 1)
    baseline = json.loads(lint.DEFAULT_BASELINE.read_text())
    assert baseline["steps.train"] == summaries["steps.train"]

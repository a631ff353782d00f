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

"""``python -m repro_torch.launch.train`` and the training examples on the
CPU: the reference's line format and summary keys, the loss falling over
50 reduced steps (mirror of ``test_system.py::test_training_reduces_loss``),
``--stop-after`` / ``--resume`` restart-exact, ``--device`` left at the
card on a machine without one, and ``repro_torch.examples.train_100m`` /
``preemption_resume`` with their printed lines."""

import contextlib
import io
import json
import re
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import preemption_resume, \
    train_100m  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402

STEP_LINE = re.compile(r"^step +\d+ loss \d+\.\d{4} \(\d+ ms/step\)$")


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = T.main(argv)
    return summary, out.getvalue().splitlines()


def _reference_run(argv):
    from repro.launch import train as TJ
    old, out = sys.argv, io.StringIO()
    sys.argv = ["train", *argv]
    try:
        with contextlib.redirect_stdout(out):
            summary = TJ.main()
    finally:
        sys.argv = old
    return summary, out.getvalue().splitlines()


def test_cli_reduces_loss_with_the_reference_lines():
    """The acceptance command: 50 reduced steps lose more than 0.3 nats;
    every printed line has the reference's format and the summary its
    keys (the reference run for the keys is 2 steps long)."""
    argv = ["--arch", "stablelm-3b", "--reduced", "--steps", "50",
            "--batch", "4", "--seq", "64", "--lr", "5e-3"]
    summary, lines = _run(argv + ["--device", "cpu"])
    assert summary["final_loss"] < summary["first_loss"] - 0.3
    steps = [ln for ln in lines if ln.startswith("step")]
    assert len(steps) == 5 and all(STEP_LINE.match(ln) for ln in steps)
    assert json.loads(lines[-1]) == summary
    ref, ref_lines = _reference_run(["--arch", "stablelm-3b", "--reduced",
                                     "--steps", "2", "--batch", "4",
                                     "--seq", "64"])
    assert sorted(summary) == sorted(ref)
    assert all(STEP_LINE.match(ln) for ln in ref_lines
               if ln.startswith("step"))


def test_cli_stop_after_and_resume_are_restart_exact(tmp_path):
    """A run stopped after step 6 (checkpointed), resumed to 12, ends on
    the uninterrupted run's loss, bit for bit on the CPU; the summaries
    carry the reference's keys (``preempted_at`` on the stopped run)."""
    base = ["--arch", "minicpm-2b", "--reduced", "--steps", "12", "--batch",
            "2", "--seq", "32", "--ckpt-every", "4", "--log-every", "4",
            "--schedule", "wsd", "--device", "cpu"]
    ref, _ = _run(base + ["--ckpt-dir", str(tmp_path / "ref")])
    stopped, lines = _run(base + ["--ckpt-dir", str(tmp_path / "pre"),
                                  "--stop-after", "6"])
    assert stopped["preempted_at"] == 6 and stopped["steps"] == 6
    assert any(ln.startswith("[preemption] stopping at step 6")
               for ln in lines)
    resumed, lines = _run(base + ["--ckpt-dir", str(tmp_path / "pre"),
                                  "--resume"])
    assert "resumed from step 6" in lines and resumed["steps"] == 6
    assert resumed["final_loss"] == ref["final_loss"]
    assert sorted(ref) == ["final_loss", "first_loss", "steps",
                           "stragglers"]


def test_cli_device_defaults_to_the_card():
    """Without ``--device`` the CLI trains on the card; on a machine
    without one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        T.main(["--arch", "stablelm-3b", "--reduced", "--steps", "1"])


def test_train_100m_tiny_example(tmp_path, capsys):
    summary = train_100m.main(["--tiny", "--device", "cpu", "--ckpt-dir",
                               str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert summary["steps"] == 60
    assert summary["final_loss"] < summary["first_loss"] - 1.0
    assert out[-1] == (f"loss {summary['first_loss']:.3f} -> "
                       f"{summary['final_loss']:.3f} over 60 steps; "
                       f"checkpoints in {tmp_path} (restart with --resume)")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000000025", "step_000000000050", "step_000000000060"]


def test_preemption_resume_example(capsys):
    """Three ``python -m repro_torch.launch.train`` processes: the
    restarted run's final loss within 1e-5 of the uninterrupted one's."""
    diff = preemption_resume.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert diff < 1e-5
    assert "(restart-exact: True)" in out
    for line in ("1) uninterrupted run: 60 steps",
                 "3) restart with --resume: continues 40 -> 60"):
        assert line in out

"""The output check fails a broken timed path: the harness driven end to
end on the reduced config on the CPU (skipping only its look for a card),
with the program broken underneath, reads ``correct`` false; unbroken, it
reads true.  And without a card the command prints no result."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.tests.cells import CHECKOUT, small_context


def _correct(seed=2**31 + 99):
    bench, ctx = small_context(seed=seed)
    rec = harness.run(ctx)
    return harness.result(bench, ctx, rec, {})


def test_sound_run_is_correct():
    out = _correct()
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["widest_gap"]["value"] <= \
        out["checks"]["widest_gap"]["limit"]


def test_token_altered_where_produced(monkeypatch):
    from repro_torch.models import transformer as TF
    real = TF.decode

    def altered(*a, **kw):
        cache, logits = real(*a, **kw)
        return cache, logits.roll(1, dims=-1)

    monkeypatch.setattr(TF, "decode", altered)
    out = _correct()
    assert out["correct"] is False
    assert out["checks"]["widest_gap"]["value"] > \
        out["checks"]["widest_gap"]["limit"]


def test_decode_step_leaves_its_state_unchanged(monkeypatch):
    from repro_torch.models import kvcache as KV
    monkeypatch.setattr(KV, "append_token_kv", lambda *a, **kw: None)
    out = _correct()
    assert out["correct"] is False


def test_prefill_leaves_its_state_unchanged(monkeypatch):
    from repro_torch.models import kvcache as KV
    monkeypatch.setattr(KV, "write_prefill_kv", lambda *a, **kw: None)
    out = _correct()
    assert out["correct"] is False


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "stablelm-3b.chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "stablelm-3b.chat", "--seed", str(2**31 + 5), "--seconds", "2",
         "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True,
        timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"

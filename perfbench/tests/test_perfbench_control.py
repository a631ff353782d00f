"""The control comes out not correct: the reference put in the program's
place with its products a precision below the served bfloat16 (float8
e4m3), decoding greedily, fails each cell's widest-gap limit, where the
reference's own greedy tokens read 0.  At a size a CPU test holds (d 512,
4 layers, vocab 8,192, bfloat16 weights); on the card the same control
runs at the cells' own size (``perfbench/control.py``, PERF.md §6)."""

import json

import numpy as np
import pytest
import torch

from perfbench.harness import ROOT
from perfbench.reference import dense as R

SPEC = json.loads((ROOT / "configs" / "stablelm-3b.json").read_text())
MID = dict(SPEC, hidden_size=512, num_attention_heads=8,
           num_key_value_heads=8, head_dim=64, intermediate_size=1376,
           vocab_size=8192, num_hidden_layers=4)


def _greedy(w, prompt, n, mm):
    seq = list(prompt)
    out = []
    for _ in range(n):
        lg = R.logits(MID, w, torch.as_tensor(seq),
                      torch.tensor([len(seq) - 1]), mm=mm)
        out.append(int(lg.argmax()))
        seq.append(out[-1])
    return out


@pytest.fixture(scope="module")
def readings():
    """(seed, the control's widest gap, the reference's own) per seed."""
    out = []
    for seed in (1, 2):
        w = R.make_weights(MID, seed, torch.device("cpu"))
        rng = np.random.default_rng(seed)
        widest = 0.0
        for _ in range(3):
            prompt = rng.integers(0, MID["vocab_size"], size=40)
            ctl = _greedy(w, prompt, 20, R.fp8_mm)
            widest = max(widest, float(R.served_gaps(
                MID, w, prompt, 40, ctl, "cpu").max()))
        ref = _greedy(w, prompt, 6, R.plain_mm)
        own = float(R.served_gaps(MID, w, prompt, 40, ref, "cpu").max())
        out.append((seed, widest, own))
    return out


@pytest.mark.parametrize("cell", ["stablelm-3b.chat", "stablelm-3b.docqa"])
def test_fp8_control_fails_the_cell_limit(cell, readings):
    limit = json.loads((ROOT / "checks" / f"{cell}.json").read_text())[
        "widest_gap"]["limit"]
    for seed, widest, own in readings:
        assert own == 0.0
        assert widest > limit, (seed, widest, limit)

"""The plain reference against the port at reduced sizes on the CPU: the
same weights give the same logits as the port's forward pass, prefill and
decode through the paged cache give what the reference reads at each
position, and the control's lower precision moves the logits."""

import json

import numpy as np
import pytest
import torch

from perfbench.harness import ROOT
from perfbench.reference import dense as R
from perfbench.tests.cells import small_spec

SPEC = json.loads((ROOT / "configs" / "stablelm-3b.json").read_text())


def _setup(seed=3):
    from repro_torch.configs import get_config
    cfg = get_config("stablelm-3b").reduced()
    spec = small_spec(SPEC, cfg)
    return cfg, spec, R.make_weights(spec, seed, torch.device("cpu"))


def test_weights_repeat_from_seed_and_fit_the_port():
    cfg, spec, w = _setup(5)
    _, _, w2 = _setup(5)
    _, _, w3 = _setup(6)
    flat = lambda p: torch.cat([p["embed"]["table"].flatten()] + [  # noqa
        t.flatten() for lay in p["layers"] for blk in lay.values()
        for t in blk.values()])
    assert torch.equal(flat(w), flat(w2))
    assert not torch.equal(flat(w), flat(w3))
    from repro_torch.models import get_model
    gen = torch.Generator().manual_seed(0)
    port = get_model(cfg).init(gen, "cpu")
    for lay_w, lay_p in zip(w["layers"], port["layers"]):
        for blk in lay_p:
            for k, t in lay_p[blk].items():
                assert lay_w[blk][k].shape == t.shape
                assert lay_w[blk][k].dtype == t.dtype


@pytest.mark.parametrize("S", [1, 7, 40])
def test_reference_logits_match_the_port_forward(S):
    cfg, spec, w = _setup()
    from repro_torch.models import transformer as TF
    toks = torch.as_tensor(
        np.random.default_rng(S).integers(0, cfg.vocab, size=S))
    with torch.no_grad():
        port = TF.forward(cfg, w, toks[None].to(torch.int32))[0]
        ref = R.logits(spec, w, toks, torch.arange(S), block=16)
    torch.testing.assert_close(ref, port.float(), atol=2e-5, rtol=2e-5)


def test_served_gaps_are_zero_for_the_reference_own_argmax():
    cfg, spec, w = _setup()
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, size=9)
    plen = 12                          # padded at the end with id 0
    served = []
    seq = list(prompt) + [0] * (plen - len(prompt))
    for _ in range(6):                 # greedy decode through the reference
        t = torch.as_tensor(seq)
        lg = R.logits(spec, w, t, torch.tensor([len(seq) - 1]))
        served.append(int(lg.argmax()))
        seq.append(served[-1])
    g = R.served_gaps(spec, w, prompt, plen, served, "cpu")
    assert g.shape == (6,)
    assert float(g.max()) == 0.0
    wrong = [(t + 1) % cfg.vocab for t in served]
    assert float(R.served_gaps(spec, w, prompt, plen, wrong, "cpu").max()) \
        > 0.0


def test_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.randn(64, 128, generator=torch.Generator().manual_seed(0))
    q = R._fp8(x, -1)
    rel = ((q - x).abs() / x.abs().clamp(min=1e-3)).median()
    assert 0.005 < float(rel) < 0.07
    w = torch.randn(128, 32, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(R.fp8_mm(x, w), R.plain_mm(x, w))

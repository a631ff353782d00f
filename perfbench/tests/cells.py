"""Reduced cells for the CPU tests: the stablelm config cut to the port's
smoke size, and each mix cut to a handful of rows and short prompts, with
the same generator, driver and checks as the real cells."""

import time
from pathlib import Path

from perfbench import harness

CHECKOUT = Path(__file__).resolve().parents[2]


def small_spec(spec, cfg):
    s = dict(spec)
    s.update(hidden_size=cfg.d_model, intermediate_size=cfg.d_ff,
             num_hidden_layers=cfg.n_layers,
             num_attention_heads=cfg.n_heads,
             num_key_value_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
             vocab_size=cfg.vocab, torch_dtype=cfg.dtype)
    return s


def small_traffic(traffic, chunk=12, rate=0.3):
    tr = dict(traffic)
    tr.update(rows=4, max_len=128, prompt_buckets=[8, 16, 32],
              prompt_weights=[0.4, 0.3, 0.3],
              tenants=[{"name": "t0", "share": 0.5, "rows": 4},
                       {"name": "t1", "share": 0.3, "rows": 2},
                       {"name": "t2", "share": 0.2, "rows": 1}],
              output={"dist": "lognormal", "median": 8, "sigma": 0.6,
                      "min": 4, "max": 24},
              chunk_requests=chunk, check={"requests": 4})
    tr["arrivals"] = dict(tr["arrivals"], rate_per_drain=rate)
    return tr


def small_context(cell="stablelm-3b.chat", seed=2**31 + 7, seconds=0.0,
                  **kw):
    from repro_torch.configs import get_config
    cfg = get_config("stablelm-3b").reduced()
    bench = harness.benchmark()
    ctx = harness.context(bench, cell, seed=seed, seconds=seconds,
                          trace=False, device="cpu", t0=time.perf_counter(),
                          port_cfg=cfg)
    ctx.spec = small_spec(ctx.spec, cfg)
    ctx.traffic = small_traffic(ctx.traffic, **kw)
    return bench, ctx

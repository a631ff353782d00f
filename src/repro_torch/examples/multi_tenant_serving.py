"""Multi-tenant LM serving with Guardian isolation, on the port.

Three tenants share one model server and one slab KV pool.  The engine
carves pow2 slot partitions per tenant; every batched decode step fences
each row's slot ids with its tenant's (base, mask).  The demo shows:

1. normal co-located serving (round-robin batching across tenants),
2. that a tenant's generations are bit-identical whether or not other
   tenants are co-located (no cross-tenant interference),
3. a forged-slot attack bouncing off the fence.

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving
    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving \\
        --device cpu

``--full`` serves stablelm-3b at its published widths and depth (the
reference example's reduced config otherwise), random weights from
``seed`` 0.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import ServeEngine


def main(argv: Optional[Sequence[str]] = None,
         params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Runs the demo and returns what it checked.  ``params`` injects the
    weights every engine serves (e.g. the reference's, converted); else
    each engine draws them from seed 0, as the reference's do."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the model at its published size, not reduced")
    args = ap.parse_args(argv)
    cfg = get_config("stablelm-3b")
    if not args.full:
        cfg = cfg.reduced()
    dev = torch.device(args.device)

    def engine():
        return ServeEngine(cfg, max_batch=8, max_len=128, device=dev,
                           params=params)

    rng = np.random.default_rng(7)
    prompts = {f"tenant{i}": rng.integers(0, cfg.vocab, 12).astype(
        np.int32) for i in range(3)}

    print("=== co-located serving (3 tenants, shared pool) ===")
    eng = engine()
    params = eng.params            # the solo and attack engines share them
    parts = {}
    for t in prompts:
        parts[t] = eng.register_tenant(t, 2)
        print(f"  {t}: slots [{parts[t].base}, {parts[t].end})  "
              f"mask={parts[t].mask:#x}")
    rids = {t: eng.submit(t, p) for t, p in prompts.items()}
    out = eng.run(max_new_tokens=10)
    for t, rid in rids.items():
        print(f"  {t}: {out[rid]}")

    print("\n=== isolation: tenant0 alone vs co-located ===")
    solo = engine()
    solo.register_tenant("tenant0", 2)
    rid = solo.submit("tenant0", prompts["tenant0"])
    solo_out = solo.run(max_new_tokens=10)[rid]
    same = solo_out == out[rids["tenant0"]]
    print(f"  identical generations: {same}")
    assert same

    print("\n=== forged slot id bounces off the fence ===")
    eng2 = engine()
    vp = eng2.register_tenant("victim", 4)
    eng2.register_tenant("attacker", 4)
    eng2.submit("victim", prompts["tenant0"])
    eng2.run(max_new_tokens=4)
    before = eng2.cache.k[:, vp.base:vp.end].clone()
    ra = eng2.submit("attacker", prompts["tenant1"])
    req = [r for r in eng2._requests if r.rid == ra][0]
    req.slot = vp.base      # scheduler compromise!
    eng2.run(max_new_tokens=4)
    after = eng2.cache.k[:, vp.base:vp.end]
    changed = bool((before != after).any())
    print(f"  victim KV rows changed: {changed} "
          "(fence wrapped the attack into the attacker's partition)")
    assert not changed
    print("\nall good.")
    return {"generations": {t: out[r] for t, r in rids.items()},
            "solo_identical": same, "victim_changed": changed}


if __name__ == "__main__":
    main()

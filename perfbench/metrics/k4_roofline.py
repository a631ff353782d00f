"""K4 (causal prefill attention): the least time its calls in the traced
chunk could take, over their profiler time.  Each call (one layer of a
prefill drain) counts the causal operations of the joiners' real prompt
lengths against the bf16 peak, and q, k, v read once and the output
written once."""

from perfbench.yardstick import BYTES, bound_s, k4_call, roofline_share

KERNEL = "flash_attention"


def read(rec):
    if rec.trace is None:
        return None
    spec = rec.spec
    calls = rec.trace.calls(KERNEL)
    act = BYTES[spec["torch_dtype"]]
    bound = measured = 0.0
    for d in rec.drains:
        got = calls.get(d.traced) if d.traced >= 0 else None
        if not got or not d.joiners:
            continue
        n_bytes, flops = k4_call(spec, d.joiners, act)
        bound += len(got) * bound_s(n_bytes, flops, spec["torch_dtype"])
        measured += sum(got)
    return roofline_share(bound, measured)

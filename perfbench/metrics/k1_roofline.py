"""K1 (paged decode attention): the least time its calls in the traced
chunk could take, over their profiler time.  Each call (one layer of a
decode drain) reads the held K and V of the decoding rows at their real
lengths once, their q, and writes their output: counted here from the
timeline, never from the program."""

from perfbench.yardstick import BYTES, bound_s, k1_call, roofline_share

KERNEL = "paged_attention"


def read(rec):
    if rec.trace is None:
        return None
    spec = rec.spec
    calls = rec.trace.calls(KERNEL)
    kv = BYTES[rec.traffic["kv_dtype"]]
    act = BYTES[spec["torch_dtype"]]
    bound = measured = 0.0
    for d in rec.drains:
        got = calls.get(d.traced) if d.traced >= 0 else None
        if not got or not d.kv_lens:
            continue
        n_bytes, flops = k1_call(spec, d.kv_lens, kv, act)
        bound += len(got) * bound_s(n_bytes, flops)
        measured += sum(got)
    return roofline_share(bound, measured)

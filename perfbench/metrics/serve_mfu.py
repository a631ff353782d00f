"""Model operations of the window's useful tokens over the window, over
the bf16 peak: every real prompt token through the layers with causal
attention over the prompt, every generated token fed back through the
layers with attention over its real context, and the head once per
generated token.  Counted here from the timeline."""

from perfbench.yardstick import PEAK_FLOPS, decode_token_flops, \
    head_flops, prompt_flops


def read(rec):
    if rec.window_s <= 0:
        return None
    spec = rec.spec
    flops = 0
    for x in rec.reqs:
        n = len(x.tokens)
        if not n:
            continue
        flops += prompt_flops(spec, x.prompt_len) + head_flops(spec)
        flops += sum(decode_token_flops(spec, x.prompt_len + k)
                     for k in range(1, n))
    return 100.0 * flops / rec.window_s / PEAK_FLOPS[spec["torch_dtype"]]

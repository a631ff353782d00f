"""The benchmark's own arithmetic: published peaks, roofline bounds, the
operations and bytes of the serving kernels and of a dense decoder's
token, and the statistics every metric is reduced with.

Nothing here reads the program: every count is worked out from shapes and
lengths the harness knows (its own traffic and its own timeline), so a
change to the program cannot change what it is measured against.
"""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence

#: NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "float8": 1}


def bound_s(n_bytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time the chip could take for this work: the larger of
    its operations over the peak rate and its bytes over the bandwidth."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile of every sample, linearly interpolated
    between the two nearest ranks (numpy's default), or None for none."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile over the median, as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


# --------------------------------------------------------------------- #
# A dense decoder's work (the stablelm family)                          #
# --------------------------------------------------------------------- #

def layer_params(spec: dict) -> int:
    """Weights of one decoder layer: q, k, v, o and the gated MLP (norms
    left out: they do no matrix work)."""
    d, h, kh, hd, f = (spec["hidden_size"], spec["num_attention_heads"],
                       spec["num_key_value_heads"], spec["head_dim"],
                       spec["intermediate_size"])
    return d * h * hd + 2 * d * kh * hd + h * hd * d + 3 * d * f


def token_matmul_flops(spec: dict) -> int:
    """Matrix operations of one token through every layer."""
    return 2 * spec["num_hidden_layers"] * layer_params(spec)


def head_flops(spec: dict) -> int:
    """Operations of one token's logits (the LM head)."""
    return 2 * spec["hidden_size"] * spec["vocab_size"]


def attention_flops(spec: dict, context: int) -> int:
    """Operations of one query over ``context`` keys in every layer: the
    scores and the weighted sum, 2 x heads x head_dim each per key."""
    return (4 * spec["num_hidden_layers"] * spec["num_attention_heads"]
            * spec["head_dim"] * context)


def prompt_flops(spec: dict, p: int) -> int:
    """A prompt of ``p`` real tokens: every token through the layers and
    causal attention over the tokens before it and itself."""
    causal = p * (p + 1) // 2
    return p * token_matmul_flops(spec) + (
        4 * spec["num_hidden_layers"] * spec["num_attention_heads"]
        * spec["head_dim"] * causal)


def decode_token_flops(spec: dict, context: int) -> int:
    """One generated token fed back: the layers, attention over
    ``context`` tokens, and the head."""
    return (token_matmul_flops(spec) + attention_flops(spec, context)
            + head_flops(spec))


# --------------------------------------------------------------------- #
# Kernel rooflines                                                      #
# --------------------------------------------------------------------- #

def k1_call(spec: dict, kv_lens: Iterable[int], kv_bytes: int,
            act_bytes: int = 2):
    """(bytes, flops) of one decode-attention call (one layer) over the
    rows with these held lengths: each held K and V element read once, q
    read and the output written once per row."""
    kh, h, hd = (spec["num_key_value_heads"], spec["num_attention_heads"],
                 spec["head_dim"])
    lens = list(kv_lens)
    held = sum(lens)
    n_bytes = 2 * held * kh * hd * kv_bytes + 2 * len(lens) * h * hd \
        * act_bytes
    flops = 4 * h * hd * held
    return n_bytes, flops


def k4_call(spec: dict, prompt_lens: Iterable[int], act_bytes: int = 2):
    """(bytes, flops) of one causal prefill-attention call (one layer)
    over prompts of these real lengths: q, k, v read once and the output
    written once; causal scores and weighted sums."""
    h, kh, hd = (spec["num_attention_heads"], spec["num_key_value_heads"],
                 spec["head_dim"])
    n_bytes = flops = 0
    for p in prompt_lens:
        n_bytes += p * (2 * h + 2 * kh) * hd * act_bytes
        flops += 2 * h * hd * p * (p + 1)
    return n_bytes, flops


# --------------------------------------------------------------------- #
# The paged pool                                                        #
# --------------------------------------------------------------------- #

#: tokens a page of the port's paged pool holds
PAGE_TOKENS = 64


def kv_pages(rec):
    """(pages written, pages reserved, pages in the pool, bytes a page) of
    the window's fullest drain.  Written: each row in use holds its padded
    prompt and the tokens it has fed back so far, in whole pages.
    Reserved: a row takes a request's every page when it joins.  The pool
    is two pages for each of them, for the power of two above the rows, as
    the engine sizes it."""
    spec, tr = rec.spec, rec.traffic
    per_req = max(tr["max_len"] // PAGE_TOKENS, 1)
    page = (PAGE_TOKENS * 2 * spec["num_hidden_layers"]
            * spec["num_key_value_heads"] * spec["head_dim"]
            * BYTES[tr["kv_dtype"]])
    held = reserved = 0
    for d in rec.drains:
        lens = [d.plen] * len(d.joiners) + list(d.kv_lens)
        held = max(held, sum(-(-n // PAGE_TOKENS) for n in lens))
        reserved = max(reserved, len(lens) * per_req)
    pool = 2 * (1 << max(tr["rows"] - 1, 0).bit_length()) * per_req
    return held, reserved, pool, page


def roofline_share(bound_total_s: float, measured_s: float
                   ) -> Optional[float]:
    """Percent of the roofline reached, or None when nothing ran."""
    if measured_s <= 0 or bound_total_s <= 0:
        return None
    return 100.0 * bound_total_s / measured_s


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None

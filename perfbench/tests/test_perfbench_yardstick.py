"""The benchmark's arithmetic against hand sums: percentiles over every
sample, the kernels' operations and bytes, the model's operations, and
the reduction of a device trace."""

import json
import statistics

import numpy as np
import pytest

from perfbench import trace as TR
from perfbench import yardstick as Y
from perfbench.harness import ROOT, DrainRecord, Record, ReqRecord

SPEC = json.loads((ROOT / "configs" / "stablelm-3b.json").read_text())


@pytest.mark.parametrize("n", [1, 2, 19, 20, 101, 1000])
def test_percentile_matches_numpy(n):
    xs = list(np.random.default_rng(n).lognormal(size=n))
    for q in (50, 95, 99):
        assert Y.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert Y.percentile([], 95) is None


def test_spread_is_quartiles_over_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert Y.spread(xs) == pytest.approx((q3 - q1) / med)


def test_stablelm_counts_by_hand():
    d, f, L, v = 2560, 6912, 32, 50304
    per_layer = 4 * d * d + 3 * d * f
    assert Y.layer_params(SPEC) == per_layer
    assert Y.token_matmul_flops(SPEC) == 2 * L * per_layer
    assert Y.head_flops(SPEC) == 2 * d * v
    # 32 heads x 80 = 2560
    assert Y.attention_flops(SPEC, 10) == 4 * L * 2560 * 10
    p = 5
    assert Y.prompt_flops(SPEC, p) == p * 2 * L * per_layer \
        + 4 * L * 2560 * (1 + 2 + 3 + 4 + 5)
    assert Y.decode_token_flops(SPEC, 7) == 2 * L * per_layer \
        + 4 * L * 2560 * 7 + 2 * d * v


def test_k1_k4_bytes_and_flops_by_hand():
    # two rows holding 100 and 300 tokens, f32 K/V, bf16 q and output
    b, fl = Y.k1_call(SPEC, [100, 300], kv_bytes=4, act_bytes=2)
    assert b == 2 * 400 * 32 * 80 * 4 + 2 * 2 * 32 * 80 * 2
    assert fl == 4 * 32 * 80 * 400
    b, fl = Y.k4_call(SPEC, [3, 4], act_bytes=2)
    assert b == (3 + 4) * 4 * 32 * 80 * 2
    assert fl == 2 * 32 * 80 * (3 * 4 + 4 * 5)
    # a long prompt is bound by operations, a decode call by bytes
    b, fl = Y.k4_call(SPEC, [3584])
    assert fl / Y.PEAK_FLOPS["bfloat16"] > b / Y.HBM_BYTES_PER_S
    b, fl = Y.k1_call(SPEC, [500] * 32, kv_bytes=4)
    assert Y.bound_s(b, fl) == pytest.approx(b / Y.HBM_BYTES_PER_S)
    assert Y.roofline_share(1.0, 4.0) == 25.0
    assert Y.roofline_share(1.0, 0.0) is None


class Ev:
    """A stand-in for the profiler's event."""

    def __init__(self, kind, name, s, e, corr=0, linked=0):
        self.k, self.n, self.s, self.e = kind, name, s, e
        self.c, self.l = corr, linked

    def device_type(self):
        return "DeviceType.CUDA" if self.k in ("kernel", "gpu_memcpy") \
            else "DeviceType.CPU"

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def correlation_id(self):
        return self.c

    def linked_correlation_id(self):
        return self.l


# one traced span over [0, 1000) ns with two drains
HOST = {"driver": [(0, 1000)], "dispatch": [(100, 200), (500, 600)]}


def _events():
    return [
        Ev("cpu_op", "aten::copy_", 105, 108),
        Ev("cuda_runtime", "cudaGraphLaunch", 110, 120, corr=1),
        Ev("cuda_runtime", "cudaLaunchKernel", 510, 520, corr=2),
        Ev("kernel", "paged_attention_kernel", 150, 250, corr=1),
        Ev("kernel", "gemm", 250, 400, corr=1),
        Ev("gpu_memcpy", "Memcpy HtoD", 505, 520, corr=2),
        Ev("kernel", "paged_attention_kernel", 550, 650, linked=2),
    ]


def test_trace_reduction_by_hand():
    r = TR.reduce_events(_events(), HOST)
    assert r.window_s == pytest.approx(1000e-9)
    assert r.busy_s == pytest.approx((250 + 15 + 100) * 1e-9)
    assert r.drains == 2
    assert [op.drain for op in r.ops] == [0, 0, 1, 1]
    assert r.drain_busy_s == pytest.approx([250e-9, 115e-9])
    assert r.calls("paged_attention") == {0: pytest.approx([100e-9]),
                                          1: pytest.approx([100e-9])}
    # each idle gap is named by the innermost host range open as it began
    assert [(n, round(t * 1e9)) for n, t in r.gaps] == [
        ("driver", 350), ("driver", 150), ("driver", 105),
        ("dispatch", 30)]
    assert r.top_ops(1)[0][0] == "paged_attention_kernel"


def test_trace_without_device_ops_reads_nothing():
    evs = [e for e in _events() if e.k not in ("kernel", "gpu_memcpy")]
    assert TR.reduce_events(evs, HOST) is None


def _record():
    spec = dict(SPEC)
    tr = {"rows": 4, "kv_dtype": "float32"}
    rec = Record(spec=spec, traffic=tr, window_s=2.0)
    # request A joins drain 0 (prompt 10, padded 12), 3 tokens;
    # request B joins drain 0 (prompt 12), 2 tokens; C joins drain 2
    rec.reqs = [
        ReqRecord(0, "t0", 10, 3, 0, join=0, plen=12, tokens=[1, 2, 3],
                  due_ms=0.0, token_ms=[5.0, 7.0, 10.0]),
        ReqRecord(0, "t1", 12, 2, 0, join=0, plen=12, tokens=[4, 5],
                  due_ms=0.0, token_ms=[5.0, 7.0]),
        ReqRecord(0, "t0", 4, 1, 1, join=2, plen=4, tokens=[6],
                  due_ms=7.0, token_ms=[10.0]),
    ]
    rec.drains = [
        DrainRecord(0, 0, 5.0, 0.001, [10, 12], 12, [], traced=0),
        DrainRecord(0, 1, 7.0, 0.002, [], 0, [13, 13], traced=1),
        DrainRecord(0, 2, 10.0, 0.003, [4], 4, [14], traced=2),
    ]
    return rec


def test_metric_readers_by_hand():
    from perfbench.harness import read_metric
    rec = _record()
    assert read_metric("output_tokens_per_s", rec) == 6 / 2.0
    assert read_metric("ttft_p95_ms", rec) == pytest.approx(
        np.percentile([5.0, 5.0, 3.0], 95))
    assert read_metric("itl_p95_ms", rec) == pytest.approx(
        np.percentile([2.0, 3.0, 2.0], 95))
    assert read_metric("row_occupancy", rec) == pytest.approx(
        100 * (2 / 4 + 2 / 4) / 2)
    assert read_metric("prefill_pad_share", rec) == pytest.approx(
        100 * 2 / (12 * 2 + 4))
    assert read_metric("dispatch_ms", rec) == pytest.approx(2.0)
    flops = (Y.prompt_flops(SPEC, 10) + Y.head_flops(SPEC)
             + Y.decode_token_flops(SPEC, 11)
             + Y.decode_token_flops(SPEC, 12)
             + Y.prompt_flops(SPEC, 12) + Y.head_flops(SPEC)
             + Y.decode_token_flops(SPEC, 13)
             + Y.prompt_flops(SPEC, 4) + Y.head_flops(SPEC))
    assert read_metric("serve_mfu", rec) == pytest.approx(
        100 * flops / 2.0 / 989e12)
    # no trace: the trace's readers read nothing
    for name in ("k1_roofline", "k4_roofline", "decode_device_ms",
                 "prefill_device_us_per_token", "device_idle_share"):
        assert read_metric(name, rec) is None


def test_trace_readers_by_hand():
    from perfbench.harness import read_metric
    rec = _record()
    ops = [TR.DeviceOp("flash_attention_bf16_kernel", 0, 1000, 0),
           TR.DeviceOp("paged_attention_kernel", 2000, 2500, 1),
           TR.DeviceOp("paged_attention_kernel", 3000, 3100, 2)]
    rec.trace = TR.Reduced(window_s=1e-5, busy_s=4e-6, drains=3, ops=ops,
                           drain_busy_s=[3e-6, 1e-6, 2e-6], gaps=[])
    k1 = (Y.bound_s(*Y.k1_call(SPEC, [13, 13], 4))
          + Y.bound_s(*Y.k1_call(SPEC, [14], 4))) / 600e-9
    assert read_metric("k1_roofline", rec) == pytest.approx(100 * k1)
    k4 = Y.bound_s(*Y.k4_call(SPEC, [10, 12])) / 1000e-9
    assert read_metric("k4_roofline", rec) == pytest.approx(100 * k4)
    assert read_metric("decode_device_ms", rec) == pytest.approx(1e-3)
    # drain 0: prefill only; drain 2: prefill and decode, less the median
    per_tok = (3e-6 + (2e-6 - 1e-6)) / (12 * 2 + 4)
    assert read_metric("prefill_device_us_per_token", rec) == \
        pytest.approx(1e6 * per_tok)
    assert read_metric("device_idle_share", rec) == pytest.approx(60.0)


def test_kv_pages_by_hand():
    rec = _record()
    rec.traffic = dict(rec.traffic, max_len=256)
    held, reserved, pool, page = Y.kv_pages(rec)
    # drain 0 holds two rows of 12, drain 2 one of 4 and one of 14: a page
    # a row; two rows in use at most, four pages a request; pool 2 x 4 x 4
    assert (held, reserved, pool) == (2, 8, 32)
    assert page == 64 * 2 * 32 * 32 * 80 * 4
    rec.drains[1].kv_lens = [64, 65]
    assert Y.kv_pages(rec)[0] == 3


@pytest.mark.parametrize("n,copies,rank", [(64, (2, 3, 4, 5), 60),
                                           (32, (3, 4, 5), 30)])
def test_p95_over_repeated_chunks_holds_one_request(n, copies, rank):
    # the window repeats one chunk of n requests; from these counts on, a
    # chunk more or less leaves the 95th percentile on the same request
    xs = list(np.random.default_rng(n).lognormal(size=n))
    got = {Y.percentile(xs * c, 95) for c in copies}
    assert got == {sorted(xs)[rank]}

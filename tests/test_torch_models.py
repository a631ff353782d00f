"""The port's dense model (reduced stablelm-3b) against the JAX reference on
weights converted from the reference's ``api.init``: prefill logits and 8
greedy decode steps, the pool bytes they write, the weight converter, and
the windowed-attention path the kernels do not cover yet."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import TOL_MODEL, assert_close, assert_same, np_of, \
    params_np, t_of  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.fence import FenceParams as FPJ, FencePolicy as PJ, \
    magic_row  # noqa: E402
from repro.models import get_model as get_model_j  # noqa: E402
from repro.models import kvcache as KVJ, layers as LJ  # noqa: E402
from repro.models.guard import GuardSpec as GSJ  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.core.fence import FenceParams as FPT, \
    FencePolicy as PT  # noqa: E402
from repro_torch.models import get_model as get_model_t  # noqa: E402
from repro_torch.models import kvcache as KVT, layers as LT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.guard import GuardSpec as GST  # noqa: E402

CFG_J = get_config("stablelm-3b").reduced()
CFG_T = get_config_t("stablelm-3b").reduced()


@pytest.fixture(scope="module")
def weights():
    params = get_model_j(CFG_J).init(jax.random.PRNGKey(0))
    return params, params_from_jax(params_np(params), device="cpu")


def _guards(policy, mixed=False):
    """Two serving rows in two tenants' virtual extents ([4, 8) and
    [8, 12)) over a 16-page pool, vocab fenced at 256; the mixed variant
    fences row 1 MODULO beside row 0 BITWISE."""
    base, size = np.array([4, 8], np.int32), np.array([4, 4], np.int32)
    magic = np.array([magic_row(4)] * 2, np.uint32).view(np.int32)
    pmap = np.zeros((16,), np.int32)
    pmap[4:8] = [1, 2, 3, 4]
    pmap[8:12] = [5, 6, 7, 8]
    cols = (base, size, magic[:, 0], magic[:, 1])
    rp = np.array([1, 2], np.int32) if mixed else None
    gj = GSJ(policy=PJ(policy), vocab=FPJ(0, 256),
             kv=FPJ(*(jnp.asarray(c) for c in cols)), page=FPJ(0, 16),
             row_policy=None if rp is None else jnp.asarray(rp),
             page_map=jnp.asarray(pmap))
    gt = GST(policy=PT(policy), vocab=FPT(0, 256),
             kv=FPT(*(t_of(c) for c in cols)), page=FPT(0, 16),
             row_policy=None if rp is None else t_of(rp),
             page_map=t_of(pmap))
    return gj, gt


@pytest.mark.parametrize("policy,mixed", [("bitwise", False),
                                          ("modulo", False),
                                          ("bitwise", True)])
def test_prefill_and_decode_match_reference(weights, policy, mixed):
    """Prefill logits and 8 decode steps within 1e-4, greedy ids equal,
    and the pool equal at every written page but the garbage page 0.  Row
    0's page table is forged with the other tenant's virtual id: the
    fence wraps it back into its own extent in both frameworks."""
    pj, pt = weights
    api_j, api_t = get_model_j(CFG_J), get_model_t(CFG_T)
    B, max_len, P = 2, 128, 16
    table = np.array([[4, 9], [8, 9]], np.int32)     # row 0: forged id 9
    cj = dataclasses.replace(KVJ.init_global_kv_cache(CFG_J, B, max_len, P),
                             page_table=jnp.asarray(table))
    ct = dataclasses.replace(
        KVT.init_global_kv_cache(CFG_T, B, max_len, P, device="cpu"),
        page_table=t_of(table))
    gj, gt = _guards(policy, mixed)
    toks = np.random.default_rng(1).integers(0, CFG_J.vocab, size=(B, 7))
    cj, lj = api_j.prefill(pj, cj, {"tokens": jnp.asarray(toks, jnp.int32)},
                           guard=gj)
    ct, lt = api_t.prefill(pt, ct, {"tokens": t_of(toks.astype(np.int32))},
                           guard=gt)
    assert_close(lt, lj, TOL_MODEL)
    nj, nt = jnp.argmax(lj, -1).astype(jnp.int32), lt.argmax(-1).int()
    for _ in range(8):
        assert_same(nt, nj)
        cj, lj = api_j.decode(pj, cj, nj, guard=gj)
        ct, lt = api_t.decode(pt, ct, nt, guard=gt)
        assert_close(lt, lj, TOL_MODEL)
        nj, nt = jnp.argmax(lj, -1).astype(jnp.int32), lt.argmax(-1).int()
    assert_same(nt, nj)
    assert_same(ct.seq_lens, cj.seq_lens)
    assert_close(ct.k[:, 1:], np_of(cj.k)[:, 1:], TOL_MODEL)
    assert_close(ct.v[:, 1:], np_of(cj.v)[:, 1:], TOL_MODEL)
    # only the two tenants' physical pages (and the garbage page) hold KV
    assert not np_of(ct.k)[:, 9:].any()


def test_params_from_jax_keeps_every_weight_bit(weights):
    """Stacked reference layers map onto per-layer dicts, values equal;
    bfloat16 weights are reinterpreted bit for bit."""
    pj, pt = weights
    assert len(pt["layers"]) == CFG_J.n_layers
    for l in range(CFG_J.n_layers):
        for group, sub in pj["layers"].items():
            for name, arr in sub.items():
                assert_same(pt["layers"][l][group][name], np.asarray(arr)[l])
    assert_same(pt["embed"]["table"], pj["embed"]["table"])
    cfg16 = dataclasses.replace(CFG_J, dtype="bfloat16")
    p16 = get_model_j(cfg16).init(jax.random.PRNGKey(1))
    t16 = params_from_jax(params_np(p16), device="cpu")
    head = t16["embed"]["head"]
    assert head.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        head.view(torch.int16).numpy(),
        np.asarray(p16["embed"]["head"]).view(np.int16))


@pytest.mark.parametrize("window", [3, 8])
def test_windowed_attention_cpu_path_matches_reference(window):
    """A sliding window has no kernel yet: the port's CPU path (chunked
    prefill attention, gathered decode attention) matches the reference's
    layers; on the card it raises instead (see ``prefill_attention``)."""
    rng = np.random.default_rng(window)
    q = rng.normal(size=(2, 11, 4, 16))
    k = rng.normal(size=(2, 11, 2, 16))
    v = rng.normal(size=(2, 11, 2, 16))
    want = LJ.chunked_attention(*(jnp.asarray(a, jnp.float32)
                                  for a in (q, k, v)), causal=True,
                                window=window, q_chunk=4, kv_chunk=4)
    got = LT.chunked_attention(*(t_of(a, torch.float32) for a in (q, k, v)),
                               causal=True, window=window, q_chunk=4)
    assert_close(got, want, 1e-5)
    lens = np.array([5, 11], np.int32)
    want = LJ.decode_attention(jnp.asarray(q[:, :1], jnp.float32),
                               jnp.asarray(k, jnp.float32),
                               jnp.asarray(v, jnp.float32),
                               jnp.asarray(lens), window=window)
    got = LT.decode_attention(t_of(q[:, :1], torch.float32),
                              t_of(k, torch.float32),
                              t_of(v, torch.float32), t_of(lens),
                              window=window)
    assert_close(got, want, 1e-5)
    cfg_w = dataclasses.replace(CFG_T, attn_window=window)
    got = LT.prefill_attention(cfg_w, *(t_of(a, torch.float32)
                                        for a in (q, k, v)))
    assert_close(got, LJ.chunked_attention(
        *(jnp.asarray(a, jnp.float32) for a in (q, k, v)), causal=True,
        window=window), 1e-5)

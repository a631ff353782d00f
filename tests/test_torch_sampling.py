"""Sampled decode in the port against the reference: the Threefry-2x32
block (bit for bit with JAX's), ``split`` equal to ``jax.random.split``,
the draw's uniforms bit-equal to ``jax.random.uniform``'s and its Gumbel
noise within 2 ulp of ``jax.random.gumbel``'s (with a known-answer
vector), ``sample`` drawing ``jax.random.categorical``'s tokens behind
the reference's jitted step, and the port's sampled ``serve_continuous``
drawing the reference's tokens (dense and MoE, compiled and eager).
Besides: determinism per seed, the step's name, greedy pinned at
``temperature=0``, compiled = eager, the distribution of the draw
against ``softmax(logits / T)`` and against ``jax.random.categorical``'s
by chi-square tests over 20,000 draws each, ``top_k`` never drawing
outside the top k (ties at the k-th kept), and the slab lockstep path
failing as the reference's does.  Mirrors tests/test_continuous.py's
sampling cases."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
stats = pytest.importorskip("scipy.stats")

from _torch_parity import params_np  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch import serve as SJ  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.launch import sampling as SA  # noqa: E402
from repro_torch.launch import serve as ST  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

CFG_J = get_config("stablelm-3b").reduced()
CFG_T = get_config_t("stablelm-3b").reduced()
N_DRAWS = 20_000
P_MIN = 1e-3
TINY = np.finfo(np.float32).tiny

#: the first 16 uniforms and Gumbel values (float32 bits) of key
#: ``PRNGKey(2024)`` at shape (2, 8), as ``jax.random.uniform(key, shape,
#: minval=tiny)`` and ``jax.random.gumbel(key, shape)`` give them;
#: chip_smoke.py holds the card's draw against the same words
KNOWN_KEY_SEED, KNOWN_SHAPE = 2024, (2, 8)
KNOWN_UNIFORM_BITS = (
    0x3d8f50b0, 0x3decf180, 0x3f5930a4, 0x3e30a378, 0x3f66fbee, 0x3f203300,
    0x3e306798, 0x3d9401b0, 0x3f30b7b2, 0x3f3ef54c, 0x3d285280, 0x3f6a63ea,
    0x3ecf7550, 0x3f2424a0, 0x3cb3da00, 0x3f0191c6)
KNOWN_GUMBEL_BITS = (
    0xbf7a690d, 0xbf44c496, 0x3fe7181a, 0xbf105643, 0x4011948e, 0x3f41f664,
    0xbf1087a8, 0xbf774a7e, 0x3f7e18c3, 0x3f9d13ae, 0xbf948eee, 0x401b68ac,
    0x3dd0118e, 0x3f4f99eb, 0xbfab82df, 0x3ec4bc86)


def _f32(words):
    return np.asarray(words, np.uint32).view(np.float32)


def _ulps(a, b):
    """|a - b| in float32 ulps of the larger of |a|, |b| and 1: near
    ``G = 0`` the outer log's argument sits near 1, whose ulp bounds what
    a last-ulp ``log`` can move."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.float32(1))
    return np.abs(a.astype(np.float64) - b) / np.spacing(scale)


def test_threefry_block_matches_jax():
    """The block is JAX's ``threefry_2x32`` bit for bit, on host ints and
    on int64 tensors alike."""
    from jax._src import prng
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 32, (16, 2), dtype=np.uint64)
    ctr = rng.integers(0, 2 ** 32, (16, 2), dtype=np.uint64)
    for k, c in zip(keys, ctr):
        want = np.asarray(prng.threefry_2x32(
            jnp.asarray(k, jnp.uint32), jnp.asarray(c, jnp.uint32)))
        host = SA.threefry2x32(int(k[0]), int(k[1]), int(c[0]), int(c[1]))
        kt = torch.tensor(k.astype(np.int64))
        dev = SA.threefry2x32(kt[0], kt[1], torch.tensor(int(c[0])),
                              torch.tensor(int(c[1])))
        assert list(host) == [int(w) for w in want] == [int(w) for w in dev]


def test_keys_split_on_the_host():
    """``key`` holds ``PRNGKey``'s words; ``split`` is deterministic and
    its two keys differ from each other and from their parent."""
    assert SA.key(0x5EED) == tuple(int(w) for w in np.asarray(
        jax.random.PRNGKey(0x5EED)))
    k = SA.key(7)
    a, b = SA.split(k)
    assert (a, b) == SA.split(k) and len({k, a, b}) == 3
    g = SA.gumbel(SA.key_tensor(b, "cpu"), (3, 5))
    assert torch.equal(g, SA.gumbel(SA.key_tensor(b, "cpu"), (3, 5)))
    assert not torch.equal(g, SA.gumbel(SA.key_tensor(a, "cpu"), (3, 5)))


@pytest.mark.parametrize("seed", [0, 7, 0x5EED, 2 ** 40 + 3, -5])
def test_split_matches_jax(seed):
    """``key`` is ``jax.random.PRNGKey`` (with 64-bit types off, a seed
    past 32 bits or below 0 keeps its low word) and ``split`` is
    ``jax.random.split`` (the partitionable split of the sandbox's JAX),
    three generations deep."""
    kj, kt = jax.random.PRNGKey(seed), SA.key(seed)
    assert kt == tuple(int(w) for w in np.asarray(kj))
    for _ in range(3):
        kj, sub_j = jax.random.split(kj)
        kt, sub_t = SA.split(kt)
        assert (kt, sub_t) == (tuple(int(w) for w in np.asarray(kj)),
                               tuple(int(w) for w in np.asarray(sub_j)))


@pytest.mark.parametrize("seed,shape", [(0, (3, 5)), (7, (8, 50304)),
                                        (123, (2, 151936))])
def test_draw_is_the_reference_stream(seed, shape):
    """The uniforms are ``jax.random.uniform(key, shape, minval=tiny)``
    bit for bit and the Gumbel noise is within 2 ulp of
    ``jax.random.gumbel(key, shape)``."""
    kj = jax.random.PRNGKey(seed)
    kt = SA.key_tensor(SA.key(seed), "cpu")
    want_u = np.asarray(jax.random.uniform(kj, shape, minval=TINY))
    np.testing.assert_array_equal(SA.uniform(kt, shape).numpy(), want_u)
    want_g = np.asarray(jax.random.gumbel(kj, shape))
    assert _ulps(SA.gumbel(kt, shape).numpy(), want_g).max() <= 2


def test_known_answer_vector():
    """The first 16 uniforms and Gumbel values of one fixed key: the
    recorded words are JAX's, and the port's draw gives the uniforms
    exactly and the Gumbel values within 2 ulp (chip_smoke.py holds the
    card to the same words)."""
    kj = jax.random.PRNGKey(KNOWN_KEY_SEED)
    u = np.asarray(jax.random.uniform(kj, KNOWN_SHAPE, minval=TINY))
    g = np.asarray(jax.random.gumbel(kj, KNOWN_SHAPE))
    assert tuple(int(w) for w in u.ravel().view(np.uint32)) \
        == KNOWN_UNIFORM_BITS
    assert tuple(int(w) for w in g.ravel().view(np.uint32)) \
        == KNOWN_GUMBEL_BITS
    kt = SA.key_tensor(SA.key(KNOWN_KEY_SEED), "cpu")
    np.testing.assert_array_equal(
        SA.uniform(kt, KNOWN_SHAPE).numpy().ravel(),
        _f32(KNOWN_UNIFORM_BITS))
    assert _ulps(SA.gumbel(kt, KNOWN_SHAPE).numpy().ravel(),
                 _f32(KNOWN_GUMBEL_BITS)).max() <= 2


@functools.partial(jax.jit, static_argnums=(2, 3))
def _reference_tail(logits, key, temperature, top_k):
    """The reference's sampled decode step after its logits
    (repro/launch/steps.py), jitted as the step is."""
    logits = logits.astype(jnp.float32)
    if top_k:
        kth = jax.lax.top_k(logits, top_k)[0][..., -1:]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    nxt = jax.random.categorical(key, logits / temperature, axis=-1)
    return nxt.astype(jnp.int32)


@pytest.mark.parametrize("top_k", [0, 4])
@pytest.mark.parametrize("vocab", [CFG_J.vocab, 151_936])
def test_sample_draws_the_reference_tokens(vocab, top_k):
    """``sample`` draws the tokens of the reference's jitted sampled step
    for 20 keys x 8 rows at the reduced stablelm-3b's vocab and at
    151,936 columns (qwen's)."""
    rng = np.random.default_rng(vocab + top_k)
    for seed in range(20):
        logits = (rng.standard_normal((8, vocab)) * 3).astype(np.float32)
        _, sub = SA.split(SA.key(seed))
        want = np.asarray(_reference_tail(
            jnp.asarray(logits), jnp.asarray(sub, jnp.uint32), 0.7, top_k))
        got = SA.sample(torch.from_numpy(logits),
                        SA.key_tensor(sub, "cpu"), 0.7, top_k)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(seed))


LOGITS = np.array([2.0, 1.0, 0.5, 0.5, 0.0, -0.5, -1.0, -3.0], np.float32)


def _port_draws(logits, temperature, top_k=0):
    rows = torch.from_numpy(np.tile(logits, (N_DRAWS, 1)))
    ids = SA.sample(rows, SA.key_tensor(SA.key(1234), "cpu"), temperature,
                    top_k)
    return np.bincount(ids.numpy(), minlength=len(logits))


def _jax_draws(logits, temperature, top_k=0):
    lg = jnp.asarray(logits)
    if top_k:
        kth = jax.lax.top_k(lg, top_k)[0][..., -1:]
        lg = jnp.where(lg < kth, -jnp.inf, lg)
    ids = jax.random.categorical(jax.random.PRNGKey(99), lg / temperature,
                                 shape=(N_DRAWS,))
    return np.bincount(np.asarray(ids), minlength=len(logits))


def _softmax(logits, temperature, keep):
    z = np.where(keep, logits.astype(np.float64) / temperature, -np.inf)
    p = np.exp(z - z.max())
    return p / p.sum()


@pytest.mark.parametrize("temperature,top_k", [(0.7, 0), (1.3, 0),
                                               (0.7, 3)])
def test_draws_follow_the_reference_distribution(temperature, top_k):
    """20,000 draws at fixed logits: their frequencies pass a chi-square
    test against ``softmax(logits / T)`` (over the kept logits) and a
    chi-square homogeneity test against 20,000 draws of
    ``jax.random.categorical`` at p > 1e-3.  ``top_k=3`` keeps the two
    logits tied at the third largest (0.5), so four ids, and never draws
    another."""
    keep = np.ones_like(LOGITS, bool)
    if top_k:
        keep = LOGITS >= np.sort(LOGITS)[::-1][top_k - 1]
        assert keep.sum() == 4
    port = _port_draws(LOGITS, temperature, top_k)
    ref = _jax_draws(LOGITS, temperature, top_k)
    assert port.sum() == N_DRAWS and (port[~keep] == 0).all()
    assert (ref[~keep] == 0).all()
    want = _softmax(LOGITS, temperature, keep)[keep]
    want = want / want.sum() * port[keep].sum()
    assert stats.chisquare(port[keep], want).pvalue > P_MIN
    table = np.stack([port[keep], ref[keep]])
    assert stats.chi2_contingency(table).pvalue > P_MIN


def _sampled_run(seed, temperature=0.7, top_k=4, jit=True, params=None):
    mgr = ST.make_shared_manager(1, max_batch=2, paged=True, max_len=64,
                                 device="cpu", jit_trusted=jit)
    eng = ST.ServeEngine(CFG_T, max_batch=2, max_len=64, seed=seed,
                         manager=mgr, paged=True, temperature=temperature,
                         top_k=top_k, device="cpu", params=params)
    eng.register_tenant("t", 2)
    rid = eng.submit("t", [5, 9, 2, 7, 1], max_new=6)
    return eng, eng.run(max_new_tokens=6)[rid]


def test_sampled_decode_deterministic_per_key():
    eng1, toks1 = _sampled_run(0)
    eng2, toks2 = _sampled_run(0)
    assert toks1 == toks2            # same seed -> same key stream
    assert "sampled" in eng1._steps.decode_name
    _, toks3 = _sampled_run(1)       # other weights and key: completes
    assert len(toks3) == 6


def test_sampled_step_name_is_the_reference_s():
    mgr = SJ.make_shared_manager(1, max_batch=2, paged=True, max_len=64)
    ref = SJ.ServeEngine(CFG_J, max_batch=2, max_len=64, manager=mgr,
                         paged=True, temperature=0.7, top_k=4)
    eng, _ = _sampled_run(0)
    assert eng._steps.decode_name == ref._steps.decode_name
    assert eng._steps.decode_name.endswith(":t0.7:k4]")


def test_sampled_tokens_compiled_equal_eager():
    _, compiled = _sampled_run(3, jit=True)
    _, eager = _sampled_run(3, jit=False)
    assert compiled == eager


def test_sampled_tokens_stay_in_the_top_k():
    """With ``top_k=1`` every draw is the greedy token: the sampled run
    equals the greedy one on the same weights."""
    eng, greedy = _sampled_run(0, temperature=0.0, top_k=0)
    _, top1 = _sampled_run(0, temperature=0.9, top_k=1, params=eng.params)
    assert top1 == greedy


def test_greedy_default_pinned():
    """``temperature=0`` keeps the argmax step under the unsuffixed name,
    with no key, and its tokens are the reference's on its weights."""
    mgr = SJ.make_shared_manager(1, max_batch=2, paged=True, max_len=64)
    ref = SJ.ServeEngine(CFG_J, max_batch=2, max_len=64, seed=0,
                         manager=mgr, paged=True)
    ref.register_tenant("t", 2)
    rid = ref.submit("t", [5, 9, 2, 7, 1], max_new=5)
    want = ref.run(max_new_tokens=5)[rid]
    eng, got = _sampled_run(0, temperature=0.0, top_k=0, params=(
        params_from_jax(params_np(ref.params), device="cpu")))
    assert "sampled" not in eng._steps.decode_name
    assert eng._sample_key is None
    assert got[:5] == want


@pytest.mark.parametrize("batch,error", [(8, ValueError), (2, IndexError)])
def test_slab_lockstep_sampled_fails_as_the_reference(batch, error):
    """The reference's lockstep launch hands the sampled step its tokens
    alone (no key), so a sampled slab engine fails on its first decode:
    unpacking eight ids into (tokens, key), or indexing two.  The port
    fails the same way."""
    for SV, cfg, kw in ((SJ, CFG_J, {}), (ST, CFG_T, {"device": "cpu"})):
        eng = SV.ServeEngine(cfg, max_batch=batch, max_len=64, seed=0,
                             temperature=0.7, top_k=4, **kw)
        eng.register_tenant("t", 2)
        eng.submit("t", [1, 2, 3], max_new=4)
        with pytest.raises(error):
            eng.run(max_new_tokens=4)


# ---------------------------------------------------------------------------
# Sampled serving draws the reference's tokens
# ---------------------------------------------------------------------------

SAMPLED_PROMPTS = [[(5 * i + 3 * j) % 199 + 1 for j in range(3 + i % 4)]
                   for i in range(4)]


def _sampled_trace(SV, eng):
    for t in range(2):
        eng.register_tenant(f"t{t}", 1)
    rids = [eng.submit(f"t{i % 2}", p, max_new=3 + i % 2, arrive=i // 2)
            for i, p in enumerate(SAMPLED_PROMPTS)]
    out = SV.serve_continuous([eng], max_new_tokens=4)[0]
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def sampled_ref():
    """The reference's sampled ``serve_continuous`` run per arch:
    ``(weights, tokens)``, computed on first use."""
    runs = {}

    def run(arch):
        if arch not in runs:
            cfg = get_config(arch).reduced()
            mgr = SJ.make_shared_manager(1, max_batch=2, max_len=64,
                                         paged=True)
            eng = SJ.ServeEngine(cfg, max_batch=2, max_len=64, seed=3,
                                 manager=mgr, paged=True, temperature=0.7,
                                 top_k=4)
            runs[arch] = (params_np(eng.params), _sampled_trace(SJ, eng))
        return runs[arch]

    return run


@pytest.mark.parametrize("jit", [True, False], ids=["compiled", "eager"])
@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen3-moe-30b-a3b"])
def test_sampled_serve_continuous_draws_the_reference_tokens(arch, jit,
                                                             sampled_ref):
    """``ServeEngine(temperature=0.7, top_k=4)`` through
    ``serve_continuous`` on the reference's weights, 2 tenants, 4
    requests arriving over 2 cycles: the port draws the reference's
    tokens, request for request."""
    params, want = sampled_ref(arch)
    mgr = ST.make_shared_manager(1, max_batch=2, max_len=64, paged=True,
                                 device="cpu", jit_trusted=jit)
    eng = ST.ServeEngine(get_config_t(arch).reduced(), max_batch=2,
                         max_len=64, seed=3, manager=mgr, paged=True,
                         temperature=0.7, top_k=4, device="cpu",
                         params=params_from_jax(params, device="cpu"))
    got = _sampled_trace(ST, eng)
    assert [len(t) for t in got] == [3, 4, 3, 4]
    assert got == want

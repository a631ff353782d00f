"""Sampled decode in the port against the reference: the Threefry-2x32
block (bit for bit with JAX's), determinism per seed, the step's name,
greedy pinned at ``temperature=0``, compiled = eager, the distribution of
the draw against ``softmax(logits / T)`` and against
``jax.random.categorical``'s by chi-square tests over 20,000 draws each,
``top_k`` never drawing outside the top k (ties at the k-th kept), and
the slab lockstep path failing as the reference's does.  Mirrors
tests/test_continuous.py's sampling cases."""

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

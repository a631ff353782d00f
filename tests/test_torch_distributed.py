"""The port's ``distributed`` package and meshes against the JAX
reference: int8 gradient compression (codes and scales bit for bit, the
error bound, error feedback), ``tree_compress_psum`` over a one-rank gloo
process group against the reference's under ``shard_map`` on a one-device
mesh, the sharding rules for every mesh's axis names, ``pp_cut_points``
and ``describe``.  Mirrors tests/test_substrate.py's compression tests."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from _hyp import given, settings, st  # noqa: E402
from _torch_parity import assert_same, np_of, t_of  # noqa: E402
from repro.distributed import compress as CJ  # noqa: E402
from repro.distributed import sharding as SJ  # noqa: E402
from repro_torch.distributed import compress as CT  # noqa: E402
from repro_torch.distributed import sharding as ST  # noqa: E402
from repro_torch.launch import mesh as MT  # noqa: E402


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo process group (an in-process store: no network)."""
    mine = not dist.is_initialized()
    if mine:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield dist.group.WORLD
    if mine:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# int8 compression (tests/test_substrate.py mirrors)
# ---------------------------------------------------------------------------

def _error_bound(n, scale):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(n,)) * scale).astype(np.float32)
    q, s, size = CT.quantize_int8(t_of(x))
    y = CT.dequantize_int8(q, s, size, (n,), torch.float32)
    assert float((t_of(x) - y).abs().max()) <= \
        float(np.abs(x).max()) / 127.0 + 1e-6


@given(st.integers(min_value=1, max_value=2000),
       st.floats(min_value=0.01, max_value=100.0))
@settings(max_examples=25, deadline=None)
def test_int8_quantization_error_bound(n, scale):
    _error_bound(n, scale)


@pytest.mark.parametrize("n,scale", [(1, 0.01), (7, 1.0), (255, 31.4),
                                     (2000, 100.0)])
def test_int8_quantization_error_bound_sweep(n, scale):
    _error_bound(n, scale)


def test_error_feedback_converges():
    """With error feedback the running compressed sum tracks the true sum
    (the drift is exactly the final residual), and every step's
    approximation and residual equal the reference's."""
    rng = np.random.default_rng(0)
    err_t, err_j = torch.zeros(256), jnp.zeros(256)
    true_acc, comp_acc = np.zeros(256), np.zeros(256)
    for _ in range(50):
        g = rng.normal(size=256).astype(np.float32)
        approx, err_t = CT.compress_roundtrip(t_of(g) + err_t)
        approx_j, err_j = CJ.compress_roundtrip(jnp.asarray(g) + err_j)
        assert_same(approx, approx_j)
        assert_same(err_t, err_j)
        true_acc += g
        comp_acc += np_of(approx)
    np.testing.assert_allclose(comp_acc + np_of(err_t), true_acc, atol=1e-3)


@pytest.mark.parametrize("shape", [(1,), (255,), (256,), (3, 300),
                                   (2, 7, 129)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codes_and_scales_bit_equal(shape, dtype):
    """Codes, scales and the round trip equal the reference's bit for bit
    — ties at .5 included (a block whose max is 127 has scale 1, so 2.5
    and -1.5 are ties: round half to even, as ``jnp.round``) and an
    all-zero block (scale 1)."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    ties = np.array([127.0, 2.5, -1.5, 0.5], np.float32)
    x.reshape(-1)[:4] = ties[:min(4, x.size)]
    if x.size >= 512:
        x.reshape(-1)[256:512] = 0.0
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = t_of(x, getattr(torch, dtype))
    qj, sj, nj = CJ.quantize_int8(xj)
    qt, st_, nt = CT.quantize_int8(xt)
    assert nt == nj
    assert qt.dtype == torch.int8 and st_.dtype == torch.float32
    assert_same(qt, qj)
    assert_same(st_, sj)
    aj, rj = CJ.compress_roundtrip(xj)
    at, rt = CT.compress_roundtrip(xt)
    assert at.dtype == xt.dtype and rt.dtype == xt.dtype
    assert_same(at, aj)
    assert_same(rt, rj)


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(300,)).astype(np.float32),
            "b": {"w": (rng.normal(size=(4, 70)) * 5).astype(np.float32),
                  "z": np.zeros((3,), np.float32)}}


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return t_of(tree)


def test_tree_compress_psum_one_rank(group):
    """Three error-feedback steps over a one-rank gloo group against the
    reference's under ``shard_map`` on a one-device mesh: the means and
    the residuals bit for bit, and each mean equal to the per-leaf round
    trip."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:1]), ("pod",))
    fn = shard_map(lambda g, e: CJ.tree_compress_psum(g, e, "pod"),
                   mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                   check_rep=False)
    grads = _grads(0)
    err_j = CJ.init_error_feedback(jax.tree.map(jnp.asarray, grads))
    err_t = CT.init_error_feedback(_tree_t(grads))
    for step in range(3):
        grads = _grads(step)
        red_j, err_j = fn(jax.tree.map(jnp.asarray, grads), err_j)
        red_t, err_t = CT.tree_compress_psum(_tree_t(grads), err_t, group)
        for path in (("a",), ("b", "w"), ("b", "z")):
            pick = lambda t: t[path[0]] if len(path) == 1 \
                else t[path[0]][path[1]]  # noqa: E731
            assert_same(pick(red_t), pick(red_j))
            assert_same(pick(err_t), pick(err_j))
    # one rank: the mean is the round trip of g + err, leaf by leaf
    g = _tree_t(_grads(7))
    e = CT.init_error_feedback(g)
    red, _ = CT.tree_compress_psum(g, e, group)
    assert_same(red["b"]["w"], CT.compress_roundtrip(g["b"]["w"])[0])


def test_tree_compress_psum_sends_int8(group, monkeypatch):
    """What crosses the group is the int8 codes and the float32 scales."""
    sent = []
    real = dist.all_gather

    def spy(parts, t, group=None, **kw):
        sent.append(t.dtype)
        return real(parts, t, group=group, **kw)

    monkeypatch.setattr(dist, "all_gather", spy)
    g = _tree_t(_grads(1))
    CT.tree_compress_psum(g, CT.init_error_feedback(g), group)
    assert sent == [torch.int8, torch.float32] * 3


# ---------------------------------------------------------------------------
# Sharding rules, pp_cut_points, meshes
# ---------------------------------------------------------------------------

AXIS_NAMES = [("data", "model"), ("pod", "data", "model")]


@pytest.mark.parametrize("names", AXIS_NAMES)
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("seq_parallel", [True, False])
def test_make_rules_matches_reference(names, fsdp, seq_parallel):
    """The same rule tuple, in the same order (the reference's reads only
    ``mesh.axis_names``), and the same lookups and specs."""
    stand_in = types.SimpleNamespace(axis_names=names)
    mesh = MT.Mesh(axis_names=names, shape={n: 1 for n in names})
    rj = SJ.make_rules(stand_in, fsdp=fsdp, seq_parallel=seq_parallel)
    rt = ST.make_rules(mesh, fsdp=fsdp, seq_parallel=seq_parallel)
    assert rt.rules == rj.rules
    logical = [k for k, _ in rj.rules] + ["unknown"]
    for name in logical:
        assert rt.lookup(name) == rj.lookup(name)
    axes = ("batch", None, "embed", "heads", "unknown")
    assert rt.spec(axes) == tuple(rj.spec(axes))
    assert rt.sharding(mesh, axes).spec == rt.spec(axes)
    assert rt.sharding(mesh, axes).mesh is mesh


def test_make_rules_for_the_port_meshes():
    for mesh, names in ((MT.make_local_mesh("cpu"), AXIS_NAMES[0]),
                        (MT.make_production_mesh(), AXIS_NAMES[0]),
                        (MT.make_production_mesh(multi_pod=True),
                         AXIS_NAMES[1])):
        assert mesh.axis_names == names
        assert ST.make_rules(mesh).rules == SJ.make_rules(
            types.SimpleNamespace(axis_names=names)).rules


def test_logical_sharding_and_constrain():
    from jax.sharding import Mesh
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    mesh = MT.make_local_mesh("cpu")
    tree = {"w": ("embed", "ffn"), "b": [("ffn",), (None, "vocab")],
            "s": ()}
    rj = SJ.make_rules(jmesh)
    rt = ST.make_rules(mesh)
    got = ST.logical_sharding(mesh, rt, tree)
    want = SJ.logical_sharding(jmesh, rj, tree)
    assert got["w"].spec == tuple(want["w"].spec)
    for i in range(2):
        assert got["b"][i].spec == tuple(want["b"][i].spec)
    x = torch.arange(6.0).reshape(2, 3)
    assert ST.constrain(x, rt, ("batch", None)) is x


@pytest.mark.parametrize("n_layers", [1, 2, 7, 24, 32, 81, 126])
@pytest.mark.parametrize("n_stages", [1, 2, 3, 4, 8])
def test_pp_cut_points_matches_reference(n_layers, n_stages):
    cuts = ST.pp_cut_points(n_layers, n_stages)
    assert cuts == SJ.pp_cut_points(n_layers, n_stages)
    assert len(cuts) == n_stages - 1
    assert list(cuts) == sorted(cuts)


def test_meshes_and_describe():
    from repro.launch import mesh as MJ
    local = MT.make_local_mesh("cpu")
    assert MT.describe(local) == MJ.describe(MJ.make_local_mesh())
    assert local.size == 1 and local.devices == (torch.device("cpu"),)
    assert MT.make_local_mesh().devices == (torch.device("cuda"),)
    for multi in (False, True):
        mesh = MT.make_production_mesh(multi_pod=multi)
        shape = (2, 16, 16) if multi else (16, 16)
        stand_in = types.SimpleNamespace(axis_names=mesh.axis_names,
                                         devices=np.empty(shape))
        assert MT.describe(mesh) == MJ.describe(stand_in)
        assert mesh.devices == () and mesh.size == int(np.prod(shape))
        assert tuple(mesh.shape.values()) == shape

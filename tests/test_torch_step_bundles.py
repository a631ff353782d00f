"""The port's step bundles against the JAX reference's
(``repro/launch/steps.py``):

* every family's ``param_logical_axes`` at full width, equal to the
  reference's split by ``axes_from_jax``, each axes tuple as long as its
  ``meta`` param's rank (meta init: no weights drawn);
* ``batch_specs`` for every family and shape kind, as ``meta`` tensors
  of the reference's shapes and dtypes;
* ``cache_axes`` for every cache type on the one-card mesh and on the
  reference's (16, 16) mesh (read for its shape only);
* on reduced configs and ``make_local_mesh``, every input's and output's
  placement equal to the reference's ``in_shardings[i].spec`` /
  ``out_shardings``;
* the prefill bundle then three decode bundle steps against the
  reference's ``jax.jit(bundle.fn)`` on the reference's weights (carried
  across by ``params_from_jax``): the dense family over f32, bf16 and
  float8 pools, and the MoE, hybrid, xLSTM, vision and encoder-decoder
  families over f32 pools — logits within ``TOL_MODEL`` (the
  encoder-decoder's within the reference's own 3e-4, over a bf16 pool
  within ``TOL_BF16``), integer cache fields
  exact, a float8 pool byte for byte, a bf16 one within one bf16 ulp
  (``TOL_F32`` near zero);
* ``build_step`` on a train shape: one step's loss and parameters equal
  to ``build_train_step``'s.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from _torch_parity import TOL_BF16, TOL_F32, TOL_MODEL, assert_close, assert_same, np_of, \
    params_np, t_of  # noqa: E402
from repro.configs import SHAPES, ShapeConfig as ShapeJ, \
    get_config  # noqa: E402
from repro.launch import mesh as MJ, steps as STJ  # noqa: E402
from repro.models import get_model as get_model_j  # noqa: E402
from repro_torch.configs import ShapeConfig, \
    get_config as get_config_t  # noqa: E402
from repro_torch.core.stepgraph import tree_flatten  # noqa: E402
from repro_torch.distributed.sharding import is_axes  # noqa: E402
from repro_torch.launch import mesh as MT, steps as STT  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import axes_from_jax, \
    params_from_jax  # noqa: E402

#: one architecture per family
FAMILIES = {"dense": "stablelm-3b", "moe": "qwen3-moe-30b-a3b",
            "hybrid": "zamba2-7b", "ssm": "xlstm-350m",
            "vlm": "qwen2-vl-2b", "encdec": "seamless-m4t-medium"}
KINDS = ("train", "prefill", "decode")
TORCH_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "int32": torch.int32, "float8_e4m3fn": torch.float8_e4m3fn}


def _leaves_with_paths(tree, path=()):
    """(path, leaf) pairs of a nested dict / list / dataclass tree whose
    leaves are axes tuples or tensors."""
    if is_axes(tree) or isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in
                _leaves_with_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in
                _leaves_with_paths(v, path + (i,))]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in
                _leaves_with_paths(getattr(tree, f.name), path + (f.name,))]
    raise TypeError(type(tree))


def _as_dict(tree):
    """A cache tree (either side's dataclasses) as nested dicts, its
    leaves as they are."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _as_dict(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _as_dict(v) for k, v in tree.items()}
    return tree


def _specs(tree):
    """The reference's NamedShardings -> their specs as tuples."""
    return jax.tree.map(lambda s: tuple(s.spec), tree,
                        is_leaf=lambda x: isinstance(x, NamedSharding))


# ---------------------------------------------------------------------------
# Logical axes, batch specs, cache axes (shape only, full width)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_logical_axes_match_reference(family):
    name = FAMILIES[family]
    api_j, api_t = get_model_j(get_config(name)), \
        get_model(get_config_t(name))
    params_j = jax.eval_shape(api_j.init, jax.random.PRNGKey(0))
    want = axes_from_jax(api_j.param_logical_axes(), params_j)
    got = api_t.param_logical_axes()
    assert got == want
    meta = STT.params_spec(api_t)
    axes = _leaves_with_paths(got)
    leaves = _leaves_with_paths(meta)
    assert [p for p, _ in axes] == [p for p, _ in leaves]
    for (path, ax), (_, t) in zip(axes, leaves):
        assert t.device.type == "meta"
        assert len(ax) == t.dim(), path


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batch_specs_match_reference(family, kind):
    name = FAMILIES[family]
    shape = next(s for s in SHAPES.values() if s.kind == kind)
    want = get_model_j(get_config(name)).batch_specs(shape)
    got = get_model(get_config_t(name)).batch_specs(
        ShapeConfig(shape.name, shape.kind, shape.seq_len,
                    shape.global_batch))
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert got[k].dtype == TORCH_DT[np.dtype(spec.dtype).name], k


MESHES = {"local": ((1, 1), ("data", "model")),
          "pod": ((16, 16), ("data", "model"))}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cache_axes_match_reference(family, mesh_name):
    """Every cache type (slab KV, state, hybrid, encoder-decoder) at the
    reference's decode shape; qwen3-moe's 4 KV heads do not divide the
    pod mesh's model axis, so its pool falls back to the head dim."""
    name = FAMILIES[family]
    dims, names = MESHES[mesh_name]
    cfg_j, cfg_t = get_config(name), get_config_t(name)
    shape = SHAPES["decode_32k"]
    stand_in = types.SimpleNamespace(shape=dict(zip(names, dims)))
    mesh = MT.Mesh(axis_names=names, shape=dict(zip(names, dims)))
    c_j = STJ._cache_shape_for(get_model_j(cfg_j), cfg_j, shape)
    c_t = STT._cache_shape_for(get_model(cfg_t), cfg_t, ShapeConfig(
        shape.name, shape.kind, shape.seq_len, shape.global_batch))
    assert type(c_t).__name__ == type(c_j).__name__
    got = STT.cache_axes(mesh, cfg_t, c_t)
    assert _as_dict(got) == _as_dict(STJ.cache_axes(stand_in, cfg_j, c_j))
    # every cache leaf has its axes, as long as its rank
    for (pa, ax), (pt, t) in zip(_leaves_with_paths(got),
                                 _leaves_with_paths(c_t)):
        assert pa == pt and len(ax) == t.dim()
        assert t.device.type == "meta"


# ---------------------------------------------------------------------------
# Placements on the one-card mesh (reduced configs)
# ---------------------------------------------------------------------------

def _reduced(family):
    name = FAMILIES[family]
    return get_config(name).reduced(), get_config_t(name).reduced()


def _shapes(kind, S=128, B=4):
    return ShapeJ("t", kind, S, B), ShapeConfig("t", kind, S, B)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_placements_match_reference(family, kind):
    cj, ct = _reduced(family)
    sj, st = _shapes(kind)
    bj = STJ.build_step(cj, sj, MJ.make_local_mesh())
    bt = STT.build_step(ct, st, MT.make_local_mesh("cpu"))
    assert bt.donate_argnums == bj.donate_argnums
    assert bt.rules.rules == bj.rules.rules
    params_j = bj.in_specs[0]
    ins_j = _specs(bj.in_shardings)
    outs_j = _specs(bj.out_shardings)
    assert bt.in_shardings[0] == axes_from_jax(ins_j[0], params_j)
    if kind == "train":
        for k in ("m", "v"):
            assert bt.in_shardings[1][k] == axes_from_jax(ins_j[1][k],
                                                          params_j)
        assert bt.in_shardings[1]["step"] == ins_j[1]["step"] == ()
        assert bt.out_shardings[2] == outs_j[2] == {"loss": ()}
    else:
        assert _as_dict(bt.in_shardings[1]) == _as_dict(ins_j[1])
        assert _as_dict(bt.out_shardings[0]) == _as_dict(outs_j[0])
        assert bt.out_shardings[1] == outs_j[1]
    assert bt.in_shardings[2] == ins_j[2]
    # the specs are meta tensors of the reference's shapes and dtypes
    for i in range(3):
        leaves_t = tree_flatten(bt.in_specs[i])[1]
        assert all(t.device.type == "meta" for t in leaves_t)
    leaves_j = jax.tree.leaves(bj.in_specs[2])
    leaves_t = tree_flatten(bt.in_specs[2])[1]
    assert [tuple(x.shape) for x in leaves_t] == \
        [tuple(x.shape) for x in leaves_j]


# ---------------------------------------------------------------------------
# The bundles run: prefill + 3 decode steps against the reference
# ---------------------------------------------------------------------------

B, S_CACHE, PROMPT, STEPS = 2, 128, 24, 3
RUNS = [("dense", "f32"), ("dense", "bf16"), ("dense", "f8"),
        ("moe", "f32"), ("hybrid", "f32"), ("ssm", "f32"), ("vlm", "f32"),
        ("encdec", "f32")]


def _batch(family, cfg, rng):
    toks = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    if family == "vlm":
        side = 2
        n = side * side
        pos = np.zeros((PROMPT, 3), np.int32)
        i = np.arange(n)
        pos[:n, 1], pos[:n, 2] = i // side, i % side
        pos[n:] = (side + np.arange(PROMPT - n))[:, None]
        patches = rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)
        return {"tokens": toks, "patches": patches,
                "positions": np.broadcast_to(pos, (B, PROMPT, 3)).copy()}
    if family == "encdec":
        from repro_torch.models.api import SRC_FRAMES
        src = rng.normal(size=(B, SRC_FRAMES, cfg.d_model)) \
            .astype(np.float32)
        return {"src": src, "tgt": toks}
    return {"tokens": toks}


def _to_j(batch):
    """Patches in bf16 as the reference's specs say; the encoder's frames
    in the reduced config's float32 (the reference's encoder scan takes
    them in the model's type only)."""
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "patches" else None)
            for k, v in batch.items()}


def _to_t(batch):
    return {k: t_of(v, torch.bfloat16 if k == "patches" else None)
            for k, v in batch.items()}


def _cache_j(api, cfg, shape, kv_dtype):
    abstract = STJ._cache_shape_for(api, cfg, shape, kv_dtype)
    if cfg.family == "ssm":
        cache = api.init_cache(shape.global_batch)
    else:
        cache = api.init_cache(shape.global_batch, shape.seq_len,
                               dtype=STJ._KV_DTYPES[kv_dtype])
    assert jax.tree.map(lambda a: (a.shape, a.dtype), cache) == \
        jax.tree.map(lambda a: (a.shape, a.dtype), abstract)
    return cache


def _cache_t(api, cfg, shape, kv_dtype, spec):
    if cfg.family == "ssm":
        cache = api.init_cache(shape.global_batch, device="cpu")
    else:
        cache = api.init_cache(shape.global_batch, shape.seq_len,
                               dtype=STT._KV_DTYPES[kv_dtype], device="cpu")
    got = [(tuple(t.shape), t.dtype) for t in tree_flatten(cache)[1]]
    assert got == [(tuple(t.shape), t.dtype)
                   for t in tree_flatten(spec)[1]]
    return cache


def _same_cache(ct, cj, tol):
    dt, dj = _as_dict(ct), _as_dict(cj)
    flat_t = _leaves_with_paths(dt)
    flat_j = {p: v for p, v in _flat_j(dj)}
    for path, t in flat_t:
        want = np.asarray(flat_j[path])
        if t.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(np_of(t), want, err_msg=str(path))
        elif t.dtype == torch.float8_e4m3fn:
            # a float8 pool byte for byte, as the fp8 model test holds it
            np.testing.assert_array_equal(
                t.view(torch.uint8).numpy(), want.view(np.uint8),
                err_msg=str(path))
        elif t.dtype == torch.bfloat16:
            # a bf16 pool within one bf16 ulp (or TOL_F32 near zero): its
            # K / V are f32 products rounded once, and the two frameworks'
            # f32 products may fall on either side of a rounding boundary
            np.testing.assert_allclose(
                np_of(t), want.astype(np.float32), rtol=2 ** -7,
                atol=TOL_F32, err_msg=str(path))
        else:
            assert_close(t, want, tol)


def _flat_j(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_j(tree[k],
                                                         path + (k,))]
    return [(path, tree)]


@pytest.mark.parametrize("family,kv_dtype", RUNS)
def test_bundles_prefill_then_decode_match_reference(family, kv_dtype):
    """The prefill bundle's ``fn`` over a 24-token prompt into the
    bundle's own cache (128 tokens a row, 2 rows), then three decode
    bundle steps, under the bundles' guard (BITWISE), on both sides: the
    logits within ``TOL_MODEL`` and every cache field after each call,
    greedy ids equal."""
    cj, ct = _reduced(family)
    rng = np.random.default_rng(RUNS.index((family, kv_dtype)))
    api_j = get_model_j(cj)
    params_j = api_j.init(jax.random.PRNGKey(0))
    params_t = params_from_jax(params_np(params_j), "cpu")
    mesh_j, mesh_t = MJ.make_local_mesh(), MT.make_local_mesh("cpu")
    out = {}
    for kind in ("prefill", "decode"):
        sj, st = _shapes(kind, S_CACHE, B)
        bj = STJ.build_step(cj, sj, mesh_j, kv_dtype=kv_dtype)
        bt = STT.build_step(ct, st, mesh_t, kv_dtype=kv_dtype)
        out[kind] = (jax.jit(bj.fn), bt)
    sj, st = _shapes("prefill", S_CACHE, B)
    api_t = out["prefill"][1].api
    cache_j = _cache_j(api_j, cj, sj, kv_dtype)
    cache_t = _cache_t(api_t, ct, st, kv_dtype, out["prefill"][1].in_specs[1])
    batch = _batch(family, cj, rng)
    # a bf16 pool: the bf16 tolerance of the kernel sweeps (one bf16 ulp
    # of a K / V element moves a logit by ~1e-4)
    tol = {"encdec": 3e-4}.get(family, TOL_BF16 if kv_dtype == "bf16"
                               else TOL_MODEL)
    with torch.no_grad():
        cache_j, lj = out["prefill"][0](params_j, cache_j, _to_j(batch))
        cache_t, lt = out["prefill"][1].fn(params_t, cache_t, _to_t(batch))
        assert_close(lt, lj, tol)
        _same_cache(cache_t, cache_j, tol)
        for _ in range(STEPS):
            nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
            assert_same(torch.argmax(lt, -1).to(torch.int32), nxt)
            cache_j, lj = out["decode"][0](params_j, cache_j,
                                           jnp.asarray(nxt))
            cache_t, lt = out["decode"][1].fn(params_t, cache_t, t_of(nxt))
            assert_close(lt, lj, tol)
            _same_cache(cache_t, cache_j, tol)


def test_build_step_train_is_build_train_step():
    """``build_step`` on a train shape wraps ``build_train_step``: one
    step from the same weights and batch gives the same loss and the same
    parameters, bit for bit."""
    cj, ct = _reduced("dense")
    _, st = _shapes("train", 32, 2)
    params_j = get_model_j(cj).init(jax.random.PRNGKey(0))
    toks = t_of(np.random.default_rng(4).integers(
        0, cj.vocab, (2, 33)).astype(np.int32))
    bundle = STT.build_step(ct, st, MT.make_local_mesh("cpu"),
                            device="cpu")
    plain = STT.build_train_step(ct, st, device="cpu")
    results = []
    for fn, opt in ((bundle.fn, None), (plain.fn, plain.opt)):
        params = params_from_jax(params_np(params_j), "cpu")
        opt_state = (opt or plain.opt).init(params)
        params, opt_state, aux = fn(params, opt_state, {"tokens": toks})
        results.append((aux["loss"], tree_flatten(params)[1],
                        tree_flatten(opt_state)[1]))
    (l1, p1, o1), (l2, p2, o2) = results
    assert_same(l1, l2)
    for a, b in zip(p1 + o1, p2 + o2):
        assert torch.equal(a, b)
    assert bundle.donate_argnums == (0, 1)
    assert [tuple(t.shape) for t in tree_flatten(bundle.in_specs[0])[1]] \
        == [tuple(t.shape) for t in p1]


@pytest.mark.parametrize("kind", ("prefill", "train"))
@pytest.mark.parametrize("mesh_name", ("card", "pod"))
def test_bundle_runs_on_its_mesh_device_only(mesh_name, kind):
    """A bundle's ``fn`` runs only on operands on its mesh's one device:
    CPU operands given to a bundle on the card's mesh, or any operands
    given to one on the shape-only production mesh, raise before the
    step runs."""
    _, ct = _reduced("dense")
    _, st = _shapes(kind, 32, 2)
    mesh = MT.make_local_mesh("cuda") if mesh_name == "card" \
        else MT.make_production_mesh()
    bundle = STT.build_step(ct, st, mesh, device="cpu") if kind == "train" \
        else STT.build_step(ct, st, mesh, kv_dtype="f32")
    params = bundle.api.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((2, 33 if kind == "train" else 8), dtype=torch.int32)
    second = {} if kind == "train" else bundle.api.init_cache(
        2, 32, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="off the mesh's device"
                       if mesh_name == "card" else "a shape only"):
        bundle.fn(params, second, {"tokens": toks})


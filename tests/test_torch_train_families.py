"""Training the recurrent families on the port against the JAX reference,
on the same numpy inputs and converted weights (reduced configs, float32,
the CPU):

* ``models/ssd.py``'s ``ssd_chunked`` and a Mamba2 block
  (``models/mamba2.py`` ``block_apply``) under autograd: every gradient
  against ``jax.grad`` of the reference's, at a length that is not a
  multiple of the chunk, with log decays steep enough that an unmasked
  ``exp`` above the diagonal would overflow;
* zamba2-7b (two groups and a Mamba tail, a window inside the sequence)
  and xlstm-350m through ``get_model(cfg).loss``: the loss within 1e-5 and
  every gradient leaf within atol 1e-5 / rtol 1e-4 under the train guard,
  ``remat`` on equal to off bit for bit;
* ten ``build_train_step`` steps against the reference's jitted step;
* ``python -m repro_torch.launch.train`` against ``repro.launch.train``
  on the reference's weights: the same step lines and summary.
"""

import contextlib
import dataclasses
import io
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import np_of, params_np, t_of  # noqa: E402
from repro.configs import ShapeConfig as ShapeJ, get_config  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.launch.steps import build_train_step as build_j, \
    make_guard as make_guard_j  # noqa: E402
from repro.models import get_model as get_model_j  # noqa: E402
from repro.models import mamba2 as M2J, ssd as SSDJ  # noqa: E402
from repro.optim import adamw as adamw_j, cosine as cosine_j  # noqa: E402
from repro_torch.configs import ShapeConfig, \
    get_config as get_config_t  # noqa: E402
from repro_torch.core.stepgraph import tree_flatten, \
    tree_unflatten  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.launch.steps import build_train_step, \
    make_guard  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import hybrid as HYT  # noqa: E402
from repro_torch.models import mamba2 as M2T, ssd as SSDT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

#: loss and gradient tolerances against the reference (float32)
TOL_LOSS = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4

#: zamba2-7b at 5 layers: two groups of 2 and a 1-layer Mamba tail, its
#: 32-token window inside the 40-token sequences below
ARCHS = {"zamba2-7b": dict(n_layers=5), "xlstm-350m": {}}
SEQ = 40


def _cfgs(arch):
    cj, ct = get_config(arch).reduced(), get_config_t(arch).reduced()
    kw = ARCHS[arch]
    if kw:
        cj, ct = dataclasses.replace(cj, **kw), dataclasses.replace(ct, **kw)
    return cj, ct


def _assert_leaves_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.isfinite(np_of(a)).all()
        np.testing.assert_allclose(np_of(a), np_of(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


# --------------------------------------------------------------------- #
# SSD and the Mamba2 block under autograd                               #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("S,chunk,steep", [(37, 8, False), (16, 16, False),
                                           (21, 8, True)])
def test_ssd_chunked_gradients_match_reference(S, chunk, steep):
    """The gradients of a weighted sum of ``ssd_chunked``'s output and
    final state with respect to u, a, b, c and h0 against ``jax.grad`` of
    the reference's.  ``steep`` log decays (-30 a step) put +e^(30 Q) above
    the diagonal of the decay matrix before its mask: the masked ``exp``
    keeps every gradient finite."""
    rng = np.random.default_rng(S)
    Bs, H, P, N = 2, 3, 4, 5
    u, b, c = (rng.normal(size=sh).astype(np.float32)
               for sh in ((Bs, S, H, P), (Bs, S, H, N), (Bs, S, H, N)))
    scale = 30.0 if steep else 0.2
    a = (-np.abs(rng.normal(size=(Bs, S, H))) * scale).astype(np.float32)
    h0 = (rng.normal(size=(Bs, H, N, P)) * 0.1).astype(np.float32)
    wy = rng.normal(size=(Bs, S, H, P)).astype(np.float32)
    wh = rng.normal(size=(Bs, H, N, P)).astype(np.float32)

    def loss_j(*xs):
        y, h = SSDJ.ssd_chunked(*xs[:4], h0=xs[4], chunk=chunk)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    want = jax.jit(jax.grad(loss_j, argnums=tuple(range(5))))(
        *map(jnp.asarray, (u, a, b, c, h0)))
    xs = [t_of(x).requires_grad_() for x in (u, a, b, c, h0)]
    y, h = SSDT.ssd_chunked(*xs[:4], h0=xs[4], chunk=chunk)
    got = torch.autograd.grad((y * t_of(wy)).sum() + (h * t_of(wh)).sum(),
                              xs)
    _assert_leaves_close(got, want)


def test_mamba2_block_gradients_match_reference():
    """A reduced zamba2 Mamba2 block on the reference's weights, from a
    nonzero SSM state and conv tail over a 21-token sequence (chunk 8):
    the gradients of a weighted sum of its output, final state and conv
    tail with respect to every weight, the input, the state and the tail
    against ``jax.grad`` of the reference's (the causal conv and the gated
    RMSNorm write nothing in place)."""
    cj, ct = get_config("zamba2-7b").reduced(), \
        get_config_t("zamba2-7b").reduced()
    pj = params_np(M2J.block_init(jax.random.PRNGKey(7), cj))
    pt = params_from_jax({"embed": {}, "norm_f": {}, "layers": {
        k: v[None] for k, v in pj.items()}}, device="cpu")["layers"][0]
    rng = np.random.default_rng(9)
    dm = M2J.dims(cj)
    x = rng.normal(size=(2, 21, cj.d_model)).astype(np.float32)
    h0 = (rng.normal(size=(2, dm["heads"], dm["n"], dm["p"])) * 0.1) \
        .astype(np.float32)
    tail = rng.normal(size=(2, cj.ssm.conv_width - 1, dm["conv_dim"])) \
        .astype(np.float32)
    shapes = jax.eval_shape(
        lambda p, x, h, t: M2J.block_apply(cj, p, x, h0=h, conv_tail=t),
        pj, *map(jnp.asarray, (x, h0, tail)))
    ws = [rng.normal(size=o.shape).astype(np.float32) for o in shapes]

    def loss_j(p, x, h0, tail):
        outs = M2J.block_apply(cj, p, x, h0=h0, conv_tail=tail)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws))

    gj = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3)))(
        pj, *map(jnp.asarray, (x, h0, tail)))
    struct, leaves = tree_flatten(pt)
    req = [p.detach().clone().requires_grad_() for p in leaves]
    xs = [t_of(v).requires_grad_() for v in (x, h0, tail)]
    outs = M2T.block_apply(ct, tree_unflatten(struct, req), *xs[:1],
                           h0=xs[1], conv_tail=xs[2])
    got = torch.autograd.grad(
        sum((o * t_of(w)).sum() for o, w in zip(outs, ws)), req + xs)
    want_p = tree_flatten(params_from_jax({"embed": {}, "norm_f": {},
                                           "layers": {
        k: np.asarray(v)[None] for k, v in gj[0].items()}},
        device="cpu")["layers"][0])[1]
    _assert_leaves_close(got, want_p + list(gj[1:]))


# --------------------------------------------------------------------- #
# Both families' losses and gradients                                   #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def models():
    """Per arch: both configs, the reference's seed-0 params, the port's
    converted copy and a (2, SEQ + 1) token batch."""
    out = {}
    for arch in ARCHS:
        cj, ct = _cfgs(arch)
        pj = jax.jit(get_model_j(cj).init)(jax.random.PRNGKey(0))
        toks = np.random.default_rng(1).integers(0, cj.vocab, (2, SEQ + 1)) \
            .astype(np.int32)
        out[arch] = (cj, ct, pj, params_from_jax(params_np(pj), "cpu"),
                     toks)
    return out


def _port_loss_grads(cfg, params, toks, guard, remat):
    struct, leaves = tree_flatten(params)
    req = [p.detach().clone().requires_grad_() for p in leaves]
    loss = get_model(cfg).loss(tree_unflatten(struct, req),
                               {"tokens": t_of(toks)}, guard=guard,
                               remat=remat)
    return loss.detach(), torch.autograd.grad(loss, req)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_grads_match_reference(models, arch):
    """The loss within 1e-5 and every gradient leaf within atol 1e-5 /
    rtol 1e-4 of the reference's under the train guard (zamba2: K4 under
    the window in the shared block, the tail blocks; xLSTM: the sLSTM's
    loop over positions); ``remat`` on gives the same loss and gradients
    bit for bit."""
    cj, ct, pj, pt, toks = models[arch]
    gj = make_guard_j(cj, ShapeJ("t", "train", SEQ, 2))
    gt = make_guard(ct, ShapeConfig("t", "train", SEQ, 2))
    if arch == "zamba2-7b":
        assert HYT.group_structure(ct) == (2, 1) and ct.attn_window < SEQ
    fn = jax.jit(jax.value_and_grad(lambda p, t: get_model_j(cj).loss(
        p, {"tokens": t}, guard=gj, remat=False)))
    loss_j, grads_j = fn(pj, jnp.asarray(toks))
    loss_t, grads_t = _port_loss_grads(ct, pt, toks, gt, remat=False)
    assert abs(float(loss_t) - float(loss_j)) < TOL_LOSS
    _assert_leaves_close(
        grads_t, tree_flatten(params_from_jax(params_np(grads_j),
                                              "cpu"))[1])
    loss_r, grads_r = _port_loss_grads(ct, pt, toks, gt, remat=True)
    assert torch.equal(loss_r, loss_t)
    assert all(torch.equal(a, b) for a, b in zip(grads_r, grads_t))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_step_losses_match_reference(models, arch):
    """Ten steps of ``build_train_step`` (remat on, the guard, AdamW under
    the reference's cosine at peak lr 0.5) on SyntheticLM batches against
    the reference's jitted step from the same weights: every step's loss
    within 1e-4."""
    cj, ct, pj, _, _ = models[arch]
    shape_j, shape_t = ShapeJ("t", "train", 32, 2), \
        ShapeConfig("t", "train", 32, 2)
    step_j = jax.jit(build_j(cj, shape_j, make_local_mesh(),
                             peak_lr=0.5).fn)
    bt = build_train_step(ct, shape_t, peak_lr=0.5, device="cpu")
    assert bt.guard is not None
    params_t = params_from_jax(params_np(pj), "cpu")
    sj = adamw_j(cosine_j(0.5, 2_000, 100_000)).init(pj)
    st = bt.opt.init(params_t)
    data = SyntheticLM(DataConfig(vocab=ct.vocab, seq_len=32,
                                  global_batch=2))
    params_j = pj
    for s in range(10):
        toks = data.batch(s)["tokens"]
        params_j, sj, out_j = step_j(params_j, sj,
                                     {"tokens": jnp.asarray(toks)})
        params_t, st, out_t = bt.fn(params_t, st, {"tokens": t_of(toks)})
        assert abs(float(out_t["loss"]) - float(out_j["loss"])) < 1e-4, s


STEP_LINE = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) \(\d+ ms/step\)$")


def _reference_cli(argv):
    from repro.launch import train as TJ
    old, out = sys.argv, io.StringIO()
    sys.argv = ["train", *argv]
    try:
        with contextlib.redirect_stdout(out):
            summary = TJ.main()
    finally:
        sys.argv = old
    return summary, out.getvalue().splitlines()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cli_prints_the_reference_lines(arch):
    """``repro_torch.launch.train.main`` on the reference CLI's weights
    (its ``--seed 0`` draw, converted) prints the reference's lines: each
    step line's step and loss (within a last printed digit), the same
    watchdog and summary keys, the summary's losses within 1e-4."""
    argv = ["--arch", arch, "--reduced", "--steps", "4", "--batch", "2",
            "--seq", "32", "--log-every", "1"]
    ref, ref_lines = _reference_cli(argv)
    cj = get_config(arch).reduced()
    params = params_from_jax(params_np(jax.jit(get_model_j(cj).init)(
        jax.random.PRNGKey(0))), "cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = T.main(argv + ["--device", "cpu"], params=params)
    lines = out.getvalue().splitlines()
    assert len(lines) == len(ref_lines) == 5
    for got, want in zip(lines[:-1], ref_lines[:-1]):
        mg, mw = STEP_LINE.match(got), STEP_LINE.match(want)
        assert mg and mw and mg.group(1) == mw.group(1), (got, want)
        assert abs(float(mg.group(2)) - float(mw.group(2))) <= 1.5e-4
    assert sorted(summary) == sorted(ref)
    assert summary["steps"] == ref["steps"] == 4
    assert summary["stragglers"] == ref["stragglers"]
    for key in ("first_loss", "final_loss"):
        assert abs(summary[key] - ref[key]) < 1e-4

"""The compiled train step (``launch/steps.py`` ``compile_train_step``, the
port's counterpart of the reference's ``jax.jit`` train step) on the CPU,
where a step graph runs the step on the same staged operands and hands
back the same copies a replay on the card would:

* for every family (the MoE one under both dispatches and both remat
  policies), four compiled steps equal four eager steps bit for bit —
  losses, params, both moments and the step counter;
* one graph for N steps of one batch shape, a second for another length
  while the first keeps serving its own; new params (a restored
  checkpoint's) drop the stale graphs;
* staging: a batch mutated after a call changes no later result, the
  losses handed back are copies, the params and moments handed back are
  the very tensors passed in; a step handing back other tensors is
  refused, on every call;
* ten compiled steps against the reference's jitted step
  (``repro/launch/train.py``) under the CLI's three schedules;
* a stopped and resumed ``python -m repro_torch.launch.train`` run ends on
  the uninterrupted run's params and moments, bit for bit, and the CLI
  hands its compiled step to a caller's ``wrap_step``.

Reduced configs, float32, batch 2 x <= 32 tokens."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import params_np, t_of  # noqa: E402
from repro.configs import ShapeConfig as ShapeJ, \
    get_config as get_config_j  # noqa: E402
from repro.core.fence import FencePolicy as PJ  # noqa: E402
from repro.launch.steps import make_guard as make_guard_j  # noqa: E402
from repro.models import get_model as get_model_j  # noqa: E402
from repro.optim import adamw as adamw_j, apply_updates as apply_j, \
    constant as constant_j, cosine as cosine_j, wsd as wsd_j  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.core.stepgraph import StepCaptureError, \
    tree_flatten  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.launch.steps import TrainStep, build_train_step, \
    compile_train_step  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

#: test_torch_train.py's bound on a train step's loss against the
#: reference's jitted step
TOL_STEP_LOSS = 1e-4
SEQ, BATCH = 32, 2

#: (arch, build_train_step options): every family, the MoE one under both
#: dispatches with remat ``nothing`` and ``dots``
CASES = {
    "minicpm-2b": ("minicpm-2b", {}),
    "qwen3-moe/scatter/nothing": ("qwen3-moe-30b-a3b", dict(
        moe_dispatch="scatter", remat=True, remat_policy="nothing")),
    "qwen3-moe/scatter/dots": ("qwen3-moe-30b-a3b", dict(
        moe_dispatch="scatter", remat=True, remat_policy="dots")),
    "qwen3-moe/einsum/nothing": ("qwen3-moe-30b-a3b", dict(
        moe_dispatch="einsum", remat=True, remat_policy="nothing")),
    "qwen3-moe/einsum/dots": ("qwen3-moe-30b-a3b", dict(
        moe_dispatch="einsum", remat=True, remat_policy="dots")),
    "zamba2-7b": ("zamba2-7b", {}),
    "xlstm-350m": ("xlstm-350m", {}),
    "qwen2-vl-2b": ("qwen2-vl-2b", {}),
    "seamless-m4t-medium": ("seamless-m4t-medium", {}),
}


def _grid(S: int, side: int = 4) -> np.ndarray:
    """qwen2-vl positions (BATCH, S, 3): ``side`` x ``side`` patches, then
    the text one past the grid's largest id."""
    n = side * side
    pos = np.zeros((S, 3), np.int32)
    pos[:n, 1], pos[:n, 2] = np.arange(n) // side, np.arange(n) % side
    pos[n:] = (side + np.arange(S - n))[:, None]
    return np.broadcast_to(pos, (BATCH, S, 3)).copy()


def _batch(cfg, i: int, S: int = SEQ) -> dict:
    """Step ``i``'s train batch of ``cfg``'s family, from a seed."""
    rng = np.random.default_rng(100 + i)
    toks = rng.integers(0, cfg.vocab, (BATCH, S + 1)).astype(np.int32)
    if cfg.family == "vlm":
        return {"tokens": t_of(toks), "patches": t_of(
            (rng.normal(size=(BATCH, 16, cfg.d_model)) * 0.02
             ).astype(np.float32)), "positions": t_of(_grid(S))}
    if cfg.family == "encdec":
        return {"src": t_of(rng.normal(size=(BATCH, 16, cfg.d_model))
                            .astype(np.float32)), "tgt": t_of(toks)}
    return {"tokens": t_of(toks)}


def _step(arch: str, **kw) -> TrainStep:
    cfg = get_config(arch).reduced()
    return build_train_step(cfg, ShapeConfig("t", "train", SEQ, BATCH),
                            peak_lr=0.5, device="cpu", **kw)


def _fresh(step: TrainStep):
    params = step.api.init(torch.Generator().manual_seed(0), "cpu")
    return params, step.opt.init(params)


def _leaves(params, opt_state):
    return tree_flatten((params, opt_state))[1]


@pytest.mark.parametrize("case", list(CASES))
def test_compiled_steps_equal_eager_steps_bit_for_bit(case):
    """Four compiled steps against four eager ones from the same weights:
    every loss, param, moment and the step counter equal bit for bit, the
    four steps in one graph, which hands back the tensors passed in."""
    arch, kw = CASES[case]
    step = _step(arch, **kw)
    compiled = compile_train_step(step)
    pe, se = _fresh(step)
    pc, sc = _fresh(step)
    for i in range(4):
        batch = _batch(step.api.cfg, i)
        pe, se, oe = step.fn(pe, se, batch)
        given = _leaves(pc, {k: v for k, v in sc.items() if k != "step"})
        pc, sc, oc = compiled(pc, sc, batch)
        assert all(a is b for a, b in zip(_leaves(
            pc, {k: v for k, v in sc.items() if k != "step"}), given))
        assert torch.equal(oc["loss"], oe["loss"]), (i, oc, oe)
    assert int(sc["step"]) == 4 and len(compiled.graphs) == 1
    got, want = _leaves(pc, sc), _leaves(pe, se)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_one_graph_per_batch_shape():
    """N steps of one length replay one graph; a batch of another length
    builds a second, and the first still serves its own length after it,
    every step equal to the eager step's."""
    step = _step("minicpm-2b")
    compiled = compile_train_step(step)
    pe, se = _fresh(step)
    pc, sc = _fresh(step)
    cfg = step.api.cfg
    for i, S in enumerate((SEQ, SEQ, SEQ, 16, 16, SEQ)):
        batch = _batch(cfg, i, S)
        pe, se, oe = step.fn(pe, se, batch)
        pc, sc, oc = compiled(pc, sc, batch)
        assert torch.equal(oc["loss"], oe["loss"]), i
        assert len(compiled.graphs) == (1 if i < 3 else 2), i
    assert [g.replays for g in compiled.graphs.values()] == [3, 1]
    assert all(torch.equal(a, b) for a, b in zip(_leaves(pc, sc),
                                                 _leaves(pe, se)))


def test_new_params_drop_the_stale_graphs(tmp_path):
    """A restored checkpoint hands back new tensors: the next call builds
    its graph afresh and keeps no graph over the old params."""
    step = _step("minicpm-2b")
    compiled = compile_train_step(step)
    params, state = _fresh(step)
    cfg = step.api.cfg
    for i in range(2):
        params, state, _ = compiled(params, state, _batch(cfg, i))
    old = next(iter(compiled.graphs.values()))
    store = CheckpointStore(str(tmp_path))
    store.save(2, (params, state))
    (params, state), _ = store.restore((params, state))
    params, state, _ = compiled(params, state, _batch(cfg, 2))
    assert len(compiled.graphs) == 1
    assert next(iter(compiled.graphs.values())) is not old
    assert int(state["step"]) == 3


def test_staged_batch_and_copied_outputs():
    """Each call stages its batch: a batch tensor mutated after the call
    leaves every later step as the eager run's; the losses and counters
    handed back are copies that a later replay does not overwrite."""
    step = _step("minicpm-2b")
    compiled = compile_train_step(step)
    pe, se = _fresh(step)
    pc, sc = _fresh(step)
    cfg = step.api.cfg
    kept, want, counters = [], [], []
    for i in range(4):
        batch = _batch(cfg, i)
        pe, se, oe = step.fn(pe, se, {k: v.clone() for k, v in
                                      batch.items()})
        pc, sc, oc = compiled(pc, sc, batch)
        batch["tokens"].fill_(7)           # after the call: no effect
        kept.append(oc["loss"])
        counters.append(sc["step"])
        want.append(oe["loss"])
    assert all(torch.equal(a, b) for a, b in zip(kept, want))
    assert [int(c) for c in counters] == [1, 2, 3, 4]
    assert all(torch.equal(a, b) for a, b in zip(_leaves(pc, sc),
                                                 _leaves(pe, se)))


def test_a_step_handing_back_other_params_is_refused():
    """A step that does not update its params in place cannot be
    compiled: the call raises :class:`StepCaptureError` naming the step,
    and so does every later call of its key, without running it."""
    base = _step("minicpm-2b")
    calls = []

    def copying_step(params, opt_state, batch):
        calls.append(1)
        params, opt_state, out = base.fn(params, opt_state, batch)
        fresh = {k: t.clone() for k, t in params["embed"].items()}
        return {**params, "embed": fresh}, opt_state, out

    compiled = compile_train_step(dataclasses.replace(base, fn=copying_step))
    params, state = _fresh(base)
    batch = _batch(base.api.cfg, 0)
    for _ in range(2):
        with pytest.raises(StepCaptureError, match="'copying_step'"):
            compiled(params, state, batch)
    assert len(calls) == 1 and not compiled.graphs


# --------------------------------------------------------------------- #
# Against the reference's jitted step, and through the CLI              #
# --------------------------------------------------------------------- #

def _reference_step(cj, schedule: str, steps: int, lr: float):
    """``repro/launch/train.py``'s jitted train step and optimizer, as its
    ``main`` builds them for ``--schedule schedule --steps steps --lr lr``
    (BITWISE guard, remat off)."""
    guard = make_guard_j(cj, ShapeJ("train", "train", SEQ, BATCH),
                         PJ("bitwise"), enabled=True)
    sched = {"cosine": lambda: cosine_j(lr, steps // 10, steps),
             "wsd": lambda: wsd_j(lr, steps // 10, int(steps * 0.7),
                                  steps - steps // 10 - int(steps * 0.7)),
             "constant": lambda: constant_j(lr)}[schedule]()
    opt = adamw_j(sched)
    api = get_model_j(cj)

    @jax.jit
    def train_step(params, opt_state, batch):
        def loss_of(p):
            return api.loss(p, batch, guard=guard, remat=False)
        loss, grads = jax.value_and_grad(loss_of)(params)
        updates, opt_state2 = opt.update(grads, opt_state, params)
        return apply_j(params, updates), opt_state2, loss

    return train_step, opt


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_compiled_steps_match_the_reference_jitted_step(schedule):
    """Ten compiled steps (the CLI's step: its schedule, the BITWISE
    guard, remat off) against the reference's jitted step from the same
    weights on the same SyntheticLM batches: every loss within 1e-4."""
    steps, lr = 10, 3e-3
    cj = get_config_j("minicpm-2b").reduced()
    ref_step, opt_j = _reference_step(cj, schedule, steps, lr)
    pj = get_model_j(cj).init(jax.random.PRNGKey(0))
    sj = opt_j.init(pj)
    args = T.parse_args(["--arch", "minicpm-2b", "--reduced", "--steps",
                         str(steps), "--schedule", schedule, "--lr",
                         str(lr), "--seq", str(SEQ), "--batch",
                         str(BATCH)])
    ct = get_config("minicpm-2b").reduced()
    step = build_train_step(ct, ShapeConfig("train", "train", SEQ, BATCH),
                            remat=False, schedule=T.make_schedule(args),
                            device="cpu")
    compiled = compile_train_step(step)
    pt = params_from_jax(params_np(pj), "cpu")
    st = step.opt.init(pt)
    data = SyntheticLM(DataConfig(vocab=ct.vocab, seq_len=SEQ,
                                  global_batch=BATCH))
    for s in range(steps):
        toks = data.batch(s)["tokens"]
        pj, sj, loss_j = ref_step(pj, sj, {"tokens": jnp.asarray(toks)})
        pt, st, out = compiled(pt, st, {"tokens": t_of(toks)})
        assert abs(float(out["loss"]) - float(loss_j)) < TOL_STEP_LOSS, s
    assert len(compiled.graphs) == 1 and int(st["step"]) == steps


def _cli(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return T.main(argv)


def test_cli_resume_is_restart_exact(tmp_path):
    """The CLI (compiled steps) stopped after step 6 and resumed to 12
    ends on the uninterrupted run's loss, and its last checkpoint holds
    the uninterrupted run's params and moments bit for bit."""
    base = ["--arch", "minicpm-2b", "--reduced", "--steps", "12", "--batch",
            "2", "--seq", "32", "--ckpt-every", "4", "--log-every", "4",
            "--schedule", "wsd", "--device", "cpu"]
    ref = _cli(base + ["--ckpt-dir", str(tmp_path / "ref")])
    stopped = _cli(base + ["--ckpt-dir", str(tmp_path / "pre"),
                           "--stop-after", "6"])
    resumed = _cli(base + ["--ckpt-dir", str(tmp_path / "pre"), "--resume"])
    assert stopped["preempted_at"] == 6 and resumed["steps"] == 6
    assert resumed["final_loss"] == ref["final_loss"]
    step = _step("minicpm-2b")
    template = _fresh(step)
    (pa, sa), at_a = CheckpointStore(str(tmp_path / "ref")).restore(template)
    (pb, sb), at_b = CheckpointStore(str(tmp_path / "pre")).restore(template)
    assert at_a == at_b == 12 and int(sb["step"]) == 12
    assert all(torch.equal(a, b) for a, b in zip(_leaves(pa, sa),
                                                 _leaves(pb, sb)))


def test_cli_hands_its_compiled_step_to_wrap_step():
    """``main(wrap_step=...)`` is handed the compiled step the loop trains
    through, and the loop calls what it returns: one call a step, one
    graph for the run's one batch shape, the summary unchanged."""
    argv = ["--arch", "minicpm-2b", "--reduced", "--steps", "3", "--batch",
            "2", "--seq", "32", "--log-every", "1", "--device", "cpu"]
    made, losses = [], []

    def wrap(compiled):
        made.append(compiled)

        def call(params, opt_state, batch):
            res = compiled(params, opt_state, batch)
            losses.append(float(res[2]["loss"]))
            return res
        return call

    with contextlib.redirect_stdout(io.StringIO()):
        summary = T.main(argv, wrap_step=wrap)
        plain = T.main(argv)
    assert len(made) == 1 and len(made[0].graphs) == 1
    assert len(losses) == 3 and made[0].step.fn.__name__ == "train_step"
    assert summary == plain and summary["final_loss"] == losses[-1]

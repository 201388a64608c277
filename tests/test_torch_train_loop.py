"""Port parity: the training loop's update, schedule, checkpoint and the
carried sLSTM state's gradient, against the JAX package on the CPU.

* Six-step trajectories of ``StepUpdate`` against ``build_flat_step`` (the
  update ``Trainer._build_step`` runs), fed the same seeded gradients at the
  learning rate ``lr_schedule`` and ``warmup_lr`` give each step (warm-up
  over the first three steps, then the linear schedule), for each optimizer
  name, ``auto``, and accumulation 1 and 2 (``optax.MultiSteps``):
  parameters, EMA and every optimizer-state tensor (momentum trace, first
  and second moments, the accumulated gradient mean) within 1e-5 (rtol and
  atol; fp32 elementwise chains in another order). The learning rates
  themselves within 1e-7 relative.
* The schedule functions and ``EarlyStopping`` against JAX: exact up to
  fp32 (1e-7 relative).
* A checkpoint round trip through ``torch.load(weights_only=True)``: every
  parameter, buffer, EMA and optimizer-state tensor, ``n_updates`` and the
  epoch come back exactly.
* The plain reverse recurrence of the sLSTM (``slstm_scan_bwd_plain``) with a
  carried-in ``initial_state`` and cotangents on y and on every part of the
  returned last state, against ``jax.vjp`` of the JAX ``slstm_scan``: 1e-5
  relative to each gradient's max (fp32).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax  # noqa: F401  (build_flat_step's optimizers)

from xlstm_yolo_tpu.kernels import slstm as JS
from xlstm_yolo_tpu.utils import train_utils as JTU
from xlstm_yolo_torch.engine.trainer import TrainStep
from xlstm_yolo_torch.kernels import slstm as TS
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils import train_utils as TU
from xlstm_yolo_torch.utils.checkpoint import (load_checkpoint, load_optimizer_state,
                                               save_checkpoint)
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, port_named

TOL = dict(rtol=1e-5, atol=1e-5)
EPOCHS, NB = 3, 2  # six steps; warm-up min(max(round(3.0 * 2), 100), 3 * 2 // 2) = 3 steps


def _tree(rng):
    tree = {"a": {"kernel": rng.normal(size=(3, 4))},
            "bn": {"scale": rng.normal(size=4), "bias": rng.normal(size=4)},
            "norm": {"scale": rng.normal(size=4)}}
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tree)


def _module(tree):
    """The port's twin of ``_tree``: names ``a.weight``, ``bn.weight``,
    ``bn.bias``, ``norm.scale``, loaded with the tree's values."""
    module = torch.nn.Module()
    module.a = torch.nn.Linear(3, 4, bias=False)
    module.bn = torch.nn.BatchNorm1d(4)
    module.norm = torch.nn.Module()
    module.norm.scale = torch.nn.Parameter(torch.zeros(4))
    named = dict(module.named_parameters())
    with torch.no_grad():
        for n, arr in port_named(flatten_variables(tree)).items():
            named[n].copy_(torch.from_numpy(arr.copy()))
    return module


def _jax_state(opt_state, unravel, field):
    """The flat vectors of the JAX optimizer state held under ``field``
    (``mu``, ``nu``, ``trace``, ``acc_grads``), as port-named arrays."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        if getattr(path[-1], "name", None) == field and np.ndim(leaf) == 1:
            out.append(port_named(flatten_variables(unravel(leaf))))
    return out


@pytest.mark.parametrize("accumulate", [1, 2])
@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW", "NAdam", "RAdam", "RMSProp", "auto"])
def test_step_update_trajectory_matches_jax(name, accumulate):
    from jax.flatten_util import ravel_pytree

    rng = np.random.default_rng(7)
    tree = _tree(rng)
    grads = [jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), tree)
             for _ in range(EPOCHS * NB)]
    step_update, init_fn, jname, lr0, momentum = JTU.build_flat_step(
        tree, name=name, lr=0.01, momentum=0.937, decay=5e-4, nc=80, iterations=1000,
        clip_norm=0.5, accumulate=accumulate)
    module = _module(tree)
    upd = TU.StepUpdate(module, lr=0.01, momentum=0.937, weight_decay=5e-4, name=name, nc=80,
                        iterations=1000, accumulate=accumulate)
    assert (upd.name, upd.lr, upd.momentum) == (jname, lr0, momentum)
    lr_base = lr0 if name == "auto" else 0.01
    jsched, tsched = JTU.lr_schedule(lr_base, 0.01, EPOCHS), TU.lr_schedule(upd.lr, 0.01, EPOCHS)
    warm = TU.warmup_steps_for(3.0, NB, EPOCHS)
    assert warm == 3
    p, ema, opt = tree, tree, init_fn(tree)
    named = dict(module.named_parameters())
    for step, g in enumerate(grads):
        epoch = step // NB
        jlr = JTU.warmup_lr(step, epoch, warm, jsched(epoch))
        tlr = TU.warmup_lr(step, epoch, warm, tsched(epoch))
        np.testing.assert_allclose(tlr, jlr, rtol=1e-7, atol=1e-12)
        p, ema, opt = step_update(g, opt, p, ema, jnp.float32(jlr), step + 1)
        for n, arr in port_named(flatten_variables(g)).items():
            named[n].grad = torch.from_numpy(arr.copy())
        upd(step + 1, tlr)
    want_p = port_named(flatten_variables(p))
    want_e = port_named(flatten_variables(ema))
    for i, n in enumerate(upd.names):
        np.testing.assert_allclose(named[n].detach().numpy(), want_p[n], err_msg=n, **TOL)
        np.testing.assert_allclose(upd.ema[i].numpy(), want_e[n], err_msg=n, **TOL)
    _, unravel = ravel_pytree(tree)
    mine = {"mu": upd.mu, "nu": upd.nu, "trace": upd.trace, "acc_grads": upd.acc}
    for field, tensors in mine.items():
        theirs = _jax_state(opt, unravel, field)
        assert len(theirs) == (1 if tensors else 0), field
        for want in theirs:
            for i, n in enumerate(upd.names):
                np.testing.assert_allclose(tensors[i].numpy(), want[n], err_msg=f"{field} {n}",
                                           **TOL)


@pytest.mark.parametrize("cos_lr", [False, True])
def test_lr_schedule_and_warmup_match_jax(cos_lr):
    j, t = JTU.lr_schedule(0.01, 0.05, 7, cos_lr=cos_lr), TU.lr_schedule(0.01, 0.05, 7, cos_lr=cos_lr)
    for e in range(9):
        np.testing.assert_allclose(t(e), j(e), rtol=1e-7)
        for step in (0, 1, 50, 99, 100, 150):
            np.testing.assert_allclose(TU.warmup_lr(step, e, 100, t(e)),
                                       JTU.warmup_lr(step, e, 100, j(e)), rtol=1e-6, atol=1e-12)


def test_early_stopping_matches_jax():
    fitness = [0.1, 0.3, 0.2, 0.25, None, 0.3, 0.29, 0.28, 0.5]
    j, t = JTU.EarlyStopping(patience=3), TU.EarlyStopping(patience=3)
    for epoch, f in enumerate(fitness):
        assert t(epoch, f) == j(epoch, f), epoch
        assert (t.best_epoch, t.best_fitness) == (j.best_epoch, j.best_fitness)


def test_auto_optimizer_name_matches_jax():
    for nc, it in [(80, 1e5), (80, 10000), (3, 500), (1000, 20)]:
        assert TU.auto_optimizer_name(nc, it) == JTU.auto_optimizer_name(nc, it)


@pytest.mark.parametrize("name,accumulate", [("SGD", 1), ("AdamW", 2)])
def test_checkpoint_round_trip_is_exact(tmp_path, name, accumulate):
    """A TrainStep whose optimizer state, EMA and weights hold seeded noise
    (every tensor distinct from its init), saved and loaded back."""
    step = TrainStep(TaskModel("yolov8n.yaml", device="cpu"), optimizer=name,
                     accumulate=accumulate, amp=False)
    g = torch.Generator().manual_seed(3)
    noisy = lambda ts: [t.copy_(torch.randn(t.shape, generator=g)) for t in ts]
    with torch.no_grad():
        noisy(list(step.model.parameters()))
        noisy([b for n, b in step.model.named_buffers() if "running" in n])
        for k in ("trace", "mu", "nu", "acc", "ema"):
            noisy(getattr(step.update, k))
    step.n_updates, step.update.count, step.update.mini_step = 7, 3, accumulate - 1
    path = save_checkpoint(tmp_path / "last.pt", step, epoch=4, best_fitness=0.25)
    raw = torch.load(path, weights_only=True)
    assert raw["epoch"] == 4 and raw["n_updates"] == 7

    model, meta = load_checkpoint(path, use_ema=False, device="cpu")
    assert (meta["epoch"], meta["best_fitness"], meta["n_updates"]) == (4, 0.25, 7)
    for (n, a), (_, b) in zip(step.model.state_dict().items(), model.state_dict().items()):
        assert torch.equal(a, b), n
    ema_model, _ = load_checkpoint(path, use_ema=True, device="cpu")
    for (n, p), e in zip(ema_model.named_parameters(), step.update.ema):
        assert torch.equal(p, e), n

    fresh = TrainStep(model, optimizer=name, accumulate=accumulate, amp=False)
    assert load_optimizer_state(path, fresh)
    assert fresh.n_updates == 7
    assert (fresh.update.count, fresh.update.mini_step) == (3, accumulate - 1)
    for k in ("trace", "mu", "nu", "acc", "ema"):
        for a, b in zip(getattr(step.update, k), getattr(fresh.update, k)):
            assert torch.equal(a, b), k


def test_slstm_carried_state_plain_grads_match_jax_vjp():
    rng = np.random.default_rng(11)
    B, S, NH, DH = 2, 9, 2, 8
    wx = rng.normal(size=(B, S, NH, 4, DH)).astype(np.float32)
    r = (rng.normal(size=(NH, DH, 4, DH)) * 0.3).astype(np.float32)
    b = rng.normal(size=(NH, 4, DH)).astype(np.float32)
    _, st = JS.slstm_scan(jnp.asarray(rng.normal(size=(B, 3, NH, 4, DH)).astype(np.float32)),
                          jnp.asarray(r), jnp.asarray(b), return_last_state=True)
    state = tuple(np.asarray(s) for s in st)
    dy = rng.normal(size=(B, S, NH, DH)).astype(np.float32)
    dlast = tuple(rng.normal(size=(B, NH, DH)).astype(np.float32) for _ in range(4))

    f = lambda wx_, r_, b_, *s_: JS.slstm_scan(wx_, r_, b_, initial_state=s_,
                                                return_last_state=True)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (wx, r, b, *state)))
    want = vjp((jnp.asarray(dy), tuple(map(jnp.asarray, dlast))))

    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    ys, states = TS.slstm_scan_states(t(wx), t(r), t(b), initial_state=tuple(map(t, state)))
    dwx, dr, db, dstate = TS.slstm_scan_bwd_plain(
        t(wx), t(r), t(b), ys, states, t(dy), initial_state=tuple(map(t, state)),
        dlast=tuple(map(t, dlast)), with_state=True)
    for name, got, w in zip(("wx", "r", "b", "y0", "c0", "n0", "m0"),
                            (dwx, dr, db, *dstate), want):
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name

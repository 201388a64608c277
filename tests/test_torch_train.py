"""Port parity: the detection train step against the JAX package.

Seeded numpy inputs on the CPU through the JAX functions and the port's:

* TAL assignment and the v8 detection loss on the same predictions and
  padded labels: 1e-5 (rtol and atol), exact for masks and indices; the
  loss's gradient with respect to the head maps at 1e-5 as well.
* The weight-decay mask and the JAX-tree -> port-name mapping, exactly; the
  step update (clip, decay, nesterov SGD, EMA) against ``build_flat_step``
  on a small tree, with the clip both idle and active: 1e-6.
* vil_yolon at 64 px, batch 2, one train step through the port's own CPU
  path: its ViL layers take the hand-written backward (frozen stabilizer),
  while the JAX package on the CPU differentiates the native form by
  autodiff. Gate kernels stay at their JAX init (zero), so no gate
  gradient reaches q/k/v and every gradient but the gate kernels' and
  biases' is held at 1e-4 (rtol, with an atol of 1e-4 times the largest
  gradient of the model: train-mode BatchNorm over the 2x2 P5 map
  magnifies fp32 summation-order differences); ``igate``/``fgate`` are held
  at 2e-2 relative to each tensor's max (the dropped normalizer-floor
  terms). The BatchNorm running statistics after that step's forward: 1e-5.
The whole step with the plain ViL forward (autograd, like JAX) is held in
``test_torch_model.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax  # noqa: F401  (build_flat_step's optimizer)

from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_tpu.utils import loss as JL, tal as JT, train_utils as JTU
from xlstm_yolo_torch.engine.trainer import TrainStep
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils import loss as TL, tal as TT
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables, port_named
from xlstm_yolo_torch.utils.train_utils import StepUpdate, is_no_decay

TOL = dict(rtol=1e-5, atol=1e-5)


def _labels(b=2, n_max=32):
    """Padded (cls, x1, y1, x2, y2) pixel labels for 64 px images."""
    cb = np.zeros((b, n_max, 5), np.float32)
    mask = np.zeros((b, n_max), bool)
    cb[0, :3] = [[1, 10, 10, 40, 50], [3, 30, 5, 60, 30], [0, 2, 2, 20, 20]]
    cb[1, :2] = [[1, 10, 10, 40, 50], [7, 2, 20, 30, 62]]
    mask[0, :3], mask[1, :2] = True, True
    return cb, mask


def _maps(seed, nc=80, b=2, hw=(8, 4, 2)):
    """Per-scale raw head maps, NHWC for JAX and NCHW for the port."""
    rng = np.random.default_rng(seed)
    jm, tm = [], []
    for s in hw:
        box = rng.normal(size=(b, s, s, 64)).astype(np.float32)
        cls = (rng.normal(size=(b, s, s, nc)) - 2).astype(np.float32)
        jm.append((jnp.asarray(box), jnp.asarray(cls)))
        tm.append((torch.from_numpy(box.transpose(0, 3, 1, 2).copy()),
                   torch.from_numpy(cls.transpose(0, 3, 1, 2).copy())))
    return jm, tm


def test_topk_positive_mask_matches_jax_with_ties():
    m = np.random.default_rng(0).integers(0, 4, (2, 3, 40)).astype(np.float32) / 4
    want = JT.topk_positive_mask(jnp.asarray(m), 10)
    np.testing.assert_array_equal(TT.topk_positive_mask(torch.from_numpy(m), 10).numpy(),
                                  np.asarray(want))


def test_assign_matches_jax():
    rng = np.random.default_rng(1)
    n = 84
    scores = rng.normal(size=(2, n, 80)).astype(np.float32)
    anchors = rng.uniform(0, 64, (n, 2)).astype(np.float32)
    boxes = np.concatenate([anchors - rng.uniform(2, 20, (2, n, 2)),
                            anchors + rng.uniform(2, 20, (2, n, 2))], -1).astype(np.float32)
    cb, mask = _labels()
    want = JT.assign(jnp.asarray(scores), jnp.asarray(boxes), jnp.asarray(anchors),
                     jnp.asarray(cb[..., :1]), jnp.asarray(cb[..., 1:]),
                     jnp.asarray(mask[..., None]), scores_are_logits=True)
    got = TT.assign(torch.from_numpy(scores), torch.from_numpy(boxes), torch.from_numpy(anchors),
                    torch.from_numpy(cb[..., :1]), torch.from_numpy(cb[..., 1:]),
                    torch.from_numpy(mask[..., None]))
    assert int(got[3].sum()) > 0
    for i in (0, 3, 4):  # labels, fg mask, gt index
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    for i in (1, 2):  # boxes, scores
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), **TOL)


def test_detection_loss_and_its_gradient_match_jax():
    jm, tm = _maps(2)
    cb, mask = _labels()

    def jloss(maps):
        lo = JL.detection_loss(maps, jnp.asarray(cb), jnp.asarray(mask), (8, 16, 32), 80)
        return lo.total, lo

    (jt, jlo), jg = jax.value_and_grad(jloss, has_aux=True)(jm)
    leaves = [(b.requires_grad_(), c.requires_grad_()) for b, c in tm]
    tlo = TL.detection_loss(leaves, torch.from_numpy(cb), torch.from_numpy(mask), (8, 16, 32))
    tlo.total.backward()
    for name in ("total", "box", "cls", "dfl"):
        np.testing.assert_allclose(float(getattr(tlo, name).detach()), float(getattr(jlo, name)),
                                   err_msg=name, **TOL)
    for (tb, tc), (gb, gc) in zip(leaves, jg):
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb).transpose(0, 3, 1, 2), **TOL)
        np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc).transpose(0, 3, 1, 2), **TOL)


@pytest.fixture(scope="module")
def vil():
    """JAX vil_yolon variables: seeded noise on every leaf but the gate
    kernels (zero at init); BatchNorm variances kept positive."""
    jm = JaxTaskModel("vil_yolon.yaml")
    v = jax.jit(lambda: jm.init(0, imgsz=64))()
    rng = np.random.default_rng(0)

    def leaf(path, x):
        keys = [getattr(k, "key", "") for k in path]
        x = np.asarray(x)
        if keys[-1] == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape).astype(x.dtype))
        if keys[-1] == "kernel" and keys[-2] in ("igate", "fgate"):
            return jnp.asarray(x)
        return jnp.asarray(x + 0.05 * rng.normal(size=x.shape).astype(x.dtype))

    return jm, jax.tree_util.tree_map_with_path(leaf, v)


def test_port_named_round_trips_every_param(vil):
    """Every JAX ``params`` leaf maps to exactly one port parameter of the
    same shape, which after loading holds that leaf's values."""
    jm, v = vil
    model = load_jax_variables(TaskModel("vil_yolon.yaml", device="cpu"), flatten_variables(v))
    mapped = port_named(flatten_variables(v["params"]))
    named = dict(model.named_parameters())
    assert mapped.keys() == named.keys()
    assert len(mapped) == len(jax.tree.leaves(v["params"]))
    for name, arr in mapped.items():
        np.testing.assert_array_equal(named[name].detach().numpy(), arr, err_msg=name)


def test_is_no_decay_matches_jax(vil):
    jm, v = vil
    want = jax.tree_util.tree_map_with_path(lambda p, x: np.full(x.shape, JTU._is_no_decay(p)),
                                            v["params"])
    mapped = port_named(flatten_variables(want))
    assert {n: bool(m.all()) for n, m in mapped.items()} == {n: is_no_decay(n) for n in mapped}
    # the fork's quirk: RMSNorm and outnorm scales and learnable_skip decay
    assert not is_no_decay("l4.pair0.fwd.layer.norm.scale")
    assert not is_no_decay("l4.pair0.fwd.layer.learnable_skip")
    assert is_no_decay("l0.bn.weight") and is_no_decay("l4.pair0.fwd.layer.proj_up.bias")


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["clip_idle", "clip_active"])
def test_step_update_matches_build_flat_step(grad_scale):
    rng = np.random.default_rng(3)
    tree = {"a": {"kernel": rng.normal(size=(3, 4))}, "bn": {"scale": rng.normal(size=4),
                                                              "bias": rng.normal(size=4)},
            "norm": {"scale": rng.normal(size=4)}}
    tree = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tree)
    grads = [jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape) * grad_scale,
                                                jnp.float32), tree) for _ in range(2)]

    module = torch.nn.Module()
    module.a = torch.nn.Linear(3, 4, bias=False)
    module.bn = torch.nn.BatchNorm1d(4)
    module.norm = torch.nn.Module()
    module.norm.scale = torch.nn.Parameter(torch.zeros(4))
    named = dict(module.named_parameters())
    with torch.no_grad():
        for n, arr in port_named(flatten_variables(tree)).items():
            named[n].copy_(torch.from_numpy(arr.copy()))

    step_update, init_fn, *_ = JTU.build_flat_step(tree, name="SGD", lr=0.01, momentum=0.937,
                                                   clip_norm=0.5)
    p, ema, opt = tree, tree, init_fn(tree)
    upd = StepUpdate(module)
    for n_updates, g in enumerate(grads, start=1):
        p, ema, opt = step_update(g, opt, p, ema, jnp.float32(0.01), n_updates)
        for name, arr in port_named(flatten_variables(g)).items():
            named[name].grad = torch.from_numpy(arr.copy())
        upd(n_updates)
    want_p = port_named(flatten_variables(p))
    want_e = port_named(flatten_variables(ema))
    for i, name in enumerate(upd.names):
        np.testing.assert_allclose(named[name].detach().numpy(), want_p[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(upd.ema[i].numpy(), want_e[name], rtol=1e-6, atol=1e-6,
                                   err_msg=name)


@pytest.fixture(scope="module")
def hand_step(vil):
    """One train step on both sides: (JAX grads and batch stats mapped to
    port names, port model after the step's forward and backward)."""
    jm, v = vil
    imgs = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    cb, mask = _labels()
    batch = {"img": jnp.asarray(imgs.astype(np.float32) / 255.0), "cls_boxes": jnp.asarray(cb),
             "mask": jnp.asarray(mask)}

    def loss_fn(p):
        (total, _), upd = jm.loss({"params": p, "batch_stats": v["batch_stats"]}, batch,
                                  train=True)
        return total, upd

    (_, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    model = load_jax_variables(TaskModel("vil_yolon.yaml", device="cpu"), flatten_variables(v))
    step = TrainStep(model, amp=False)
    total, _ = step.forward_loss({"img": torch.from_numpy(imgs), "cls_boxes": torch.from_numpy(cb),
                                  "mask": torch.from_numpy(mask)})
    step.backward(total)
    return (port_named(flatten_variables(grads)),
            port_named(flatten_variables(upd["batch_stats"]), "batch_stats"), model)


def test_hand_backward_gradients_match_jax(hand_step):
    want, _, model = hand_step
    gmax = max(np.abs(g).max() for g in want.values())
    gates = 0
    for name, p in model.named_parameters():
        got, w = p.grad.numpy(), want[name]
        if ".igate." in name or ".fgate." in name:
            gates += 1
            assert np.abs(got - w).max() <= 2e-2 * np.abs(w).max(), name
        else:
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4 * gmax, err_msg=name)
    assert gates == 12  # kernel and bias of both gates, 3 ViL layers


def test_bn_running_stats_after_train_forward_match_jax(hand_step):
    _, want, model = hand_step
    state = model.state_dict()
    assert len(want) == sum(k.endswith("running_mean") for k in state) * 2
    for name, w in want.items():
        np.testing.assert_allclose(state[name].numpy(), w, err_msg=name, **TOL)

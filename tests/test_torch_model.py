"""Port parity: whole detection models and the predictor against JAX.

yolov8n and vil_yolon at 64 px on the CPU: the JAX package initializes the
variables (then seeded noise makes every parameter and BN statistic
matter, and zero class biases give real detections), ``load_jax_variables``
fills the port, and the same seeded inputs go through both. Tolerance
1e-4 (relative, with 1e-4 absolute for scores near 0): fp32 end to end,
differences come from summation order only.

The train step (train-mode forward, v8 loss, backward, clip, decay,
nesterov SGD, EMA) runs three times on both sides with the port's ViL
layers on their plain forward (autograd, as the JAX package differentiates
on the CPU): losses, and params and EMA after the three steps, at 1e-4
(rtol and atol); step-1 gradients at rtol 1e-4 with an atol of 1e-4 times
the model's largest gradient (train-mode BatchNorm over the 2x2 P5 map
magnifies fp32 summation-order differences).
"""
import math
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import xlstm_yolo_torch.nn.vil as vil_mod

from xlstm_yolo_tpu.nn.fuse import fuse_conv_bn as jax_fuse
from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_tpu.ops.letterbox import letterbox_device as jax_letterbox
from xlstm_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from xlstm_yolo_tpu.utils.train_utils import build_flat_step
from xlstm_yolo_torch.engine.predictor import Predictor
from xlstm_yolo_torch.engine.trainer import TrainStep
from xlstm_yolo_torch.kernels.vil_layer import vil_layer_ref
from xlstm_yolo_torch.nn.fuse import fuse_conv_bn
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables, port_named

TOL = dict(rtol=1e-4, atol=1e-4)
MODELS = ["yolov8n.yaml", "vil_yolon.yaml"]
JAX_PARAMS = {"yolov8n.yaml": 3_157_184, "vil_yolon.yaml": 3_187_036}


def _perturb(variables, seed):
    """Seeded noise on every leaf (BN variances kept positive); zero class
    biases so that detections clear the 0.25 confidence threshold."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        keys = [getattr(k, "key", "") for k in path]
        x = np.asarray(x)
        if keys[-1] == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape).astype(x.dtype))
        if keys[-1] == "bias" and keys[-2].startswith("cv3_") and keys[-2].endswith("_2"):
            return jnp.zeros_like(x)
        return jnp.asarray(x + 0.05 * rng.normal(size=x.shape).astype(x.dtype))

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    """(JAX model, JAX variables, port model with the same weights)."""
    jm = JaxTaskModel(request.param)
    v = _perturb(jax.jit(lambda: jm.init(0, imgsz=64))(), seed=0)
    tm = load_jax_variables(TaskModel(request.param, device="cpu"), flatten_variables(v))
    return jm, v, tm


def _images(seed, b=2, s=64):
    return np.random.default_rng(seed).uniform(0, 1, (b, s, s, 3)).astype(np.float32)


def test_param_count_and_strides_match_jax(pair):
    jm, v, tm = pair
    assert tm.num_params() == jm.num_params(v) == JAX_PARAMS[jm.cfg_name]
    assert tm.strides == jm.strides == (8, 16, 32)


def test_predictions_match_jax(pair):
    jm, v, tm = pair
    x = _images(1)
    want = jax.jit(jm.predictions)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm.predictions(torch.from_numpy(x))
    assert got.shape == (2, 84, 84)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_predictions_match_jax(pair):
    jm, v, tm = pair
    x = _images(2)
    want = jax.jit(jm.predictions)(jax_fuse(v), jnp.asarray(x))
    fused = fuse_conv_bn(load_jax_variables(TaskModel(jm.cfg_name, device="cpu"),
                                            flatten_variables(v)))
    with torch.no_grad():
        got = fused.predictions(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_predictor_matches_jax_pipeline(pair):
    """uint8 frames -> letterbox -> predictions -> NMS, as the JAX bench.

    The predict path ranks class scores rounded to bfloat16, so equal scores
    are common. JAX's ``fast_sel`` ranks them with ``approx_max_k``, whose
    order among equal values is the backend's; the port breaks ties to the
    lower index. The reference is therefore the JAX pipeline with the
    scores rounded to bfloat16 and exact (index-stable) top-k selection:
    the same rule with a defined tie order."""
    jm, v, tm = pair
    frames = np.random.default_rng(3).integers(0, 256, (2, 54, 81, 3), dtype=np.uint8)
    x, _ = jax_letterbox(jnp.asarray(frames), imgsz=64, dtype_name="float32")
    cands = jax.jit(jm.predictions)(v, x)
    cands = cands.at[..., 4:].set(cands[..., 4:].astype(jnp.bfloat16).astype(jnp.float32))
    jd, jv = jax_nms(cands, conf_thres=0.25, iou_thres=0.7, max_det=300, pre_topk=512)
    td, tv, cands, meta = Predictor(tm, imgsz=64)(frames)
    assert td.shape == (2, 300, 6) and tv.shape == (2, 300)
    assert int(tv.sum()) > 0
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)


def test_train_steps_match_jax(pair):
    """The class biases go back to their init value (the fixture zeroes them
    for the detection tests), as at the start of training."""
    jm, v, _ = pair

    def init_cls_bias(path, x):
        name = getattr(path[-2], "key", "")
        if path[-1].key == "bias" and name.startswith("cv3_") and name.endswith("_2"):
            return jnp.full_like(x, math.log(5 / 80 / (640 / jm.strides[int(name[4])]) ** 2))
        return x

    v = {**v, "params": jax.tree_util.tree_map_with_path(init_cls_bias, v["params"])}
    imgs = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    cb = np.zeros((2, 32, 5), np.float32)
    mask = np.zeros((2, 32), bool)
    cb[0, :2] = [[1, 10, 10, 40, 50], [3, 30, 5, 60, 30]]
    cb[1, :2] = [[1, 10, 10, 40, 50], [7, 2, 20, 30, 62]]
    mask[:, :2] = True
    jbatch = {"img": jnp.asarray(imgs.astype(np.float32) / 255.0),
              "cls_boxes": jnp.asarray(cb), "mask": jnp.asarray(mask)}
    step_update, opt_init, *_ = build_flat_step(v["params"], name="SGD", lr=0.01,
                                                momentum=0.937, clip_norm=0.5)

    @jax.jit
    def jstep(params, batch_stats, opt, ema, n):  # Trainer._build_step's train_step
        def loss_fn(p):
            (total, _), upd = jm.loss({"params": p, "batch_stats": batch_stats}, jbatch,
                                      train=True)
            return total, upd

        (total, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        params, ema, opt = step_update(grads, opt, params, ema, jnp.float32(0.01), n + 1)
        return params, upd["batch_stats"], opt, ema, n + 1, total, grads

    state = (v["params"], v["batch_stats"], opt_init(v["params"]), v["params"], jnp.int32(0))
    model = load_jax_variables(TaskModel(jm.cfg_name, device="cpu"), flatten_variables(v))
    step = TrainStep(model)
    tbatch = {"img": torch.from_numpy(imgs), "cls_boxes": torch.from_numpy(cb),
              "mask": torch.from_numpy(mask)}
    with mock.patch.object(vil_mod, "vil_layer_fwd", vil_layer_ref):
        for i in range(3):
            *state, jtotal, jgrads = jstep(*state)
            total, _ = step.forward_loss(tbatch)
            step.backward(total)
            np.testing.assert_allclose(float(total.detach()), float(jtotal), **TOL)
            if i == 0:
                want = port_named(flatten_variables(jgrads))
                gmax = max(np.abs(g).max() for g in want.values())
                for name, p in model.named_parameters():
                    np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4,
                                               atol=1e-4 * gmax, err_msg=name)
            step.apply_update()
    want_p = port_named(flatten_variables(state[0]))
    want_e = port_named(flatten_variables(state[3]))
    for i, (name, p) in enumerate(model.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), want_p[name], err_msg=name, **TOL)
        np.testing.assert_allclose(step.update.ema[i].numpy(), want_e[name], err_msg=name, **TOL)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_jax_variables_rejects_mismatch(pair, fault):
    jm, v, _ = pair
    flat = flatten_variables(v)
    key = "params/l0/conv/kernel"
    if fault == "missing":
        del flat[key]
    elif fault == "extra":
        flat["params/l0/conv/bias"] = np.zeros(16, np.float32)
    else:
        flat[key] = flat[key][..., :-1]
    with pytest.raises((KeyError, ValueError)):
        load_jax_variables(TaskModel(jm.cfg_name, device="cpu"), flat)


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        TaskModel("yolov8n.yaml")

"""Port parity: whole detection models and the predictor against JAX.

yolov8n and vil_yolon at 64 px on the CPU: the JAX package initializes the
variables (then seeded noise makes every parameter and BN statistic
matter, and zero class biases give real detections), ``load_jax_variables``
fills the port, and the same seeded inputs go through both. Tolerance
1e-4 (relative, with 1e-4 absolute for scores near 0): fp32 end to end,
differences come from summation order only.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xlstm_yolo_tpu.nn.fuse import fuse_conv_bn as jax_fuse
from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_tpu.ops.letterbox import letterbox_device as jax_letterbox
from xlstm_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from xlstm_yolo_torch.engine.predictor import Predictor
from xlstm_yolo_torch.nn.fuse import fuse_conv_bn
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables

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

"""Port parity: the segment, pose and OBB models against the JAX package.

On the CPU, fp32, torch on one thread:

* every ``-seg``, ``-pose`` and ``-obb`` YAML in the port (YOLOv8, v8-p6,
  v9c / v9e, YOLO11, YOLO12) at its first scale: the parameter count and
  strides of the port's graph (on the meta device) equal the JAX
  ``TaskModel``'s (``TASK_ZOO``, from ``jax.eval_shape`` of the JAX graph's
  init); the P6 files are named with their scale (``yolov8n-pose-p6.yaml``
  does not resolve in either package);
* ``predictions_full`` at 64 px on the same weights (the port's seeded
  init, perturbed, carried to a JAX tree) within 1e-4, for yolov8n-seg
  (``coefs``, ``proto``), yolo11n-pose at ``kpt_shape`` (5, 3) and
  yolo11n-obb (the angle);
* one train-mode forward, the task's loss and backward: the loss within
  1e-3 and every gradient within 1e-3 (rtol, atol 1e-3 of the largest
  gradient) of the port's own fp64 step; against JAX's fp32 gradients
  within the same bound, or where JAX's own fp32 step lies further from the
  fp64 one (the pose model, at 0.9 of the bound), within the sum of the two
  fp32 steps' measured distances from it;
* ``Validator`` on a PNG set the port writes, metrics equal to the JAX
  ``Validator``'s on the same weights within 1e-6 (``mAP50(M)``,
  ``mAP50(P)``, the OBB ``mAP50``), and the predictor's masks, keypoints
  and ``.obb`` against the JAX ``Predictor`` on two of its PNGs;
* ``fuse_conv_bn`` on the seg model: every ConvBN folded as the JAX fuse
  folds it, ``proto_up`` (a bare transposed conv with a bias) left as it
  is, the fused outputs equal to the unfused ones;
* ``YOLO`` of each task through train / val / predict / info / embed /
  fuse / save / load / reset_weights on the CPU;
* the graph takes the ``Classify`` head and still refuses the names of
  ``NOT_PORTED`` with their reason (the classify task itself:
  ``tests/test_torch_classify.py``).
"""
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_detect_zoo import compiled, jax_task_model  # noqa: F401
from test_torch_yolo11 import one_thread  # noqa: F401
from xlstm_yolo_tpu.cfg import load_model_yaml as jax_load_model_yaml
from xlstm_yolo_tpu.engine.predictor import Predictor as JaxPredictor
from xlstm_yolo_tpu.engine.validator import Validator as JaxValidator
from xlstm_yolo_tpu.nn.fuse import fuse_conv_bn as jax_fuse
from xlstm_yolo_torch.cfg import load_model_yaml
from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset
from xlstm_yolo_torch.engine.predictor import Predictor
from xlstm_yolo_torch.engine.validator import Validator
from xlstm_yolo_torch.nn.fuse import fuse_conv_bn
from xlstm_yolo_torch.nn.graph import GraphModel, parse_model
from xlstm_yolo_torch.nn.heads import det_maps
from xlstm_yolo_torch.nn.modules import ConvBN
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils.jax_weights import (
    flatten_variables, load_jax_variables, port_named, torch_name, transposed_convs)

TOL_REL = 1e-4
IMGSZ = 64

# label -> (YAML, scale, task, JAX strides, JAX parameter count at the YAML's nc)
TASK_ZOO = {
    "yolo11n-seg": ("yolo11n-seg.yaml", None, "segment", (8, 16, 32), 2_876_832),
    "yolov8n-seg": ("yolov8n-seg.yaml", None, "segment", (8, 16, 32), 3_409_952),
    "yolov8n-seg-p6": ("yolov8-seg-p6.yaml", "n", "segment", (8, 16, 32, 64), 5_302_800),
    "yolo12n-seg": ("yolo12n-seg.yaml", None, "segment", (8, 16, 32), 2_855_040),
    "yolov9c-seg": ("yolov9c-seg.yaml", None, "segment", (8, 16, 32), 27_897_104),
    "yolov9e-seg": ("yolov9e-seg.yaml", None, "segment", (8, 16, 32), 60_512_784),
    "yolo11n-pose": ("yolo11n-pose.yaml", None, "pose", (8, 16, 32), 2_908_491),
    "yolov8n-pose": ("yolov8n-pose.yaml", None, "pose", (8, 16, 32), 3_295_454),
    "yolov8n-pose-p6": ("yolov8-pose-p6.yaml", "n", "pose", (8, 16, 32, 64), 5_182_136),
    "yolo12n-pose": ("yolo12n-pose.yaml", None, "pose", (8, 16, 32), 2_886_699),
    "yolo11n-obb": ("yolo11n-obb.yaml", None, "obb", (8, 16, 32), 2_695_731),
    "yolov8n-obb": ("yolov8n-obb.yaml", None, "obb", (8, 16, 32), 3_228_851),
    "yolo12n-obb": ("yolo12n-obb.yaml", None, "obb", (8, 16, 32), 2_673_939),
}

PAIRS = {  # the models held against JAX at 64 px: (YAML, nc, kpt_shape)
    "yolov8n-seg": ("yolov8n-seg.yaml", 3, None),
    "yolo11n-pose": ("yolo11n-pose.yaml", 1, (5, 3)),
    "yolo11n-obb": ("yolo11n-obb.yaml", 3, None),
}


@pytest.mark.parametrize("name", list(TASK_ZOO))
def test_param_count_and_strides_match_jax(name):
    path, scale, task, strides, params = TASK_ZOO[name]
    cfg, s = load_model_yaml(path)
    with torch.device("meta"):
        parsed = parse_model(cfg, scale=scale or s)
        g = GraphModel(parsed).eval()
        out = det_maps(g(torch.zeros(1, 3, 512, 512)))
    assert parsed.task == task
    assert sum(p.numel() for p in g.parameters()) == params
    assert tuple(512 // bm.shape[2] for bm, _ in out) == strides


def test_classify_still_refused():
    """Named when the port refused the ``Classify`` head: the graph now takes
    it (the task classify, the head over one map at the YAML's nc), and a
    name still in ``NOT_PORTED`` is refused with its reason."""
    cfg = {"nc": 10, "backbone": [[-1, 1, "Conv", [16, 3, 2]]],
           "head": [[-1, 1, "Classify", ["nc"]]]}
    parsed = parse_model(cfg)
    assert parsed.task == "classify" and parsed.head_index == 1
    assert parsed.specs[1].args == (16, 10)
    cfg["backbone"][0][2] = "Focus"
    with pytest.raises(KeyError, match="no detection YAML uses it"):
        parse_model(cfg)


def _pair(name, seed=0):
    """(JAX model, JAX variables, port model) on the port's seeded init with
    seeded noise on every tensor, carried to the JAX tree."""
    path, nc, kpt_shape = PAIRS[name]
    ours, scale = load_model_yaml(path)
    theirs, _ = jax_load_model_yaml(path)
    if kpt_shape is not None:
        ours["kpt_shape"] = theirs["kpt_shape"] = list(kpt_shape)
    tm = TaskModel(ours, scale=scale, nc=nc, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for key, t in tm.state_dict().items():
            if key.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            elif t.is_floating_point():
                t.add_(torch.from_numpy(0.05 * rng.normal(size=tuple(t.shape)).astype(np.float32)))
    jm = jax_task_model(theirs, scale, tm.strides, nc)
    state, transposed = tm.state_dict(), transposed_convs(tm)

    def leaf(path, sds):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        idx = np.arange(int(np.prod(sds.shape))).reshape(sds.shape)
        port, where = torch_name(key, idx, transposed)
        out = np.empty(idx.size, np.float32)
        out[where.reshape(-1)] = state[port].numpy().reshape(-1)
        return jnp.asarray(out.reshape(sds.shape))

    v = jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(lambda: jm.init(0, imgsz=IMGSZ)))
    assert tm.num_params() == jm.num_params(v) and tm.task == jm.task
    return jm, v, tm


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _pair(name)
        return cache[name]

    return get


def close(got, want, tol=TOL_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("name", list(PAIRS))
def test_predictions_full_match_jax(pairs, name):
    jm, v, tm = pairs(name)
    x = np.random.default_rng(1).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want = compiled(jm.predictions_full, v, jnp.asarray(x))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval().predictions_full(torch.from_numpy(x))
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].numpy()
        if key == "proto":
            g = g.transpose(0, 2, 3, 1)
        if key == "cands":  # boxes, scores (and the OBB angle) each of its own max
            nc = tm.nc
            for sl in (np.s_[..., :4], np.s_[..., 4:4 + nc], np.s_[..., 4 + nc:]):
                if np.asarray(w)[sl].size:
                    close(g[sl], np.asarray(w)[sl])
        else:
            close(g, w)


def _task_batch(tm, rng):
    imgs = rng.uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    m = 8
    mask = np.zeros((2, m), bool)
    mask[0, :2] = mask[1, :3] = True
    batch = {"img": imgs, "mask": mask}
    if tm.task == "obb":
        cb = np.zeros((2, m, 6), np.float32)
        cb[mask, 0] = rng.integers(0, tm.nc, mask.sum())
        cb[mask, 1:3] = rng.uniform(16, 48, (mask.sum(), 2))
        cb[mask, 3:5] = rng.uniform(10, 30, (mask.sum(), 2))
        cb[mask, 5] = rng.uniform(-1.2, 1.2, mask.sum())
    else:
        cb = np.zeros((2, m, 5), np.float32)
        cb[mask, 0] = rng.integers(0, tm.nc, mask.sum())
        cb[mask, 1:3] = rng.uniform(2, 30, (mask.sum(), 2))
        cb[mask, 3:5] = cb[mask, 1:3] + rng.uniform(12, 30, (mask.sum(), 2))
    batch["cls_boxes"] = cb
    if tm.task == "segment":
        masks = np.zeros((2, IMGSZ // 4, IMGSZ // 4), np.int32)
        for i in range(2):
            for s in range(int(mask[i].sum())):
                x1, y1, x2, y2 = (cb[i, s, 1:5] / 4).astype(int)
                masks[i, y1:y2, x1:x2] = s + 1
        batch["masks"] = masks
    if tm.task == "pose":
        nk = tm.kpt_shape[0]
        kp = np.zeros((2, m, nk, 3), np.float32)
        kp[..., :2] = cb[..., None, 1:3] + rng.uniform(0, 12, (2, m, nk, 2))
        kp[..., 2] = rng.integers(0, 3, (2, m, nk))
        batch["keypoints"] = kp
    return batch


@pytest.mark.parametrize("name", list(PAIRS))
def test_train_step_loss_and_grads_match_jax(pairs, name):
    jm, v, tm = pairs(name)
    batch = _task_batch(tm, np.random.default_rng(2))
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}

    def jloss(params):
        (total, aux), _ = jm.loss({"params": params, "batch_stats": v["batch_stats"]}, jbatch,
                                  train=True)
        return total, aux

    (jtotal, jaux), jgrads = compiled(jax.value_and_grad(jloss, has_aux=True),
                                      v["params"])(v["params"])
    grads = {}
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(tm).to(dtype).train()
        total, aux = m.loss({k: torch.from_numpy(a).to(dtype) if a.dtype == np.float32
                             else torch.from_numpy(a) for k, a in batch.items()})
        total.backward()
        grads[dtype] = {key: p.grad.double().numpy() for key, p in m.named_parameters()}
        if dtype == torch.float32:
            np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-3)
            assert set(aux) == set(jaux)
            for k in aux:
                np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=1e-3,
                                           atol=1e-6, err_msg=k)
    want = port_named(flatten_variables(jgrads), transposed=transposed_convs(tm))
    exact = grads[torch.float64]
    gmax = max(np.abs(g).max() for g in exact.values())

    def dist(a, b):  # the worst element, in units of the 1e-3 bound
        return max((np.abs(a[k] - b[k]) / (1e-3 * np.abs(b[k]) + 1e-3 * gmax)).max() for k in b)

    port_err, jax_err = dist(grads[torch.float32], exact), dist(want, exact)
    print(name, f"port fp32 {port_err:.3f}, JAX fp32 {jax_err:.3f} of the bound from fp64")
    assert port_err <= 1.0
    assert dist(grads[torch.float32], want) <= max(1.0, port_err + jax_err)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("task_data")
    return {task: make_synthetic_dataset(root / task, n_train=2, n_val=4, imgsz=IMGSZ,
                                         task=task, seed=4)
            for task in ("segment", "pose", "obb")}


TASK_OF = {"yolov8n-seg": "segment", "yolo11n-pose": "pose", "yolo11n-obb": "obb"}


@pytest.mark.parametrize("name", list(PAIRS))
def test_validator_metrics_match_jax(pairs, datasets, name):
    """Both validators at conf 0.001 on the same weights (the class biases
    lifted so that many candidates pass) and the same PNGs."""
    jm, v, tm = pairs(name)
    head = f"l{tm.parsed.head_index}"
    tm = copy.deepcopy(tm)
    with torch.no_grad():
        for i in range(len(tm.strides)):
            getattr(getattr(tm, head).detect, f"cv3_{i}_2").bias.add_(4.0)

    def lift(path, x):
        keys = [getattr(k, "key", "") for k in path]
        return x + 4.0 if keys[-1] == "bias" and keys[-2].startswith("cv3_") and keys[
            -2].endswith("_2") else x

    v = jax.tree_util.tree_map_with_path(lift, v)
    data = datasets[TASK_OF[name]]
    want = JaxValidator(jm, imgsz=IMGSZ, batch=4)(v, data)
    got = Validator(tm, imgsz=IMGSZ, batch=4)(data)
    keys = {"precision", "recall", "mAP50", "mAP50-95", "fitness"} | {
        k for k in want if "(" in k}
    print(name, {k: (got[k], want[k]) for k in sorted(keys)})
    for k in keys:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    tag = {"segment": "mAP50(M)", "pose": "mAP50(P)", "obb": "mAP50"}[tm.task]
    assert tag in got


@pytest.mark.parametrize("name", list(PAIRS))
def test_predictor_matches_jax(pairs, datasets, name):
    """The per-image predictor on two PNGs against the JAX ``Predictor``
    (conf 0.001). OBB: the rotated boxes. Segment and pose serve through
    the bfloat16 score selection, whose ties (these random weights tie many
    candidates' scores in bfloat16) each side orders its own way: there
    the boxes of both sides are compared as sets of (score, class), and the
    masks and keypoints by feeding the JAX predictor's own device outputs
    (kept boxes, candidates, coefficients and prototypes, keypoints) to the
    port's re-association and assembly."""
    from pathlib import Path

    from xlstm_yolo_torch.data.augment import letterbox
    from xlstm_yolo_torch.data.imgproc import imread

    jm, v, tm = pairs(name)
    files = [str(f) for f in sorted((Path(datasets[TASK_OF[name]]).parent / "images"
                                     / "val").iterdir())[:2]]
    jp = JaxPredictor(jm, v, imgsz=IMGSZ, conf=0.001, verbose=False)
    tp = Predictor(tm.eval(), imgsz=IMGSZ, conf=0.001, verbose=False)
    for f, g, w in zip(files, tp(files), jp(files)):
        assert len(g) == len(w) > 0
        if tm.task == "obb":
            np.testing.assert_allclose(g.obb.data, np.asarray(w.obb.data), rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(g.boxes.data, np.asarray(w.boxes.data), rtol=1e-4,
                                       atol=1e-3)
            continue
        key = lambda b: sorted(map(tuple, np.round(np.asarray(b.data)[:, 4:], 6)))
        assert key(g.boxes) == key(w.boxes)
        img, _, (r, px, py) = letterbox(imread(f), IMGSZ)
        out = [np.asarray(o) for o in jp._jit(v, jnp.asarray(img, jnp.float32)[None] / 255.0)]
        d = out[0][0][out[1][0]]
        if tm.task == "segment":
            proto = out[4][0]
            want = jp._assemble_masks(d, out[2][0], out[3][0], proto, (IMGSZ, IMGSZ), r, px, py)
            got = tp._assemble_masks(d, out[2][0], out[3][0], proto.transpose(2, 0, 1),
                                     (IMGSZ, IMGSZ), r, px, py)
            assert got.shape == want.shape == (len(d), IMGSZ, IMGSZ) and g.masks.shape == got.shape
            assert (got != want).mean() <= 1e-4
        else:
            want = jp._gather_kpts(d, out[2][0], out[3][0], r, px, py)
            got = tp._gather_kpts(d, out[2][0], out[3][0], r, px, py)
            assert g.keypoints.shape == got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_fuse_seg_model_matches_jax_fused(pairs):
    jm, v, tm = pairs("yolov8n-seg")
    fused = fuse_conv_bn(copy.deepcopy(tm).eval())
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules())
    head = f"l{tm.parsed.head_index}"
    up, up0 = getattr(fused, head).proto_up, getattr(tm, head).proto_up
    assert type(up) is torch.nn.ConvTranspose2d and torch.equal(up.weight, up0.weight)
    ours, scale = load_model_yaml(PAIRS["yolov8n-seg"][0])
    folded = load_jax_variables(TaskModel(ours, scale=scale, nc=3, device="cpu"),
                                flatten_variables(jax_fuse(v))).eval()
    mine = dict(fused.named_modules())
    for key, m in folded.named_modules():
        if isinstance(m, ConvBN):
            f = mine[key]
            for got, want in ((f.conv.weight, m.conv.weight), (f.conv.bias, m.bn.bias)):
                assert (got - want).abs().max() <= 1e-6 * want.abs().max(), key
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, IMGSZ, IMGSZ, 3))
                         .astype(np.float32))
    with torch.no_grad():
        got, want = fused.predictions_full(x), tm.eval().predictions_full(x)
    for key in want:
        assert (got[key] - want[key]).abs().max() <= TOL_REL * want[key].abs().max(), key


@pytest.mark.parametrize("task", ["segment", "pose", "obb"])
def test_yolo_task_facade_round_trip(datasets, tmp_path, task):
    """``YOLO`` of each task on the CPU: one epoch on its PNG set (pose with
    ``device_augment``), ``val`` with the task's metric, ``predict`` with
    masks, keypoints or rotated boxes, then ``info``, ``embed``, ``fuse``,
    a checkpoint saved and loaded, ``reset_weights``."""
    import yaml

    from xlstm_yolo_torch import YOLO

    cfg = {"segment": "yolo11n-seg.yaml", "pose": "yolo11n-pose.yaml",
           "obb": "yolo11n-obb.yaml"}[task]
    kw = {}
    if task == "pose":  # the set's 5 keypoints, as the JAX tests set kpt_shape
        d, _ = load_model_yaml(cfg)
        d.pop("yaml_file")
        d["kpt_shape"] = [5, 3]
        cfg = str(tmp_path / "yolo11n-pose.yaml")
        (tmp_path / "yolo11n-pose.yaml").write_text(yaml.safe_dump(d))
        kw["device_augment"] = True
    data = datasets[task]
    m = YOLO(cfg, device="cpu")
    assert m.task == task
    m.train(data=data, epochs=1, imgsz=IMGSZ, batch=2, plots=False, project=str(tmp_path),
            name="run", **kw)
    metrics = m.val(data=data, imgsz=IMGSZ, batch=4)
    assert {"segment": "mAP50(M)", "pose": "mAP50(P)", "obb": "mAP50"}[task] in metrics
    results = m.predict(str(Path(data).parent / "images" / "val"), imgsz=IMGSZ, conf=0.001,
                        verbose=False)
    field = {"segment": "masks", "pose": "keypoints", "obb": "obb"}[task]
    assert len(results) == 4 and all(len(getattr(r, field)) == len(r) for r in results if len(r))
    assert sum(len(r) for r in results) > 0
    assert m.info().startswith(f"{task} model")
    emb = m.embed(next(iter(sorted((Path(data).parent / "images" / "val").iterdir()))),
                  imgsz=IMGSZ)
    assert emb[0].shape == (3 * (64 + m.model.nc),) and np.isfinite(emb[0]).all()
    path = m.save(tmp_path / "saved.pt")
    m2 = YOLO(str(path), device="cpu")
    assert m2.task == task and m2.model.kpt_shape == m.model.kpt_shape
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, IMGSZ, IMGSZ, 3))
                         .astype(np.float32))
    with torch.no_grad():
        want = m.model.eval().predictions_full(x)
        got = m2.model.eval().predictions_full(x)
        fused = m.fuse().model.predictions_full(x)
    for key in want:
        torch.testing.assert_close(got[key], want[key])
        assert (fused[key] - want[key]).abs().max() <= TOL_REL * want[key].abs().max()
    n = m2.model.num_params()
    m2.reset_weights()
    assert m2.model.num_params() == n and m2.model.task == task

"""Port parity: the ``Validator`` (forward, decode, multi-label NMS at conf
0.001, IoU matching at ten thresholds, 101-point AP) against the JAX
``Validator`` on the CPU.

vil_yolon with 3 classes at 96 px, the same weights on both sides (JAX
init, seeded noise on every parameter and BatchNorm statistic, then
``load_jax_variables``), over the JAX synthetic val split (8 JPEG images,
batch 4). A model fresh from init gives an mAP near zero, which checks
nothing, so, as ``test_yolov8n_val_pipeline_map_parity`` does: the head's
class biases are drawn around -9 (most anchors background, about 150
candidates above conf 0.001 an image), the DFL biases decay over the bins
(boxes of a few strides), and the ground truth is the model's own
confident detections with IoU-diverse jitter, so that AP is high at IoU
0.5 and falls toward 0.95. The port's metric dict within 1e-3 of JAX's
(fp32 on both sides; the forwards differ by summation order), mAP50-95
between 0.2 and 0.95.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from test_torch_model import _perturb
from xlstm_yolo_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from xlstm_yolo_tpu.engine.validator import Validator as JaxValidator
from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_torch.data.dataset import build_dataloader
from xlstm_yolo_torch.engine.validator import Validator
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.ops.nms import non_max_suppression
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables

IMGSZ, NC = 96, 3
KEYS = ("precision", "recall", "mAP50", "mAP50-95", "fitness")


def shape_head(variables, seed):
    """Class biases ~ N(-9, 1) and class weights ~ N(0, 5) (the features
    reaching them are small: about a quarter of the (anchor, class) scores
    above 0.001, a tenth above 0.05); DFL biases that decay over the 16
    bins (so boxes span a few strides), small DFL weights."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        keys = [getattr(k, "key", "") for k in path]
        x = np.asarray(x)
        if keys[-2].startswith("cv3_") and keys[-2].endswith("_2"):
            return (rng.normal(-9.0, 1.0, x.shape) if keys[-1] == "bias"
                    else rng.normal(0, 5.0, x.shape)).astype(x.dtype)
        if keys[-2].startswith("cv2_") and keys[-2].endswith("_2"):
            if keys[-1] == "bias":
                decay = np.tile(np.arange(16) * -0.9, 4)
                return (decay + rng.normal(0, 0.4, x.shape)).astype(x.dtype)
            return rng.normal(0, 0.02, x.shape).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def write_own_labels(model, data_yaml, seed=3):
    """The model's own detections (multi-label, conf 0.05, up to 16 an
    image), jittered, as the val split's labels."""
    loader, _ = build_dataloader(data_yaml, "val", batch=4, imgsz=IMGSZ, augment=False)
    rng = np.random.default_rng(seed)
    for batch in loader:
        with torch.no_grad():
            cands = model.predictions(torch.from_numpy(batch["img"]))
        dets, valid = non_max_suppression(cands, conf_thres=0.05, iou_thres=0.7, max_det=16,
                                          multi_label=True)
        for bi, idx in enumerate(batch["im_idx"]):
            lines = []
            for x1, y1, x2, y2, _, cls in dets[bi][valid[bi]].numpy():
                jx1 = max(0.0, x1 + rng.uniform(-3, 3) - (x2 - x1) * rng.uniform(-0.08, 0.08))
                jy1 = max(0.0, y1 + rng.uniform(-3, 3) - (y2 - y1) * rng.uniform(-0.08, 0.08))
                jx2 = min(IMGSZ, x2 + rng.uniform(-3, 3) + (x2 - x1) * rng.uniform(-0.08, 0.08))
                jy2 = min(IMGSZ, y2 + rng.uniform(-3, 3) + (y2 - y1) * rng.uniform(-0.08, 0.08))
                if jx2 - jx1 >= 2 and jy2 - jy1 >= 2:
                    xywh = ((jx1 + jx2) / 2, (jy1 + jy2) / 2, jx2 - jx1, jy2 - jy1)
                    lines.append(f"{int(cls)} " + " ".join(f"{v / IMGSZ:.6f}" for v in xywh))
            lines = lines or ["1 0.5 0.5 0.25 0.25"]  # an unmatched object: false negatives too
            img = loader.ds.files[int(idx)]
            Path(img.replace("/images/", "/labels/").rsplit(".", 1)[0] + ".txt").write_text(
                "\n".join(lines) + "\n")
    cache = Path(loader.ds.files[0]).parent / "labels_detect.cache.npz"
    cache.unlink(missing_ok=True)


@pytest.fixture(scope="module")
def val_case(tmp_path_factory):
    """(JAX model, JAX variables, port model, dataset YAML) with the
    dataset's val labels taken from the model."""
    root = tmp_path_factory.mktemp("valds")
    data = jax_synthetic(root, n_train=1, n_val=8, imgsz=IMGSZ)
    jm = JaxTaskModel("vil_yolon.yaml", nc=NC, verbose=False)
    v = shape_head(_perturb(jax.jit(lambda: jm.init(0, imgsz=IMGSZ))(), seed=0), seed=7)
    tm = load_jax_variables(TaskModel("vil_yolon.yaml", nc=NC, device="cpu"), flatten_variables(v))
    write_own_labels(tm, data)
    for cache in root.rglob("labels_*.cache.npz"):
        cache.unlink()
    return jm, v, tm, data


def test_validator_map_matches_jax(val_case):
    jm, v, tm, data = val_case
    want = JaxValidator(jm, imgsz=IMGSZ, batch=4)(v, data)
    got = Validator(tm, imgsz=IMGSZ, batch=4)(data)
    assert list(got) == list(want)
    assert got["images"] == want["images"] == 8
    for k in KEYS:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    assert 0.2 <= got["mAP50-95"] <= 0.95 and got["mAP50"] > got["mAP50-95"], got


def test_validator_half_validates_a_bf16_copy(val_case):
    """``half=True`` validates a bf16 copy (the model keeps its fp32
    parameters) and lands near the fp32 metrics."""
    _, _, tm, data = val_case
    half = Validator(tm, imgsz=IMGSZ, batch=4, half=True)(data)
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    full = Validator(tm, imgsz=IMGSZ, batch=4)(data)
    assert abs(half["mAP50"] - full["mAP50"]) <= 0.1 and half["images"] == 8

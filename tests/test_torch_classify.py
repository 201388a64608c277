"""Port parity: the classify task's models, validation and prediction against
the JAX package.

On the CPU, fp32, torch on one thread:

* the blocks, NHWC for JAX and NCHW for the port, on seeded numpy variables
  in the JAX tree's structure (``test_torch_yolo11.seeded_variables``):
  ``ConvBN`` with each activation name of the JAX ``_act``, ``Classify``,
  ``ResNetBlock`` (with and without its shortcut), ``ResNetLayer`` (the stem
  with its padded max pool at an odd size, and n = 2), ``BasicResBlock``
  (with and without ``down``) and ``TorchVision(resnet18)``: eval outputs
  within 1e-4 of their max, and in train mode the outputs and the updated
  BatchNorm statistics too; ``TorchVision`` refuses what the JAX stand-in
  refuses;
* the six ``-cls`` YAMLs and the ViL classifier (``vil_yolo.yaml`` rows 0-9
  at scale n under ``Classify``) built on the meta device (the ViL one on
  the CPU): parameter counts
  equal to the JAX ``TaskModel``'s (``jax.eval_shape``), and yolo11n-cls at
  ImageNet's 1000 classes;
* ``predictions_full`` at 64 px of yolov8n-cls, yolo11n-cls and the ViL
  classifier on the same weights (the port's seeded init, perturbed,
  carried to a JAX tree) within 1e-4; one train-mode forward, the
  cross-entropy and backward of yolo11n-cls and the ViL classifier: the
  loss within 1e-3 and every gradient within 1e-3 (rtol, atol 1e-3 of the
  largest gradient) of the port's fp64 step, and of JAX's within the same
  bound or the two fp32 steps' measured distances from fp64;
* ``Validator`` top-1 and top-5 equal to the JAX ``Validator``'s on a PNG
  class set the port writes, and the predictor's ``Probs`` against the JAX
  ``Predictor``'s on two of its PNGs (both letterbox);
* ``fuse_conv_bn`` on yolov8n-cls: folded as the JAX fuse folds it, the
  fused probabilities equal to the unfused ones within 1e-4;
* ``YOLO("yolo11n-cls.yaml")`` through train / val / predict / info /
  fuse / save / load / reset_weights on the CPU; ``embed`` refuses a
  classify model, as the JAX one fails on its logits.
"""
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_detect_zoo import compiled, jax_task_model  # noqa: F401
from test_torch_yolo11 import assert_close, nchw, nhwc, one_thread, seeded_variables  # noqa: F401
from xlstm_yolo_tpu.cfg import load_model_yaml as jax_load_model_yaml
from xlstm_yolo_tpu.engine.predictor import Predictor as JaxPredictor
from xlstm_yolo_tpu.engine.validator import Validator as JaxValidator
from xlstm_yolo_tpu.nn import modules as JM
from xlstm_yolo_tpu.nn.fuse import fuse_conv_bn as jax_fuse
from xlstm_yolo_tpu.nn.graph import GraphModel as JaxGraphModel
from xlstm_yolo_tpu.nn.graph import parse_model as jax_parse_model
from xlstm_yolo_torch.cfg import load_model_yaml
from xlstm_yolo_torch.data.synthetic import make_classify_dataset
from xlstm_yolo_torch.engine.predictor import Predictor
from xlstm_yolo_torch.engine.validator import Validator
from xlstm_yolo_torch.nn import modules as TM
from xlstm_yolo_torch.nn.fuse import fuse_conv_bn
from xlstm_yolo_torch.nn.graph import GraphModel, parse_model
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils.jax_weights import (
    flatten_variables, load_jax_variables, port_named, torch_name, transposed_convs)

TOL_REL = 1e-4
IMGSZ = 64


def vil_classifier() -> dict:
    """The ViL-YOLO backbone (``vil_yolo.yaml`` rows 0-9) under ``Classify``
    at ImageNet's 1000 classes: the JAX graph builds the same dict."""
    cfg, _ = load_model_yaml("vil_yolon.yaml")
    return {"nc": 1000, "scales": cfg["scales"], "backbone": copy.deepcopy(cfg["backbone"]),
            "head": [[-1, 1, "Classify", ["nc"]]]}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

# (JAX block, port block, input NHWC (batch, size, channels)) by name
BLOCKS = {
    "classify": lambda: (JM.Classify(10), TM.Classify(32, 10), (2, 6, 32)),
    "resnet_block_shortcut": lambda: (JM.ResNetBlock(16, 2), TM.ResNetBlock(32, 16, 2),
                                      (2, 8, 32)),
    "resnet_block_identity": lambda: (JM.ResNetBlock(16, 1), TM.ResNetBlock(64, 16, 1),
                                      (2, 6, 64)),
    "resnet_layer_stem": lambda: (JM.ResNetLayer(16, 1, True, 1),
                                  TM.ResNetLayer(3, 16, 1, True, 1), (2, 17, 3)),
    "resnet_layer_n2": lambda: (JM.ResNetLayer(16, 2, False, 2),
                                TM.ResNetLayer(32, 16, 2, False, 2), (2, 8, 32)),
    "basic_res_block": lambda: (JM.BasicResBlock(32, 1), TM.BasicResBlock(32, 32, 1),
                                (2, 8, 32)),
    "basic_res_block_down": lambda: (JM.BasicResBlock(48, 2), TM.BasicResBlock(32, 48, 2),
                                     (2, 8, 32)),
    "torchvision_resnet18": lambda: (JM.TorchVision(512, "resnet18"),
                                     TM.TorchVision(3, 512, "resnet18"), (2, 64, 3)),
    **{f"convbn_{act}": (lambda act=act: (JM.ConvBN(24, 3, 1, act=act),
                                          TM.ConvBN(16, 24, 3, 1, act=act), (2, 6, 16)))
       for act in ("silu", "relu", "sigmoid", "gelu", "identity", None, False)},
}


def _out_nhwc(t):
    t = t.detach().numpy()
    return t if t.ndim == 2 else t.transpose(0, 2, 3, 1)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name):
    """Eval, then one train-mode forward: its output and the BatchNorm
    statistics it leaves, against ``apply(train=True,
    mutable=["batch_stats"])``. ResNet-18 at 64 px: at 32 px its last
    stage's train-mode BatchNorm normalizes two values a channel, where
    fp32 summation order alone moves the output by 2e-4 of its max."""
    jm, tm, (b, hw, c) = BLOCKS[name]()
    x = nhwc(len(name), b=b, hw=hw, c=c)
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), len(name))
    tm = load_jax_variables(tm, flatten_variables(v)).eval()
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree.leaves(v["params"]))
    with torch.no_grad():
        assert_close(_out_nhwc(tm(nchw(x))), jax.jit(jm.apply)(v, jnp.asarray(x)))
        got = tm.train()(nchw(x))
    want, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    assert_close(_out_nhwc(got), want)
    stats = port_named(flatten_variables(upd["batch_stats"]), "batch_stats")
    state = tm.state_dict()
    for key, arr in stats.items():
        np.testing.assert_allclose(state[key].numpy(), arr, rtol=1e-4, atol=1e-5, err_msg=key)


def test_unknown_activation_and_torchvision_options_are_refused():
    with pytest.raises(ValueError, match="unknown act"):
        TM.ConvBN(8, 8, act="mish")(torch.zeros(1, 8, 4, 4))
    for kw in ({"model": "vgg16"}, {"split": True}, {"unwrap": False}, {"truncate": 1}):
        with pytest.raises(NotImplementedError):
            TM.TorchVision(3, 512, **kw)


# ---------------------------------------------------------------------------
# graphs: parameter counts
# ---------------------------------------------------------------------------

# label -> (model YAML or dict, scale, nc); the JAX count is taken from its own graph
CLS_ZOO = {
    "yolov8n-cls": ("yolov8n-cls.yaml", None, None),
    "yolo11n-cls": ("yolo11n-cls.yaml", None, None),
    "yolo11n-cls-imagenet": ("yolo11n-cls.yaml", None, 1000),
    "yolo12n-cls": ("yolo12n-cls.yaml", None, None),
    "yolo12n-cls-imagenet": ("yolo12n-cls.yaml", None, 1000),
    "yolov8-cls-resnet50": ("yolov8-cls-resnet50.yaml", None, None),
    "yolov8-cls-resnet101": ("yolov8-cls-resnet101.yaml", None, None),
    "yolo11-cls-resnet18": ("yolo11-cls-resnet18.yaml", None, None),
    "yolo11-cls-resnet18-imagenet": ("yolo11-cls-resnet18.yaml", None, 1000),
    "vil-classifier": (None, "n", None),
}
# the JAX counts at each YAML's own nc, or ImageNet's 1000 ("-imagenet", and the ViL
# classifier): chip_smoke.py builds the six at 1000 classes and holds them to these
CLS_PARAMS = {"yolov8n-cls": 2_719_288, "yolo11n-cls": 1_633_584,
              "yolo11n-cls-imagenet": 2_812_104, "yolo12n-cls": 1_820_976,
              "yolo12n-cls-imagenet": 2_999_496, "yolov8-cls-resnet50": 27_413_032,
              "yolov8-cls-resnet101": 46_405_160, "yolo11-cls-resnet18": 11_847_242,
              "yolo11-cls-resnet18-imagenet": 13_115_432, "vil-classifier": 2_913_748}


def _cfgs(label):
    path, scale, nc = CLS_ZOO[label]
    if path is None:
        ours = theirs = vil_classifier()
    else:
        (ours, s), (theirs, _) = load_model_yaml(path), jax_load_model_yaml(path)
        scale = scale or s
    if nc is not None:
        ours, theirs = {**ours, "nc": nc}, {**theirs, "nc": nc}
    return ours, theirs, scale


@pytest.mark.parametrize("label", list(CLS_ZOO))
def test_param_count_matches_jax(label):
    ours, theirs, scale = _cfgs(label)
    vil = CLS_ZOO[label][0] is None  # the ViL layers run on the CPU, not on the meta device
    with torch.device("cpu" if vil else "meta"):
        parsed = parse_model(ours, scale=scale)
        g = GraphModel(parsed).eval()
        with torch.no_grad():
            out = g(torch.zeros(1, 3, *(2 * (64 if vil else 224,))))
    jparsed = jax_parse_model(dict(theirs), ch=3, scale=scale)
    v = jax.eval_shape(lambda: JaxGraphModel(jparsed).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(v["params"]))
    assert parsed.task == jparsed.task == "classify"
    assert sum(p.numel() for p in g.parameters()) == n_jax == CLS_PARAMS[label]
    assert tuple(out.shape) == (1, parsed.nc)


# ---------------------------------------------------------------------------
# whole models against JAX on the same weights
# ---------------------------------------------------------------------------

PAIRS = {"yolov8n-cls": 3, "yolo11n-cls": 3, "vil-classifier": 5}  # label -> nc


def _pair(label, seed=0):
    """(JAX model, JAX variables, port model) on the port's seeded init with
    seeded noise on every tensor, carried to the JAX tree."""
    ours, theirs, scale = _cfgs(label)
    nc = PAIRS[label]
    tm = TaskModel(ours, scale=scale, nc=nc, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for key, t in tm.state_dict().items():
            if key.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            elif t.is_floating_point():
                t.add_(torch.from_numpy(0.05 * rng.normal(size=tuple(t.shape)).astype(np.float32)))
    jm = jax_task_model(theirs, scale, (), nc)
    state, transposed = tm.state_dict(), transposed_convs(tm)

    def leaf(path, sds):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        idx = np.arange(int(np.prod(sds.shape))).reshape(sds.shape)
        port, where = torch_name(key, idx, transposed)
        out = np.empty(idx.size, np.float32)
        out[where.reshape(-1)] = state[port].numpy().reshape(-1)
        return jnp.asarray(out.reshape(sds.shape))

    v = jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(lambda: jm.init(0, imgsz=IMGSZ)))
    assert tm.num_params() == jm.num_params(v) and tm.task == jm.task == "classify"
    assert tm.strides == ()
    return jm, v, tm


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(label):
        if label not in cache:
            cache[label] = _pair(label)
        return cache[label]

    return get


@pytest.mark.parametrize("label", list(PAIRS))
def test_predictions_full_match_jax(pairs, label):
    jm, v, tm = pairs(label)
    x = np.random.default_rng(1).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want = compiled(jm.predictions_full, v, jnp.asarray(x))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval().predictions_full(torch.from_numpy(x))
    assert set(got) == set(want) == {"probs"}
    assert_close(got["probs"].numpy(), want["probs"])
    np.testing.assert_allclose(got["probs"].sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("label", ["yolo11n-cls", "vil-classifier"])
def test_train_step_loss_and_grads_match_jax(pairs, label):
    jm, v, tm = pairs(label)
    rng = np.random.default_rng(2)
    batch = {"img": rng.uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32),
             "label": rng.integers(0, tm.nc, 2).astype(np.int64)}
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
        total, aux = m.loss({"img": torch.from_numpy(batch["img"]).to(dtype),
                             "label": torch.from_numpy(batch["label"])})
        total.backward()
        grads[dtype] = {key: p.grad.double().numpy() for key, p in m.named_parameters()}
        if dtype == torch.float32:
            np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-3)
            assert set(aux) == set(jaux) == {"cls"}
    want = port_named(flatten_variables(jgrads), transposed=transposed_convs(tm))
    exact = grads[torch.float64]
    gmax = max(np.abs(g).max() for g in exact.values())

    def dist(a, b):  # the worst element, in units of the 1e-3 bound
        return max((np.abs(a[k] - b[k]) / (1e-3 * np.abs(b[k]) + 1e-3 * gmax)).max() for k in b)

    port_err, jax_err = dist(grads[torch.float32], exact), dist(want, exact)
    print(label, f"port fp32 {port_err:.3f}, JAX fp32 {jax_err:.3f} of the bound from fp64")
    assert port_err <= 1.0
    assert dist(grads[torch.float32], want) <= max(1.0, port_err + jax_err)


@pytest.fixture(scope="module")
def classify_set(tmp_path_factory):
    return make_classify_dataset(tmp_path_factory.mktemp("cls") / "set", n_train=2, n_val=6)


def test_validator_accuracy_matches_jax(pairs, classify_set):
    """Both validators on the same weights and PNGs: top-1 and top-5 equal,
    the images counted; a second set of weights where the top-1 is not the
    uniform guess's."""
    jm, v, tm = pairs("yolov8n-cls")
    keys = ("accuracy_top1", "accuracy_top5", "fitness", "images")
    for bias in (0.0, 3.0):  # lift class 1: its 6 images right, the other 12 wrong
        t, jv = copy.deepcopy(tm), v
        if bias:
            with torch.no_grad():
                t.l9.linear.bias[1] += bias
            jv = jax.tree_util.tree_map_with_path(
                lambda p, a: a.at[1].add(bias) if [getattr(k, "key", "") for k in p][-2:] == [
                    "linear", "bias"] else a, v)
        want = JaxValidator(jm, imgsz=IMGSZ, batch=4)(jv, classify_set)
        got = Validator(t, imgsz=IMGSZ, batch=4)(classify_set)
        print(bias, {k: (got[k], want[k]) for k in keys})
        for k in keys:
            assert got[k] == want[k], (k, got[k], want[k])
    assert got["images"] == 18 and abs(got["accuracy_top1"] - 1 / 3) < 1e-12


def test_predictor_probs_match_jax(pairs, classify_set):
    jm, v, tm = pairs("yolo11n-cls")
    files = [str(f) for f in sorted((Path(classify_set) / "val" / "rect").iterdir())[:2]]
    names = {0: "circle", 1: "rect", 2: "triangle"}
    tm = copy.deepcopy(tm)
    tm.names = jm.names = names
    got = Predictor(tm.eval(), imgsz=IMGSZ, verbose=False)(files)
    want = JaxPredictor(jm, v, imgsz=IMGSZ, verbose=False)(files)
    for g, w in zip(got, want, strict=True):
        assert g.boxes is None and len(g) == len(w) == 0
        assert_close(g.probs.data, np.asarray(w.probs.data))
        assert g.probs.top1 == w.probs.top1 and g.probs.top5 == w.probs.top5
        np.testing.assert_allclose(g.probs.top5conf, np.asarray(w.probs.top5conf), rtol=1e-4)
        assert g.summary()[0]["name"] == w.summary()[0]["name"] == names[g.probs.top1]
        assert g.verbose().split(" ")[0] == w.verbose().split(" ")[0]


def test_fuse_cls_model_matches_jax_fused(pairs):
    jm, v, tm = pairs("yolov8n-cls")
    fused = fuse_conv_bn(copy.deepcopy(tm).eval())
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules())
    ours, _, scale = _cfgs("yolov8n-cls")
    folded = load_jax_variables(TaskModel(ours, scale=scale, nc=3, device="cpu"),
                                flatten_variables(jax_fuse(v))).eval()
    mine = dict(fused.named_modules())
    for key, m in folded.named_modules():
        if isinstance(m, TM.ConvBN):
            f = mine[key]
            for got, want in ((f.conv.weight, m.conv.weight), (f.conv.bias, m.bn.bias)):
                assert (got - want).abs().max() <= 1e-6 * want.abs().max(), key
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, IMGSZ, IMGSZ, 3))
                         .astype(np.float32))
    with torch.no_grad():
        got, want = fused.predictions_full(x)["probs"], tm.eval().predictions_full(x)["probs"]
    assert (got - want).abs().max() <= TOL_REL * want.abs().max()


def test_yolo_classify_facade_round_trip(classify_set, tmp_path):
    """``YOLO("yolo11n-cls.yaml")`` on the CPU: two epochs at the defaults
    (bf16 AMP, RandAugment, erasing) and ``multi_scale`` (32 and 64 px at
    stride 32: a classify model has no strides) on the PNG set, the model
    rebuilt to its 3 classes; ``val``; ``predict`` with ``Probs``;
    ``info``; ``embed`` refused; ``fuse``; a checkpoint saved and loaded;
    ``reset_weights``."""
    from xlstm_yolo_torch import YOLO

    m = YOLO("yolo11n-cls.yaml", device="cpu")
    assert m.task == "classify" and m.model.nc == 80
    metrics = m.train(data=classify_set, epochs=2, imgsz=32, batch=2, plots=False,
                      multi_scale=True, project=str(tmp_path), name="run")
    assert m.trainer._ms_sizes_used <= {32, 64} and m.model.nc == 3
    assert m.names == {0: "circle", 1: "rect", 2: "triangle"}
    assert set(metrics) >= {"accuracy_top1", "accuracy_top5", "fitness"}
    assert (tmp_path / "run" / "last.pt").exists()
    assert "metrics/accuracy_top1" in (tmp_path / "run" / "results.csv").read_text()
    val = m.val(data=classify_set, imgsz=32, batch=4)
    assert val["images"] == 18 and val["accuracy_top5"] == 1.0
    results = m.predict(str(Path(classify_set) / "val" / "circle"), imgsz=32, verbose=False)
    assert len(results) == 6 and all(r.probs.data.shape == (3,) and r.boxes is None
                                     for r in results)
    assert m.info().startswith("classify model")
    with pytest.raises(ValueError, match="classify"):
        m.embed(str(Path(classify_set) / "val" / "circle" / "0000.png"), imgsz=32)
    path = m.save(tmp_path / "saved.pt")
    m2 = YOLO(str(path), device="cpu")
    assert m2.task == "classify" and m2.names == m.names
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 32, 32, 3))
                         .astype(np.float32))
    with torch.no_grad():
        want = m.model.eval().predictions_full(x)["probs"]
        torch.testing.assert_close(m2.model.eval().predictions_full(x)["probs"], want)
        fused = m.fuse().model.predictions_full(x)["probs"]
    assert (fused - want).abs().max() <= TOL_REL * want.abs().max()
    n = m2.model.num_params()
    m2.reset_weights()
    assert m2.model.num_params() == n and m2.model.task == "classify"

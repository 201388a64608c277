"""Port parity: YOLO-World (``xlstm_yolo_torch/nn/world.py``,
``nn/clip_text.py``, ``data/multimodal.py``, the world task), ``NAS`` and
``FastSAM`` against the JAX package.

On the CPU, fp32, torch on one thread. Tolerances: token ids equal;
forward outputs and losses within 1e-5 of their max (``TOL_FWD``);
gradients within 1e-4 of each tensor's max (``TOL_GRAD``; a tensor that
is zero up to rounding, below 1e-6 of the module's largest gradient, is
held to that largest gradient).

* the blocks, NHWC for JAX and NCHW for the port, on seeded numpy
  variables in the JAX tree's structure loaded through
  ``load_jax_variables``, forward and the gradients of every parameter and
  input: ``ContrastiveHead``, ``BNContrastiveHead`` (eval, and train with
  the running statistics it leaves), ``ImagePoolingAttn`` with and without
  ``use_scale`` (its maps with constant regions, so pooled maxima tie),
  ``MaxSigmoidAttnBlock`` and ``C2fAttn`` on a guide whose padded slots
  share one embedding (the max over texts ties on them, and the guide's
  gradient splits as JAX's), ``WorldDetect`` with either contrastive
  head; ``adaptive_max_pool``'s gradient on tied bins;
* a tiny ``yolov8-world`` and ``yolov8-worldv2`` (the YAMLs' rows at width
  1/16, 3 classes): ``predictions`` on JAX's default guide and after
  ``set_classes``; the train-mode ``loss`` with a per-batch ``txt_feats``
  holding padded slots: the loss and its box / cls / dfl terms within
  ``TOL_MODEL`` = 1e-4 and every gradient within ``TOL_MODEL_GRAD`` =
  1e-3, as the repo's other whole-detector train steps
  (``test_torch_yolo11.py``): in train mode the BatchNorms of a random
  graph on two small images amplify fp32 rounding, so that each package
  lies up to 1.5e-5 (loss) and 1.1e-3 (gradients at 64 px; 1.3e-4 at the
  128 px used here) from an fp64 evaluation of the port;
* the ten world counts and the three NAS counts (the port's graph on the
  meta device against ``WORLD_COUNTS``, the JAX ``eval_shape`` counts),
  and at each YAML's first scale its keys and shapes against the JAX
  ``eval_shape`` tree;
* the tokenizer against the JAX ``SimpleTokenizer`` (which runs on the
  ``regex`` package) on merge files the test writes, gzip and plain: the
  word split of every character Python's Unicode tables assign, and the
  ids of hard strings (fractions, Roman numerals, superscripts, U+001C,
  combining marks, CJK, Arabic digits, emoji, ``&amp;``, contractions and
  the long s, the specials), framing and truncation;
* ``CLIPTextTower`` and ``ClipTextEncoder`` on JAX's weights, both
  checkpoint loaders on dicts the test builds, ``from_openai_checkpoint``;
* ``RandomLoadText`` seeded, draw for draw; ``MultiModalDataset``'s
  batches through both ``build_dataloader``s; ``GroundingDataset``;
* the ``Trainer`` with a ``text_encoder`` for one epoch, and ``YOLO`` on a
  tiny world YAML: ``val`` against the JAX ``Validator`` (one class, so
  the val loader's unseeded text remap is the identity), ``predict``,
  ``embed``, save and reload (the default guide comes back, as in JAX);
* ``NAS`` and ``FastSAM`` (``tests/test_models_extra.py``'s prompt and
  mask-association cases, and ``everything``).
"""
import copy
import gzip
import json
import unicodedata

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from test_torch_detect_zoo import compiled, jax_task_model
from test_torch_yolo11 import nchw, one_thread, seeded_variables  # noqa: F401
from xlstm_yolo_tpu.cfg import load_model_yaml as jax_load_model_yaml
from xlstm_yolo_tpu.data import multimodal as JMM
from xlstm_yolo_tpu.data.dataset import build_dataloader as jax_build_dataloader
from xlstm_yolo_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from xlstm_yolo_tpu.nn import clip_text as JC
from xlstm_yolo_tpu.nn import heads as JH
from xlstm_yolo_tpu.nn import world as JW
from xlstm_yolo_torch import YOLO
from xlstm_yolo_torch.cfg import load_model_yaml
from xlstm_yolo_torch.data import multimodal as TMM
from xlstm_yolo_torch.data.dataset import build_dataloader
from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset
from xlstm_yolo_torch.engine.trainer import Trainer
from xlstm_yolo_torch.models_extra import FastSAM
from xlstm_yolo_torch.models_nas import NAS
from xlstm_yolo_torch.nn import clip_text as TC
from xlstm_yolo_torch.nn import world as TW
from xlstm_yolo_torch.nn.graph import NOT_PORTED, GraphModel, parse_model
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.ops.nms import non_max_suppression
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables, port_named

TOL_FWD = 1e-5
TOL_GRAD = 1e-4
TOL_MODEL = 1e-4  # a whole graph's train-mode loss (module docstring)
TOL_MODEL_GRAD = 1e-3  # and its gradients

# the JAX TaskModel's parameters (jax.eval_shape of its init, 80 classes)
WORLD_COUNTS = {
    "yolov8-world.yaml": dict(n=6_032_922, s=16_285_258, m=31_844_922, l=49_391_786,
                              x=74_598_426),
    "yolov8-worldv2.yaml": dict(n=5_931_418, s=16_006_986, m=31_353_018, l=48_669_866,
                                x=73_552_282),
    "yolo_nas.yaml": dict(s=11_343_216, m=20_274_192, l=36_504_368),
}


def assert_close(got, want, tol=TOL_FWD, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    err, scale = np.abs(got - want).max(initial=0.0), np.abs(want).max(initial=0.0)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def nhwc_of(t):
    """A port output in the JAX layout (NCHW maps to NHWC), as a list of
    tensors still on the tape."""
    return [t.permute(0, 2, 3, 1) if t.ndim == 4 else t]


def world_head_of(outs):
    """``WorldDetect``'s (box, cls) pairs -> the JAX head's NHWC maps."""
    return [torch.cat(pair, 1).permute(0, 2, 3, 1) for pair in outs]


def tied_guide(seed, b=2, nt=6, c=32, pad=3):
    """(b, nt, c) text embeddings whose last ``pad`` slots are one shared
    vector, as the padded slots of a MultiModalDataset batch."""
    g = np.random.default_rng(seed).normal(size=(b, nt, c)).astype(np.float32)
    g[:, nt - pad:] = g[:, nt - pad:nt - pad + 1]
    return g


def check_grads(tm, want: dict, tol: float = TOL_GRAD) -> None:
    """Every parameter's gradient within ``tol`` of its own max. A tensor
    that is zero up to rounding (its max below 1e-6 of the module's
    largest gradient, the rule of ``chip_smoke.grad_errors``: the key
    LayerNorm's bias before a softmax has no gradient in exact arithmetic)
    is held to the module's largest gradient instead."""
    gmax = max(np.abs(w).max() for w in want.values())
    for name, p in tm.named_parameters():
        w = want[name]
        scale = np.abs(w).max()
        err = np.abs(p.grad.numpy().astype(np.float64) - w).max()
        assert err <= tol * (scale if scale >= 1e-6 * gmax else gmax), f"{name}: {err} / {scale}"


def check_vjp(jm, tm, jargs, targs, seed, jkw=None, layout=nhwc_of, train=False):
    """The JAX module and its port on the same seeded variables: forward
    (eval, or train with the running statistics it leaves) and the
    gradients of sum(out * r), r a seeded cotangent, with respect to every
    parameter and every input (``targs``: tensors or lists of them, NCHW
    where the JAX ones are NHWC)."""
    jkw = jkw or {}
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), *jargs, **jkw), seed)
    tm = load_jax_variables(tm, flatten_variables(v))
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree.leaves(v["params"]))
    tm.train(train)
    kw = {**jkw, **({"train": True} if train else {})}

    def jfwd(params, args):
        if train:
            return jm.apply({**v, "params": params}, *args, **kw, mutable=["batch_stats"])
        return jm.apply({**v, "params": params}, *args, **kw), {}

    want, jstats = jax.jit(jfwd)(v["params"], jargs)
    leaves = [np.asarray(a) for a in jax.tree.leaves(want)]
    rs = [np.random.default_rng(seed + 100 + i).normal(size=a.shape).astype(np.float32)
          for i, a in enumerate(leaves)]

    def jobj(params, args):
        out, _ = jfwd(params, args)
        return sum(jnp.sum(a * r) for a, r in zip(jax.tree.leaves(out), rs))

    jgp, jga = jax.jit(jax.grad(jobj, argnums=(0, 1)))(v["params"], jargs)
    tin = [[u.clone().requires_grad_(True) for u in t] if isinstance(t, list)
           else t.clone().requires_grad_(True) for t in targs]
    got = layout(tm(*tin))
    assert len(got) == len(leaves)
    for g, w in zip(got, leaves):
        assert_close(g.detach().numpy(), w, what="forward")
    sum((g * torch.from_numpy(r)).sum() for g, r in zip(got, rs)).backward()
    want_p = port_named(flatten_variables(jgp))
    check_grads(tm, want_p)
    flat_in = [t for x in tin for t in (x if isinstance(x, list) else [x])]
    for i, (t, a) in enumerate(zip(flat_in, jax.tree.leaves(jga), strict=True)):
        g = t.grad.numpy()
        assert_close(g.transpose(0, 2, 3, 1) if g.ndim == 4 else g, a, TOL_GRAD, f"input {i}")
    if train:
        state = tm.state_dict()
        for name, a in port_named(flatten_variables(jstats["batch_stats"]),
                                  "batch_stats").items():
            assert_close(state[name].numpy(), a, TOL_FWD, name)
    return tm, v


# --- the blocks ---


def _x(seed, b=2, hw=6, c=16):
    return np.random.default_rng(seed).normal(size=(b, hw, hw, c)).astype(np.float32)


@pytest.mark.parametrize("bt", [1, 2], ids=["guide-b1", "guide-b2"])
def test_contrastive_head_matches_jax(bt):
    x, txt = _x(1), tied_guide(2, b=bt, c=16)
    check_vjp(JW.ContrastiveHead(), TW.ContrastiveHead(), (jnp.asarray(x), jnp.asarray(txt)),
              (nchw(x), torch.from_numpy(txt)), 3)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bn_contrastive_head_matches_jax(train):
    x, txt = _x(4), tied_guide(5, c=16)
    check_vjp(JW.BNContrastiveHead(), TW.BNContrastiveHead(16),
              (jnp.asarray(x), jnp.asarray(txt)), (nchw(x), torch.from_numpy(txt)), 6,
              train=train)


def test_adaptive_max_pool_splits_tied_gradients_as_jax():
    """Bins over constant regions tie everywhere: the gradient splits
    evenly, as ``jax.grad`` of ``jnp.max``."""
    x = _x(7, hw=7, c=3)
    x[:, :4, :4] = 0.5  # whole bins constant
    x[:, 5:, 2:5] = -1.0
    r = np.random.default_rng(8).normal(size=(2, 3, 3, 3)).astype(np.float32)
    want = jax.jit(jax.grad(lambda a: jnp.sum(JW._adaptive_max_pool(a, 3) * r)))(jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    out = TW.adaptive_max_pool(xt, 3)  # (B, 9, C)
    assert_close(out.detach().numpy(), np.asarray(JW._adaptive_max_pool(jnp.asarray(x), 3)
                                                  ).reshape(2, 9, 3))
    (out * torch.from_numpy(r.reshape(2, 9, 3))).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), want, rtol=1e-6,
                               atol=1e-7)
    assert (np.asarray(want)[0, :2, :2, 0] != 0).all()  # a four-way tie, split


@pytest.mark.parametrize("use_scale", [False, True], ids=["plain", "scale"])
def test_image_pooling_attn_matches_jax(use_scale):
    feats = [_x(9, hw=8, c=8), _x(10, hw=4, c=16), _x(11, hw=2, c=16)]
    feats[0][:, :3, :3] = 0.25  # a constant region: the pooled maxima tie
    txt = tied_guide(12, b=1, nt=5, c=32)
    jm = JW.ImagePoolingAttn(ec=16, ct=32, nh=4, k=3, use_scale=use_scale)
    tm = TW.ImagePoolingAttn((8, 16, 16), ec=16, ct=32, nh=4, k=3, use_scale=use_scale, gc=32)
    check_vjp(jm, tm, ([jnp.asarray(f) for f in feats], jnp.asarray(txt)),
              ([nchw(f) for f in feats], torch.from_numpy(txt)), 13)


@pytest.mark.parametrize("c1", [16, 24], ids=["c1-eq-ec", "c1-ne-ec"])
def test_max_sigmoid_attn_block_ties_like_jax(c1):
    """The padded slots tie in the max over texts: the guide's gradient on
    them splits as JAX's (``check_vjp`` holds the input gradients)."""
    x, g = _x(14, c=c1), tied_guide(15, nt=6, c=32, pad=3)
    tm = TW.MaxSigmoidAttnBlock(c1, 16, nh=2, ec=16, gc=32)
    tm, v = check_vjp(JW.MaxSigmoidAttnBlock(16, nh=2, ec=16), tm,
                      (jnp.asarray(x), jnp.asarray(g)), (nchw(x), torch.from_numpy(g)), 16)
    # the ties are exact in both: equal embeddings give equal dot products
    emb = (tm.ec(nchw(x)) if tm.ec is not None else nchw(x)).detach()
    gl = torch.nn.functional.linear(torch.from_numpy(g), tm.gl.weight, tm.gl.bias).detach()
    aw = torch.einsum("bchw,btc->bhwt", emb[:, :8], gl[..., :8])
    assert (aw[..., 3] == aw[..., 5]).all()


def test_c2f_attn_matches_jax():
    x, g = _x(17, c=16), tied_guide(18, nt=5, c=32, pad=2)
    check_vjp(JW.C2fAttn(24, n=2, ec=16, nh=2), TW.C2fAttn(16, 24, n=2, ec=16, nh=2, gc=32),
              (jnp.asarray(x), jnp.asarray(g)), (nchw(x), torch.from_numpy(g)), 19)


@pytest.mark.parametrize("with_bn", [False, True], ids=["cosine", "bn"])
def test_world_detect_head_matches_jax(with_bn):
    feats = [_x(20, hw=8, c=16), _x(21, hw=4, c=24)]
    txt = tied_guide(22, b=1, nt=4, c=32, pad=2)
    jm = JW.WorldDetectHead(embed_dim=32, ch=(16, 24), with_bn=with_bn)
    tm = TW.WorldDetect(32, ch=(16, 24), with_bn=with_bn)
    check_vjp(jm, tm, ([jnp.asarray(f) for f in feats], jnp.asarray(txt)),
              ([nchw(f) for f in feats], torch.from_numpy(txt)), 23, layout=world_head_of)


def test_bf16_serving_promotes_as_jax():
    """bf16 parameters and input with an fp32 guide: ``C2fAttn`` and
    ``ContrastiveHead`` return float32 in both packages;
    ``BNContrastiveHead`` on a bf16 map with bf16 parameters stays bf16 (it
    casts the texts down)."""
    x, g = _x(24, c=16), tied_guide(25, nt=4, c=32, pad=2)
    bf = lambda tree: jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)  # noqa: E731
    cases = [(JW.C2fAttn(16, n=1, ec=16, nh=2), TW.C2fAttn(16, 16, n=1, ec=16, nh=2, gc=32),
              x, g),
             (JW.ContrastiveHead(), TW.ContrastiveHead(), _x(26, c=32), g),
             (JW.BNContrastiveHead(), TW.BNContrastiveHead(32), _x(27, c=32), g)]
    for jm, tm, xi, gi in cases:
        v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(xi),  # noqa: B023
                                             jnp.asarray(gi)), 28)  # noqa: B023
        load_jax_variables(tm, flatten_variables(v)).eval()
        for p in tm.parameters():
            p.data = p.data.to(torch.bfloat16)
        want = jax.jit(jm.apply)({**v, "params": bf(v["params"])},
                                 jnp.asarray(xi, jnp.bfloat16), jnp.asarray(gi))
        with torch.no_grad():
            got = tm(nchw(xi).to(torch.bfloat16), torch.from_numpy(gi))
        assert str(got.dtype).split(".")[-1] == str(want.dtype), type(tm).__name__
        assert_close(got.float().permute(0, 2, 3, 1).numpy(), np.asarray(want, np.float32),
                     2e-2, type(tm).__name__)


# --- the graphs ---


def tiny_cfg(name):
    """The YAML's rows at width 1/16 (its own scales replaced), 3 classes."""
    cfg, _ = load_model_yaml(name)
    return {**cfg, "nc": 3, "scales": {"t": [0.33, 0.0625, 1024]}}


@pytest.fixture(scope="module", params=["yolov8-world.yaml", "yolov8-worldv2.yaml"])
def tiny_pair(request):
    """(JAX model, its variables, port model): the JAX model's default
    guide handed to the port (torch cannot draw ``jax.random``'s)."""
    cfg = tiny_cfg(request.param)
    jm = jax_task_model(cfg, "t", (8, 16, 32))
    jm.txt_feats = jax.random.normal(jax.random.PRNGKey(0), (1, 3, 512))
    assert jm.task == "world"
    v = seeded_variables(lambda: jm.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                                train=False, guide=jm.txt_feats), 0)
    tm = TaskModel(cfg, scale="t", device="cpu")
    assert tm.task == "world" and tm.strides == (8, 16, 32) and tuple(tm.txt_feats.shape) == (
        1, 3, 512)
    tm.txt_feats = torch.from_numpy(np.array(jm.txt_feats))
    load_jax_variables(tm, flatten_variables(v)).eval()
    return jm, v, tm


def test_tiny_graph_predictions_match_jax(tiny_pair):
    """On the default guide, then after ``set_classes`` (three other
    vectors, normalized)."""
    jm, v, tm = tiny_pair

    def jpred(v, x, guide):
        return JH.decode_detections(jm.module.apply(v, x, train=False, guide=guide),
                                    jm.strides, 3, 16)

    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    f = compiled(jpred, v, jnp.asarray(x), jm.txt_feats)
    with torch.no_grad():
        got = tm.predictions(torch.from_numpy(x))
    assert got.shape == (2, 84, 7)
    assert_close(got.numpy(), f(v, jnp.asarray(x), jm.txt_feats), what="default guide")
    emb = np.random.default_rng(2).normal(size=(3, 512)).astype(np.float32) * 3
    jm2 = copy.copy(jm)
    jm2.set_classes(emb)
    tm2 = copy.deepcopy(tm)
    tm2.set_classes(emb)
    assert tm2.nc == jm2.nc == 3 and tm2.names == jm2.names
    assert_close(tm2.txt_feats.numpy(), jm2.txt_feats, what="set_classes")
    with torch.no_grad():
        got = tm2.predictions(torch.from_numpy(x))
    assert_close(got.numpy(), f(v, jnp.asarray(x), jm2.txt_feats), what="set_classes guide")
    with pytest.raises(ValueError, match="no text encoder"):
        tm2.set_classes(["cat"])


def test_tiny_graph_loss_and_grads_match_jax(tiny_pair):
    """Train mode at 128 px with a per-batch guide (B, 4, 512) whose last
    two slots are padding: the loss (nc the guide's 4), its terms and every
    gradient, within the whole-graph tolerances (module docstring)."""
    jm, v, tm = tiny_pair
    imgs = np.random.default_rng(3).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    cb = np.zeros((2, 8, 5), np.float32)
    mask = np.zeros((2, 8), bool)
    cb[0, :2] = [[1, 20, 20, 80, 100], [0, 60, 10, 120, 60]]
    cb[1, :1] = [[1, 4, 40, 60, 124]]
    mask[0, :2] = mask[1, :1] = True
    txt = tied_guide(4, b=2, nt=4, c=512, pad=2)
    jb = {"img": jnp.asarray(imgs), "cls_boxes": jnp.asarray(cb), "mask": jnp.asarray(mask),
          "txt_feats": jnp.asarray(txt)}

    def jloss(params, b):
        (total, aux), _ = jm.loss({"params": params, "batch_stats": v["batch_stats"]}, b,
                                  train=True)
        return total, aux

    (jtotal, jaux), jgrads = compiled(jax.value_and_grad(jloss, has_aux=True), v["params"],
                                      jb)(v["params"], jb)
    tmt = copy.deepcopy(tm).train()
    total, aux = tmt.loss({"img": torch.from_numpy(imgs), "cls_boxes": torch.from_numpy(cb),
                           "mask": torch.from_numpy(mask), "txt_feats": torch.from_numpy(txt)})
    total.backward()
    assert_close(float(total.detach()), float(jtotal), TOL_MODEL, what="loss")
    for k in ("box", "cls", "dfl"):
        assert_close(float(aux[k].detach()), float(jaux[k]), TOL_MODEL, what=k)
    check_grads(tmt, port_named(flatten_variables(jgrads)), TOL_MODEL_GRAD)


@pytest.mark.parametrize("name", list(WORLD_COUNTS))
def test_yaml_counts_and_trees_match_jax(name):
    """Every scale's count on the meta device; the first scale's keys and
    shapes against the JAX ``eval_shape`` tree."""
    cfg, _ = load_model_yaml(name)
    for scale, count in WORLD_COUNTS[name].items():
        with torch.device("meta"):
            g = GraphModel(parse_model(cfg, scale=scale))
        assert sum(p.numel() for p in g.parameters()) == count, scale
    scale = next(iter(WORLD_COUNTS[name]))
    jcfg, _ = jax_load_model_yaml(name)
    jm = jax_task_model(jcfg, scale, (8, 16, 32))
    guide = jnp.zeros((1, 80, 512)) if jm.task == "world" else None
    tree = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                                 train=False, guide=guide))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree["params"])
    want = {k: a.shape for k, a in port_named(flatten_variables(zeros)).items()}
    with torch.device("meta"):
        g = GraphModel(parse_model(cfg, scale=scale))
    assert {k: tuple(p.shape) for k, p in g.named_parameters()} == want
    assert sum(int(np.prod(s)) for s in want.values()) == WORLD_COUNTS[name][scale]
    assert not {"C2fAttn", "WorldDetect", "ImagePoolingAttn"} & set(NOT_PORTED)


# --- the text tower ---

MERGES = [("h", "e</w>"), ("l", "l"), ("ll", "o</w>"), ("c", "a"), ("ca", "t</w>"), ("d", "o"),
          ("do", "g</w>"), ("t", "h"), ("th", "e</w>"), ("p", "e"), ("pe", "r"), ("per", "s"),
          ("pers", "o"), ("perso", "n</w>"), ("b", "u"), ("bu", "s</w>"), ("e", "r"),
          ("o", "n</w>"), ("'", "s</w>"), ("Ã", "©"), ("ä", "¸"), ("&", "amp</w>")]

HARD = ["x½y Ⅳ²", "a\x1cb\x1d c\x1f", "école aͅb ̀x", "中文字符 漢字",
        "١٢٣ ٤٥", "🙂👍🏽 ok", "&amp; &amp;amp; &lt;", "it's we're I'VE they'll 'd 'ſ",
        "<|startoftext|>the cat<|endoftext|>", "  PERSON　riding a horse  ",
        "ⓐⒶ ǅ ʰ ㆒ 〇", "der Straße", "hello the dog", "x\u0085y​z"]


@pytest.fixture(scope="module")
def merge_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    text = "\n".join(["#version: test"] + [f"{a} {b}" for a, b in MERGES]) + "\n"
    (d / "bpe.txt").write_text(text, encoding="utf-8")
    with gzip.open(d / "bpe.txt.gz", "wt", encoding="utf-8") as f:
        f.write(text)
    return d / "bpe.txt", d / "bpe.txt.gz"


def test_word_split_matches_jax_on_every_assigned_character(merge_files):
    """The JAX pattern (``regex``) and the port's scanner on every
    character Python's tables assign, in runs and one at a time."""
    jt = JC.SimpleTokenizer(merge_files[0], n_merges=None)
    chars = [chr(c) for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF
             and unicodedata.category(chr(c)) != "Cn"]
    runs = "".join(chars)
    assert TC.split_words(runs) == jt.pat.findall(runs)
    spaced = " ".join(chars[::7])  # each class's characters alone as well
    assert TC.split_words(spaced) == jt.pat.findall(spaced)
    for s in HARD:
        assert TC.split_words(s) == jt.pat.findall(s), s
        assert TC._clean(s) == JC._clean(s), s


@pytest.mark.parametrize("which", [0, 1], ids=["plain", "gzip"])
def test_tokenizer_ids_match_jax(merge_files, which):
    jt = JC.SimpleTokenizer(merge_files[which], n_merges=None)
    tt = TC.SimpleTokenizer(merge_files[which], n_merges=None)
    assert tt.encoder == jt.encoder and tt.bpe_ranks == jt.bpe_ranks
    assert tt.vocab_size == jt.vocab_size and (tt.sot, tt.eot) == (jt.sot, jt.eot)
    for s in HARD:
        assert tt.encode(s) == jt.encode(s), s
        assert tt.decode(tt.encode(s)) == jt.decode(jt.encode(s)), s
    long = " ".join(["person"] * 40)
    np.testing.assert_array_equal(tt(HARD + [long], context_length=16),
                                  jt(HARD + [long], context_length=16))
    got = tt([long], context_length=16)
    assert got[0, -1] == tt.eot and (got[0] > 0).all()  # cut to the context, EOT last
    with pytest.raises(ValueError, match="too long"):
        tt([long], context_length=16, truncate=False)
    assert TC.SimpleTokenizer(merge_files[which], n_merges=5).vocab_size == 512 + 5 + 2


def _tower_pair(seed=0, **kw):
    cfg = dict(vocab_size=600, context_length=16, width=64, heads=4, layers=2, embed_dim=32)
    cfg.update(kw)
    jm = JC.CLIPTextTower(**cfg)
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)),
                         seed)
    tm = load_jax_variables(TC.CLIPTextTower(**cfg), flatten_variables(v)).eval()
    return jm, v, tm


def _tokens(seed=1):
    t = np.random.default_rng(seed).integers(1, 500, (3, 16)).astype(np.int32)
    for i, p in enumerate((4, 9, 15)):
        t[i, p] = 599  # EOT: the row's largest id
        t[i, p + 1:] = 0
    return t


def test_text_tower_matches_jax():
    jm, v, tm = _tower_pair()
    tok = _tokens()
    want = jax.jit(jm.apply)(v, jnp.asarray(tok))
    with torch.no_grad():
        got = tm(torch.from_numpy(tok))
    assert_close(got.numpy(), want, what="features")


def _openai_dict(seed=2, vocab=600, ctx=16, width=64, layers=2, embed=32):
    rng = np.random.default_rng(seed)
    r = lambda *s: (0.1 * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    sd = {"token_embedding.weight": r(vocab, width), "positional_embedding": r(ctx, width),
          "text_projection": r(width, embed), "ln_final.weight": 1 + r(width),
          "ln_final.bias": r(width)}
    for i in range(layers):
        p = f"transformer.resblocks.{i}"
        sd.update({f"{p}.ln_1.weight": 1 + r(width), f"{p}.ln_1.bias": r(width),
                   f"{p}.ln_2.weight": 1 + r(width), f"{p}.ln_2.bias": r(width),
                   f"{p}.attn.in_proj_weight": r(3 * width, width),
                   f"{p}.attn.in_proj_bias": r(3 * width),
                   f"{p}.attn.out_proj.weight": r(width, width), f"{p}.attn.out_proj.bias": r(width),
                   f"{p}.mlp.c_fc.weight": r(4 * width, width), f"{p}.mlp.c_fc.bias": r(4 * width),
                   f"{p}.mlp.c_proj.weight": r(width, 4 * width),
                   f"{p}.mlp.c_proj.bias": r(width)})
    return sd


def _hf_of(sd, layers=2):
    """The same weights in ``transformers``' naming."""
    tm = "text_model."
    hf = {tm + "embeddings.token_embedding.weight": sd["token_embedding.weight"],
          tm + "embeddings.position_embedding.weight": sd["positional_embedding"],
          tm + "final_layer_norm.weight": sd["ln_final.weight"],
          tm + "final_layer_norm.bias": sd["ln_final.bias"],
          "text_projection.weight": sd["text_projection"].T}
    for i in range(layers):
        p, q = f"{tm}encoder.layers.{i}", f"transformer.resblocks.{i}"
        for n in ("weight", "bias"):
            hf[f"{p}.layer_norm1.{n}"] = sd[f"{q}.ln_1.{n}"]
            hf[f"{p}.layer_norm2.{n}"] = sd[f"{q}.ln_2.{n}"]
            for j, c in enumerate("qkv"):
                w = sd[f"{q}.attn.in_proj_{n}"]
                hf[f"{p}.self_attn.{c}_proj.{n}"] = w[j * 64:(j + 1) * 64]
            hf[f"{p}.self_attn.out_proj.{n}"] = sd[f"{q}.attn.out_proj.{n}"]
            hf[f"{p}.mlp.fc1.{n}"] = sd[f"{q}.mlp.c_fc.{n}"]
            hf[f"{p}.mlp.fc2.{n}"] = sd[f"{q}.mlp.c_proj.{n}"]
    return hf


@pytest.mark.parametrize("layout", ["openai", "hf"])
def test_checkpoint_loaders_match_jax(layout):
    sd = _openai_dict()
    src = sd if layout == "openai" else _hf_of(sd)
    jparams = (JC.load_openai_clip_text(src) if layout == "openai"
               else JC.load_hf_clip_text(src))
    state = (TC.load_openai_clip_text(src) if layout == "openai"
             else TC.load_hf_clip_text(src))
    cfg = dict(vocab_size=600, context_length=16, width=64, heads=4, layers=2, embed_dim=32)
    tm = TC.CLIPTextTower(**cfg)
    tm.load_state_dict(state)
    tok = _tokens(3)
    want = jax.jit(JC.CLIPTextTower(**cfg).apply)({"params": jparams}, jnp.asarray(tok))
    with torch.no_grad():
        got = tm(torch.from_numpy(tok))
    assert_close(got.numpy(), want, what=layout)


def test_clip_text_encoder_matches_jax(merge_files, tmp_path):
    """On the JAX encoder's weights, then from a local OpenAI ``.pt``."""
    jm, v, tm = _tower_pair(4, vocab_size=600)
    texts = ["person", "bus", "the cat", "", "", "x½y Ⅳ²"]
    cfg = dict(vocab_size=600, context_length=16, width=64, heads=4, layers=2, embed_dim=32)
    jenc = JC.ClipTextEncoder(merge_files[0], params=v["params"], tower=jm, context_length=16,
                              n_merges=None)
    tenc = TC.ClipTextEncoder(merge_files[0], state_dict=tm.state_dict(),
                              tower=TC.CLIPTextTower(**cfg), context_length=16, n_merges=None,
                              device="cpu")
    got, want = tenc(texts), jenc(texts)
    assert got.dtype == np.float32 and got.shape == (6, 32)
    assert_close(got, want, what="features")
    np.testing.assert_array_equal(got[3], got[4])  # the padded slots share one embedding
    sd = {k: torch.from_numpy(a) for k, a in _openai_dict(5, width=128).items()}
    torch.save(sd, tmp_path / "clip.pt")
    enc = TC.ClipTextEncoder.from_openai_checkpoint(tmp_path / "clip.pt", merge_files[0],
                                                    n_merges=None, device="cpu")
    assert len(enc.tower.resblock_0.attn_in.weight) == 384 and enc.context_length == 16
    jsd = JC.load_openai_clip_text({k: t.numpy() for k, t in sd.items()})
    jt = JC.CLIPTextTower(vocab_size=600, context_length=16, width=128, heads=2, layers=2,
                          embed_dim=32)
    want = jax.jit(jt.apply)({"params": jsd}, jnp.asarray(enc.tokenizer(texts, 16)))
    assert_close(enc.features(texts).numpy(), want, what="from_openai_checkpoint")


# --- the data ---


def test_random_load_text_matches_jax_draw_for_draw():
    texts = [["cat", "kitty"], ["dog"], ["bird", "fowl", "avian"], ["fish"], ["cow"], ["ant"]]
    kw = dict(neg_samples=(1, 3), max_samples=5, seed=7, prompt_format="a photo of {}")
    jr, tr = JMM.RandomLoadText(**kw), TMM.RandomLoadText(**kw)
    rng = np.random.default_rng(0)
    for _ in range(20):
        cls = rng.integers(0, 6, rng.integers(0, 5))
        jc, jt = jr(cls, texts)
        tc, tt = tr(cls, texts)
        np.testing.assert_array_equal(tc, jc)
        assert tt == jt and len(tt) == 5
    assert TMM.names_to_texts({1: "b/bee", 0: "a"}) == JMM.names_to_texts({1: "b/bee", 0: "a"})


@pytest.fixture(scope="module")
def jpg_dataset(tmp_path_factory):
    return jax_synthetic(tmp_path_factory.mktemp("worldds"), n_train=6, n_val=5, imgsz=96)


def embed_len(texts):
    """A stand-in text tower: each text's length and its first letter."""
    return np.stack([np.asarray([len(t), ord(t[0]) if t else 0, 1.0], np.float32) for t in texts])


@pytest.mark.parametrize("split", ["val", "train"])
def test_multimodal_batches_match_jax(jpg_dataset, split):
    """Both loaders with ``task="world"``, a seeded ``text_cfg`` and an
    ``embed_fn``: texts, remapped classes, masks and ``txt_feats`` equal
    (the train split's augmented images are held in ``test_torch_data``)."""
    kw = dict(batch=2, imgsz=96, max_labels=16, task="world", embed_fn=embed_len,
              text_cfg=dict(seed=3, neg_samples=(1, 2), max_samples=4), seed=1,
              hyp={"mosaic": 0.0} if split == "train" else None)
    jl, _ = jax_build_dataloader(jpg_dataset, split, **kw)
    tl, _ = build_dataloader(jpg_dataset, split, **kw)
    assert isinstance(tl.ds, TMM.MultiModalDataset)
    n = 0
    for jb, tb in zip(list(jl), list(tl), strict=True):
        assert tb["texts"] == jb["texts"]
        np.testing.assert_array_equal(tb["mask"], jb["mask"])
        np.testing.assert_allclose(tb["cls_boxes"], jb["cls_boxes"], rtol=0, atol=1e-3)
        np.testing.assert_array_equal(tb["txt_feats"], jb["txt_feats"])
        assert tb["txt_feats"].shape == (len(tb["img"]), 4, 3)
        n += int(tb["mask"].sum())
    assert n > 0


def test_grounding_dataset_matches_jax(jpg_dataset, tmp_path):
    d = yaml.safe_load(open(jpg_dataset))
    img_dir = __import__("pathlib").Path(d["path"]) / d["train"] if "path" in d else None
    img_dir = img_dir if img_dir and img_dir.exists() else __import__("pathlib").Path(d["train"])
    files = sorted(img_dir.glob("*.jpg"))[:2]
    caption = "a red box beside a blue circle"
    ann = {"images": [{"id": i, "height": 96, "width": 96, "file_name": f.name,
                       "caption": caption} for i, f in enumerate(files)],
           "annotations": [
               {"image_id": 0, "bbox": [10, 10, 30, 30], "iscrowd": 0, "tokens_positive": [[0, 9]]},
               {"image_id": 0, "bbox": [50, 40, 20, 20], "iscrowd": 0,
                "tokens_positive": [[17, 30]]},
               {"image_id": 0, "bbox": [5, 5, 0, 20], "iscrowd": 0, "tokens_positive": [[0, 1]]},
               {"image_id": 1, "bbox": [5, 5, 40, 50], "iscrowd": 1, "tokens_positive": [[0, 9]]},
               {"image_id": 1, "bbox": [5, 5, 40, 50], "iscrowd": 0,
                "tokens_positive": [[2, 5], [6, 9]]}]}
    jf = tmp_path / "grounding.json"
    jf.write_text(json.dumps(ann))
    jd = JMM.GroundingDataset(str(files[0].parent), str(jf), imgsz=96, max_labels=8)
    td = TMM.GroundingDataset(str(files[0].parent), str(jf), imgsz=96, max_labels=8)
    assert td.files == jd.files and len(td.files) == 2
    for tl, jl in zip(td.labels, jd.labels):
        assert tl["texts"] == jl["texts"]
        np.testing.assert_array_equal(tl["cls"], jl["cls"])
        np.testing.assert_allclose(tl["xywhn"], jl["xywhn"], rtol=1e-7)
    assert td.labels[0]["texts"] == [["a red box"], ["a blue circle"]]
    assert td.labels[1]["texts"] == [["red box"]]


# --- the engine ---

TINY_WORLD = {"nc": 1, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                                    [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "C2fAttn", [32, 16, 2]],
                                    [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [32, 3, 2]]],
              "head": [[[3, 4, 5], 1, "ImagePoolingAttn", [16]],
                       [[3, 4, 5], 1, "WorldDetect", ["nc", 512, False]]]}


@pytest.fixture(scope="module")
def pose_png(tmp_path_factory):
    """A one-class PNG dataset (the pose set's person boxes, read as detect
    labels)."""
    return make_synthetic_dataset(tmp_path_factory.mktemp("oneclass"), n_train=4, n_val=4,
                                  imgsz=64, task="pose")


def test_trainer_world_epoch_with_text_encoder(pose_png, tmp_path):
    """One epoch: every step's guide comes from the encoder (B, 1, 3 + ...)
    and the trained model keeps its own guide for validation."""
    calls = []

    def enc(texts):
        calls.append(list(texts))
        return np.tile(embed_len(texts), (1, 171))[:, :512]

    tm = TaskModel(TINY_WORLD, device="cpu")
    guide = tm.txt_feats.clone()
    tr = Trainer(tm, overrides=dict(data=pose_png, epochs=1, imgsz=64, batch=2, val=True,
                                    device="cpu", project=str(tmp_path), name="w", plots=False,
                                    device_augment=True, mosaic=0.0, workers=0, save=True))
    tr.text_encoder = enc
    metrics = tr.train()
    assert len(calls) == 2 and all(len(c) == 2 for c in calls)  # B x max_samples 1
    assert np.isfinite(metrics["fitness"]) and tr.model.task == "world"
    torch.testing.assert_close(tr.model.txt_feats, guide)
    assert (tmp_path / "w" / "last.pt").exists()


@pytest.fixture(scope="module")
def world_facade(pose_png, tmp_path_factory):
    jm = jax_task_model(TINY_WORLD, None, (8, 16, 32))
    jm.txt_feats = jax.random.normal(jax.random.PRNGKey(0), (1, 1, 512))
    v = seeded_variables(lambda: jm.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                                train=False, guide=jm.txt_feats), 5)
    tmp = tmp_path_factory.mktemp("wyaml")
    (tmp / "tiny-world.yaml").write_text(yaml.safe_dump(TINY_WORLD))
    m = YOLO(str(tmp / "tiny-world.yaml"), device="cpu")
    load_jax_variables(m.model, flatten_variables(v))
    m.model.txt_feats = torch.from_numpy(np.array(jm.txt_feats))
    return jm, v, m


def test_yolo_world_val_matches_jax_validator(world_facade, pose_png):
    from xlstm_yolo_tpu.engine.validator import Validator as JaxValidator

    jm, v, m = world_facade
    want = JaxValidator(jm, imgsz=64, batch=2)(v, data=pose_png)
    got = m.val(data=pose_png, imgsz=64, batch=2)
    for k in ("precision", "recall", "mAP50", "mAP50-95", "fitness"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_yolo_world_predict_embed_save_reload(world_facade, pose_png, tmp_path):
    jm, v, m = world_facade
    src = str(__import__("pathlib").Path(pose_png).parent / "images" / "val")
    r1 = m.predict(src, imgsz=64, conf=0.001, verbose=False)
    assert len(r1) == 4 and all(r.boxes.xyxy.shape[1] == 4 for r in r1)
    emb = m.embed(src, imgsz=64)
    assert emb[0].shape == ((64 + 1) * 3,)
    path = m.save(tmp_path / "w.pt")
    m2 = YOLO(str(path), device="cpu")
    assert m2.task == "world" and m2.model.nc == 1
    # the checkpoint holds no guide: the reload has the default one, as in JAX
    torch.testing.assert_close(m2.model.txt_feats, TaskModel(TINY_WORLD, device="cpu").txt_feats)
    m2.model.txt_feats = m.model.txt_feats.clone()
    r2 = m2.predict(src, imgsz=64, conf=0.001, verbose=False)
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)
    # the rest of the JAX Model's methods keep the guide, as the JAX model object does
    guide = torch.randn(1, 1, 512)
    m2.model.txt_feats = guide
    assert "world model" in m2.info() and "nc=1" in m2.info()
    m2.load(path)
    assert m2.model.txt_feats is guide
    m2.reset_weights()
    assert m2.model.txt_feats is guide and m2.model.task == "world"
    x = torch.rand(2, 64, 64, 3)
    with torch.no_grad():
        before = m2.model.eval().predictions(x)
        after = m2.fuse().model.predictions(x)
    torch.testing.assert_close(after, before, rtol=1e-4, atol=1e-4)


# --- NAS and FastSAM ---


def test_nas_facade():
    n = NAS("yolo_nas_s.yaml", device="cpu")
    assert n.model.scale == "s" and n.model.num_params() == WORLD_COUNTS["yolo_nas.yaml"]["s"]
    res = n.predict(np.zeros((48, 64, 3), np.uint8), imgsz=64, verbose=False)
    assert len(res) == 1 and res[0].boxes.data.shape[1] == 6
    with pytest.raises(NotImplementedError):
        n.train(data="x.yaml")


def test_fastsam_prompts_match_jax():
    from xlstm_yolo_tpu.models_extra import FastSAM as JaxFastSAM

    dets = np.asarray([[10, 10, 50, 50, 0.9, 0], [100, 100, 150, 150, 0.8, 0]], np.float32)
    valid = np.asarray([True, True])
    masks = np.zeros((2, 32, 32), bool)
    masks[0, 2:12, 2:12] = True
    masks[1, 20:30, 20:30] = True
    for box in ([12, 12, 48, 48], [90, 90, 160, 160]):
        assert FastSAM.box_prompt(dets, valid, masks, box) == JaxFastSAM.box_prompt(
            dets, valid, masks, box)
    for pts, lab in (([(25, 25)], None), ([(100, 100), (25, 25)], [1, 1]), ([(25, 25)], [0])):
        assert FastSAM.point_prompt(dets, valid, masks, pts, lab, img_shape=(128, 128)) == \
            JaxFastSAM.point_prompt(dets, valid, masks, pts, lab, img_shape=(128, 128))
    emb = np.random.default_rng(0).normal(size=(5, 8))
    assert FastSAM.text_prompt(emb, emb[3], topk=2) == JaxFastSAM.text_prompt(emb, emb[3], topk=2)
    assert FastSAM.box_prompt(dets, valid, masks, [12, 12, 48, 48]) == [0]


def test_fastsam_mask_association_and_everything():
    """Two overlapping same-class candidates keep their own masks through
    ``return_idx`` (``tests/test_models_extra.py``'s case); then
    ``everything`` on a one-class seg model."""
    nm, hm = 4, 16
    cands = np.zeros((1, 2, 5), np.float32)
    cands[0, 0] = [30, 30, 40, 40, 0.9]
    cands[0, 1] = [34, 34, 12, 12, 0.8]
    coefs = np.zeros((1, 2, nm), np.float32)
    coefs[0, 0, 0] = coefs[0, 1, 1] = 8.0
    proto = np.full((1, hm, hm, nm), -8.0, np.float32)
    proto[0, :8, :, 0] = 1.0
    proto[0, 8:, :, 1] = 1.0
    dets, valid, src = non_max_suppression(torch.from_numpy(cands), conf_thres=0.25,
                                           iou_thres=0.5, max_det=4, return_idx=True)
    dets, valid, src = dets.numpy(), valid.numpy(), src.numpy()
    assert valid[0].sum() == 2
    masks = FastSAM.masks_from_src(coefs, proto, valid, src)
    order = np.argsort(-dets[0, :2, 4])
    hi, lo = masks[0, order[0]], masks[0, order[1]]
    assert hi[:8].all() and not hi[8:].any() and lo[8:].all() and not lo[:8].any()
    sam = FastSAM(TaskModel("yolov8-seg.yaml", scale="n", nc=1, device="cpu"))
    d, vd, mk = sam.everything(torch.rand(1, 64, 64, 3), conf=0.0, iou=0.9, max_det=10)
    assert d.shape == (1, 10, 6) and mk.shape == (1, 10, 16, 16) and vd.any()
    i = int(np.flatnonzero(vd[0])[0])
    assert FastSAM.box_prompt(d[0], vd[0], mk[0], d[0, i, :4], 0.99) [0] == i

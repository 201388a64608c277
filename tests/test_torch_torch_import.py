"""Port parity: ``utils/torch_import.py`` (Ultralytics-layout state dicts in
and out, SAM / SAM2 encoder tensors in) and the ``torch`` export format
against the JAX package's on the CPU.

* ``to_torch_state_dict`` of yolov8n, -seg, -pose, -obb, -cls, yolo11n and
  rtdetr-l at 3 classes (pose 1): the same keys and arrays as the JAX
  function's on the same weights, exactly; both raise on vil_yolon;
* a ``.pt`` the JAX ``Exporter(format="torch")`` writes opens as the port's
  ``Model(pt)`` with the JAX ``Model(pt)``'s predictions (1e-4);
* the port's own round trip (export, then ``load_torch_state_dict`` into
  other weights) is bit-exact, and names that match nothing are reported
  as the JAX importer reports them;
* a SAM-layout state dict of seeded values (a three-block ViT at 128 px)
  and a Hiera trunk's (SAM2 at 128 px): both packages load them, the
  encoders agree within 1e-5 of each output's max, and the same
  mismatches raise the same errors.

Weights: the port's seeded init with seeded noise, carried to the JAX tree
(``test_torch_export.pair``). Torch on one thread.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_detect_zoo import compiled
from test_torch_export import IMGSZ, images, pair
from test_torch_sam import LowOpt
from test_torch_yolo11 import seeded_variables
from xlstm_yolo_tpu import models_sam as JS
from xlstm_yolo_tpu import models_sam2 as J2
from xlstm_yolo_tpu.engine.exporter import Exporter as JaxExporter
from xlstm_yolo_tpu.engine.model import Model as JaxModel
from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_tpu.utils import torch_import as JT
from xlstm_yolo_torch import YOLO
from xlstm_yolo_torch import models_sam as TS
from xlstm_yolo_torch import models_sam2 as T2
from xlstm_yolo_torch.engine.exporter import Exporter
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils import torch_import as PT
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables

YAMLS = [("yolov8n.yaml", 3), ("yolov8n-seg.yaml", 3), ("yolov8n-pose.yaml", 1),
         ("yolov8n-obb.yaml", 3), ("yolov8n-cls.yaml", 3), ("yolo11n.yaml", 3),
         ("rtdetr-l.yaml", 3)]
RAISING = ("rtdetr-l.yaml", "vil_yolon.yaml")  # no reference name for some key, in both packages
ROUND_TRIP = [c for c in YAMLS if c[0] not in RAISING]
S = 128  # the SAM / SAM2 image size


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(cfg, nc):
        if cfg not in cache:
            cache[cfg] = pair(cfg, nc=nc)
        return cache[cfg]

    return get


def _state(model):
    return {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("cfg,nc", YAMLS + [("vil_yolon.yaml", 3)],
                         ids=[c[0].split(".")[0] for c in YAMLS] + ["vil_yolon"])
def test_to_torch_state_dict_matches_jax(pairs, cfg, nc):
    """Key for key and array for array, or both raise the same error (rtdetr-l:
    its decoder's ``input_proj`` BatchNorm statistics; vil_yolon: every ViL
    weight)."""
    _, v, tm = pairs(cfg, nc)
    if cfg in RAISING:
        both_raise(lambda: JT.to_torch_state_dict(v), lambda: PT.to_torch_state_dict(tm))
        return
    want = JT.to_torch_state_dict(v)
    got = PT.to_torch_state_dict(tm)
    assert sorted(got) == sorted(want)
    for k, arr in want.items():
        assert got[k].shape == arr.shape and np.array_equal(got[k], arr), k


@pytest.mark.parametrize("cfg,nc", ROUND_TRIP, ids=[c[0].split(".")[0] for c in ROUND_TRIP])
def test_port_round_trip_is_bit_exact(pairs, cfg, nc):
    """``to_torch_state_dict``, then ``load_torch_state_dict`` into a model of
    other weights: every tensor back, bit for bit, nothing unmatched."""
    _, _, tm = pairs(cfg, nc)
    sd = PT.to_torch_state_dict(tm)
    other = TaskModel(cfg, nc=nc, device="cpu", seed=5)
    _, matched, missed = PT.load_torch_state_dict(other, sd, verbose=False)
    assert not missed and matched == len(sd)
    for k, t in _state(tm).items():
        assert torch.equal(_state(other)[k], t), k


def test_jax_torch_pt_opens_in_the_port(pairs, tmp_path, monkeypatch):
    """The JAX ``Exporter(format="torch")`` file -> the port's ``Model(pt)``
    (its graph from the file's YAML name), predictions against the JAX
    ``Model(pt)``'s. The JAX constructor's eager init, whose every leaf the
    file then replaces, is swapped for zeros of its structure (``jax.eval_shape``;
    the eager init takes 20 s here)."""
    jm, v, _ = pairs("yolov8n.yaml", 3)
    pt = JaxExporter(jm, v, format="torch", imgsz=IMGSZ, output_dir=str(tmp_path))()
    init = JaxTaskModel.init
    monkeypatch.setattr(JaxTaskModel, "init", lambda self, *a, **k: jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype), jax.eval_shape(lambda: init(self, *a, **k))))
    theirs = JaxModel(pt)
    ours = YOLO(pt, device="cpu")
    assert ours.task == theirs.task == "detect" and ours.model.nc == theirs.model.nc == 3
    x = images(2, seed=4)
    want = compiled(theirs.model.predictions, theirs.variables, jnp.asarray(x))(
        theirs.variables, jnp.asarray(x))
    with torch.no_grad():
        got = ours.model.predictions(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_port_torch_export_reloads_and_model_load(pairs, tmp_path):
    """The port's ``Exporter(format="torch")`` file: the JAX importer takes
    it back without a miss; ``YOLO(pt)`` rebuilds the same model bit for
    bit; ``Model.load`` of the bare state dict into a model of the graph
    does too; a bare state dict alone names no graph and raises."""
    jm, v, tm = pairs("yolov8n.yaml", 3)
    pt = Exporter(tm, format="torch", imgsz=IMGSZ, device="cpu", output_dir=str(tmp_path))()
    ckpt = torch.load(pt, weights_only=True)
    assert (ckpt["yaml"], ckpt["task"], ckpt["nc"]) == ("yolov8n.yaml", "detect", 3)
    zero = jax.tree.map(np.zeros_like, v)
    back, _, missed = JT.load_torch_state_dict(
        zero, {k: t.numpy() for k, t in ckpt["state_dict"].items()}, verbose=False)
    assert not missed
    for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    again = YOLO(pt, device="cpu")
    for k, t in _state(tm).items():
        assert torch.equal(_state(again.model)[k], t), k
    bare = tmp_path / "bare.pt"
    torch.save(ckpt["state_dict"], bare)
    loaded = YOLO("yolov8n.yaml", device="cpu", seed=3)
    loaded.model = TaskModel("yolov8n.yaml", nc=3, device="cpu", seed=3)
    loaded.load(bare)
    for k, t in _state(tm).items():
        assert torch.equal(_state(loaded.model)[k], t), k
    with pytest.raises(ValueError, match="no architecture metadata"):
        YOLO(bare, device="cpu")


def test_unmatched_names_are_reported_as_jax_reports_them(pairs):
    """A name no key matches and a tensor of the wrong shape: both importers
    leave them out and list them, in the same order; the rest loads."""
    _, v, tm = pairs("yolov8n.yaml", 3)
    sd = PT.to_torch_state_dict(tm)
    sd["model.99.conv.weight"] = np.zeros((3, 3, 1, 1), np.float32)
    sd["model.0.conv.weight"] = np.zeros((1, 2, 3, 3), np.float32)
    _, jmatched, jmissed = JT.load_torch_state_dict(v, sd, verbose=False)
    other = TaskModel("yolov8n.yaml", nc=3, device="cpu", seed=5)
    _, matched, missed = PT.load_torch_state_dict(other, sd, verbose=False)
    assert missed == jmissed == ["model.0.conv.weight", "model.99.conv.weight"]
    assert matched == jmatched == len(sd) - 2
    assert not torch.equal(_state(other)["l0.conv.weight"], _state(tm)["l0.conv.weight"])


# --- SAM / SAM2 encoder tensors ---------------------------------------------

def _rand(rng, shape, base=0.0):
    return (base + 0.1 * rng.normal(size=shape)).astype(np.float32)


def sam_state_dict(enc: dict, seed: int, prefix: str = "image_encoder.") -> dict:
    """A SAM-layout state dict of seeded values for the JAX encoder subtree
    ``enc`` (shapes only), under the names ``sam_encoder_params`` reads."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, k):
        sd[prefix + name] = _rand(rng, (k.shape[3], k.shape[2], k.shape[0], k.shape[1]))

    def lin(name, d):
        sd[prefix + name + ".weight"] = _rand(rng, d["kernel"].shape[::-1])
        sd[prefix + name + ".bias"] = _rand(rng, d["bias"].shape)

    def norm(name, d):
        sd[prefix + name + ".weight"] = _rand(rng, d["scale"].shape, 1.0)
        sd[prefix + name + ".bias"] = _rand(rng, d["bias"].shape)

    conv("patch_embed.proj.weight", enc["patch_embed"]["kernel"])
    sd[prefix + "patch_embed.proj.bias"] = _rand(rng, enc["patch_embed"]["bias"].shape)
    sd[prefix + "pos_embed"] = _rand(rng, enc["pos_embed"].shape)
    conv("neck.0.weight", enc["neck0"]["kernel"])
    norm("neck.1", enc["neck_ln0"])
    conv("neck.2.weight", enc["neck1"]["kernel"])
    norm("neck.3", enc["neck_ln1"])
    i = 0
    while f"block{i}" in enc:
        blk, b = enc[f"block{i}"], f"blocks.{i}."
        norm(b + "norm1", blk["norm1"])
        norm(b + "norm2", blk["norm2"])
        lin(b + "attn.qkv", blk["attn"]["qkv"])
        lin(b + "attn.proj", blk["attn"]["proj"])
        lin(b + "mlp.lin1", blk["mlp"]["Dense_0"])
        lin(b + "mlp.lin2", blk["mlp"]["Dense_1"])
        for rp in ("rel_pos_h", "rel_pos_w"):
            if rp in blk["attn"]:
                sd[prefix + b + "attn." + rp] = _rand(rng, blk["attn"][rp].shape)
        i += 1
    return sd


def hiera_state_dict(trunk: dict, seed: int, prefix: str = "image_encoder.trunk.") -> dict:
    """A SAM2-layout Hiera trunk state dict of seeded values for the JAX
    trunk subtree ``trunk``, under ``sam2_hiera_params``'s names."""
    rng = np.random.default_rng(seed)
    nchw = lambda s: (s[0], s[3], s[1], s[2])
    k = trunk["patch_embed"]["kernel"].shape
    sd = {prefix + "patch_embed.proj.weight": _rand(rng, (k[3], k[2], k[0], k[1])),
          prefix + "patch_embed.proj.bias": _rand(rng, trunk["patch_embed"]["bias"].shape),
          prefix + "pos_embed": _rand(rng, nchw(trunk["pos_embed"].shape)),
          prefix + "pos_embed_window": _rand(rng, nchw(trunk["pos_embed_window"].shape))}
    i = 0
    while f"b{i}" in trunk:
        blk, b = trunk[f"b{i}"], f"{prefix}blocks.{i}."
        for n in ("norm1", "norm2"):
            sd[b + n + ".weight"] = _rand(rng, blk[n]["scale"].shape, 1.0)
            sd[b + n + ".bias"] = _rand(rng, blk[n]["bias"].shape)
        for name, d in (("attn.qkv", blk["attn"]["qkv"]), ("attn.proj", blk["attn"]["proj"]),
                        ("mlp.layers.0", blk["mlp0"]), ("mlp.layers.1", blk["mlp1"]),
                        *((("proj", blk["proj"]),) if "proj" in blk else ())):
            sd[b + name + ".weight"] = _rand(rng, d["kernel"].shape[::-1])
            sd[b + name + ".bias"] = _rand(rng, d["bias"].shape)
        i += 1
    return sd


def assert_close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def both_raise(jax_call, port_call):
    """Both calls raise ValueError with the same message."""
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def sam():
    jm = JS.SAM(img_size=S, encoder_dim=64, encoder_depth=3)
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3))), 0)
    tm = load_jax_variables(TS.SAM(img_size=S, encoder_dim=64, encoder_depth=3, device="cpu"),
                            flatten_variables(v))
    return jm, v, tm


def test_sam_encoder_import_matches_jax(sam):
    jm, v, tm = sam
    sd = sam_state_dict(v["params"]["image_encoder"], seed=1)
    v2 = JT.load_sam_encoder(v, sd)
    PT.load_sam_encoder(tm, sd)
    x = np.random.default_rng(2).random((2, S, S, 3)).astype(np.float32)
    want = LowOpt(lambda v, x: jm.apply(v, x, method=jm.encode_image))(v2, jnp.asarray(x))
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(x))
    assert_close(got, want)
    bare = copy.deepcopy(tm.image_encoder)
    PT.load_sam_encoder(bare, sd)  # the bare encoder takes the same tensors
    for k, t in bare.state_dict().items():
        assert torch.equal(t, tm.image_encoder.state_dict()[k]), k


def test_sam_encoder_mismatches_raise_as_jax(sam):
    _, v, tm = sam
    sd = sam_state_dict(v["params"]["image_encoder"], seed=1)
    extra = dict(sd, **{k.replace("blocks.2.", "blocks.3."): a for k, a in sd.items()
                        if ".blocks.2." in k})
    both_raise(lambda: JT.load_sam_encoder(v, extra), lambda: PT.load_sam_encoder(tm, extra))
    p = "image_encoder.pos_embed"
    bad = dict(sd, **{p: sd[p][:, :-1]})
    both_raise(lambda: JT.load_sam_encoder(v, bad), lambda: PT.load_sam_encoder(tm, bad))


@pytest.fixture(scope="module")
def sam2():
    m, hw, mem = 7, (S // 16) ** 2, 64
    jm = J2.SAM2(img_size=S, embed_dim=32)
    v = seeded_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), jnp.zeros((1, m, hw, mem)),
        jnp.zeros((1, m), jnp.int32), jnp.zeros((1, m), bool), None, None,
        method=jm.track_step), 0)
    tm = load_jax_variables(T2.SAM2(img_size=S, embed_dim=32, device="cpu"),
                            flatten_variables(v))
    return jm, v, tm


def test_sam2_hiera_import_matches_jax(sam2):
    jm, v, tm = sam2
    sd = hiera_state_dict(v["params"]["trunk"], seed=1)
    v2 = JT.load_sam2_hiera(v, sd)
    PT.load_sam2_hiera(tm, sd)
    x = np.random.default_rng(2).random((1, S, S, 3)).astype(np.float32)
    want = LowOpt(lambda v, x: jm.apply(v, x, method=lambda m, x: m.trunk(x)))(
        v2, jnp.asarray(x))
    with torch.no_grad():
        got = tm.trunk(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert_close(g, w)


def test_sam2_hiera_mismatches_raise_as_jax(sam2):
    _, v, tm = sam2
    sd = hiera_state_dict(v["params"]["trunk"], seed=1)
    short = {k: a for k, a in sd.items() if ".blocks.1." not in k}  # b1 missing, b2.. extra
    both_raise(lambda: JT.load_sam2_hiera(v, short), lambda: PT.load_sam2_hiera(tm, short))
    p = "image_encoder.trunk.pos_embed_window"
    bad = dict(sd, **{p: sd[p][:, :, :-1]})
    both_raise(lambda: JT.load_sam2_hiera(v, bad), lambda: PT.load_sam2_hiera(tm, bad))
    with pytest.raises(ValueError, match="no Hiera trunk"):
        PT.load_sam2_hiera(tm.neck, sd)

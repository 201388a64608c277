"""Port parity: on-device augmentation (``xlstm_yolo_torch/data/device_augment.py``)
and multi-scale training, against the JAX package on the CPU.

* ``apply`` against ``_device_augment_jit`` on a key, given the JAX
  module's own draws (recomputed here the way its ``per_image`` splits the
  key): the mosaic on, closed (the padded 2S canvas) and off (no mosaic
  key, the S canvas), each with the identity geometry and with non-zero
  degrees, shear, scale, translate, HSV and fliplr; batch 1. Images (0..255)
  within 0.1 absolute, boxes within 1e-3 px where the mask is set, masks
  equal. On the CPU the fused JAX program is wrong at some pixels whose
  bilinear footprint takes row or column -1 of the source: XLA recomputes
  the sampled value in several fusions that round it apart, so the HSV
  conversion's tests of which channel is the maximum all fail there and
  the hue comes from the wrong branch (up to 145 of 255 off). So the
  images are held at every pixel to the JAX module's stage functions,
  each jitted alone (sampling, then HSV, then the flip), and to the fused
  program at every pixel but those.
* Counterparts of the JAX module's own tests on the port's own draws.
* The draws: the same (seed, update count) gives the same draws, another
  count others; the affine's formulas against JAX's on JAX's uniforms.
* Batching: as many aten ops at batch 2 as at batch 8.
* ``multi_scale``: the resize within 1e-5 of ``jax.image.resize``
  bilinear, shrinking and growing; the bucket. ``get_cfg`` takes both keys
  and still refuses the mesh keys.
* The port ``Trainer`` against the JAX ``Trainer`` with both keys (yolov8n
  at 64 px, fp32, the same initial weights, the JAX draws handed to the
  port): the same sizes in the same order, the ``train/`` columns within
  1e-3 (relative), the learning rates within 1e-9. Every image takes the
  mosaic canvas (``mosaic`` 1, ``close_mosaic`` 0) and the scale range
  (0.3) keeps the output inside it: where the output shows the 114 border
  (a padded canvas, a closed mosaic), the JAX model's train-mode BatchNorm
  statistics, float32 sums over near-equal values in flax's one-pass
  variance, are 1.8e-3 off float64 at the first layer (the port's 1.2e-5),
  which moves its losses by 1e-3 to 7e-3; and a wrong pixel of the JAX
  step's own images on the top or left border (above) moves its box loss
  by 1.5e-3 through the assigner. The closed mosaic is held to JAX in the
  ``apply`` cases and trained in the resume test. A port run with both
  keys stopped before its third epoch and resumed ends as the
  uninterrupted run does.
"""
import csv
import functools
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from xlstm_yolo_tpu.data import device_augment as J
from xlstm_yolo_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from xlstm_yolo_tpu.engine.trainer import Trainer as JaxTrainer
from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_torch.cfg import get_cfg
from xlstm_yolo_torch.data import device_augment as P
from xlstm_yolo_torch.engine.trainer import Trainer, TrainStep, multi_scale_sizes
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.ops.letterbox import resize_bilinear
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables

B, S, M = 4, 64, 8
IMG_TOL, BOX_TOL = 0.1, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: the suite runs test
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the host (the resume test took 430 s there, 7 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
IDENTITY = dict(mosaic=0.0, degrees=0.0, translate=0.0, scale=0.0, shear=0.0,
                hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, fliplr=0.0)
GEOMETRY = dict(degrees=10.0, translate=0.2, scale=0.5, shear=5.0, hsv_h=0.015, hsv_s=0.7,
                hsv_v=0.4, fliplr=0.5)


def _batch(B=B, S=S, M=M, seed=0):
    """Noise images and 1 to M/2 boxes an image, of 6 px to S/2 a side."""
    r = np.random.default_rng(seed)
    imgs = r.integers(0, 255, (B, S, S, 3)).astype(np.uint8)
    cb = np.zeros((B, M, 5), np.float32)
    mk = np.zeros((B, M), bool)
    for b in range(B):
        for j in range(int(r.integers(1, M // 2 + 1))):
            x1, y1 = r.uniform(0, S - 12, 2)
            w, h = r.uniform(6, S / 2, 2)
            cb[b, j] = [r.integers(3), x1, y1, min(S, x1 + w), min(S, y1 + h)]
            mk[b, j] = True
    return imgs, cb, mk


def _split(k):
    """A per-image key's four keys, as ``per_image`` splits it."""
    return jax.random.split(k, 4)


def _values(hyp, mosaic_p):
    """The hyp values the JAX pipeline reads, traced (one compile a shape)."""
    return jnp.asarray([hyp[k] for k in ("degrees", "translate", "scale", "shear", "fliplr",
                                         "hsv_h", "hsv_s", "hsv_v")] + [mosaic_p], jnp.float32)


@functools.lru_cache(maxsize=None)
def _jax_draws_fn(src, size):
    def one(k, v):
        kmo, kaff, khsv, kflip = _split(k)
        fwd, inv = J._affine_matrix(kaff, v[0], v[1], v[2], v[3], src, size)
        return (jax.random.uniform(kmo) < v[8], fwd, inv,
                jax.random.uniform(khsv, (3,), minval=-1.0, maxval=1.0),
                jax.random.uniform(kflip) < v[4])

    return jax.jit(jax.vmap(one, in_axes=(0, None)))


def jax_draws(key, n, size, hyp, mosaic_p) -> P.Draws:
    """The draws ``_device_augment_jit`` makes from ``key`` for n images of
    ``size``, as port tensors; ``hyp`` as ``aug_hyp``."""
    src = 2 * size if hyp["mosaic"] > 0 else size
    out = _jax_draws_fn(src, size)(jax.random.split(key, n), _values(hyp, mosaic_p))
    return P.Draws(*(torch.from_numpy(np.array(o)) for o in out))


@functools.lru_cache(maxsize=None)
def _jax_stage_fns(use_mosaic):
    """The sampling stage (canvas, affine, ``_sample_bilinear``) and the HSV
    stage of ``per_image``, each its own program."""
    def sample(x, idx, k, v):
        n, size = x.shape[:2]
        kmo, kaff, _, _ = _split(k)
        src = x[idx]
        if use_mosaic:
            canvas, _, _ = J._mosaic_canvas(x, jnp.zeros((n, 1, 5)), jnp.zeros((n, 1), bool), idx)
            src = jnp.where(jax.random.uniform(kmo) < v[8], canvas,
                            jnp.pad(src, ((0, size), (0, size), (0, 0)), constant_values=J.FILL))
        _, inv = J._affine_matrix(kaff, v[0], v[1], v[2], v[3], src.shape[0], size)
        return J._sample_bilinear(src, inv, size)

    hsv = lambda o, k, v: J.hsv_jitter(_split(k)[2], o, v[5], v[6], v[7])
    return (jax.jit(jax.vmap(sample, in_axes=(None, 0, 0, None))),
            jax.jit(jax.vmap(hsv, in_axes=(0, 0, None))))


def jax_staged_images(imgs, key, mosaic_p, hyp):
    """The images of ``_device_augment_jit`` from the JAX module's stage
    functions, each stage jitted alone: the canvas and ``_sample_bilinear``,
    then ``hsv_jitter``, then the flip."""
    n = imgs.shape[0]
    keys, v = jax.random.split(key, n), _values(hyp, mosaic_p)
    sample, hsv = _jax_stage_fns(hyp["mosaic"] > 0)
    out = np.asarray(hsv(sample(jnp.asarray(imgs, jnp.float32), jnp.arange(n), keys, v), keys, v))
    flip = np.asarray(jax.vmap(lambda k: jax.random.uniform(_split(k)[3]) < hyp["fliplr"])(keys))
    return np.where(flip[:, None, None, None], out[:, :, ::-1], out)


def _top_left_edge(d: P.Draws, eps: float = 1e-3):
    """(n, S, S) bool: the output pixels whose bilinear footprint takes a
    tap at row or column -1 of their source (within ``eps``), after the
    flip."""
    ys, xs = np.mgrid[0:S, 0:S]
    pts = np.stack([xs, ys, np.ones_like(xs)]).reshape(3, -1).astype(np.float32)
    src = np.einsum("bij,jn->bin", d.inv.numpy(), pts)
    near = lambda c: (c > -1 - eps) & (c < eps)
    edge = (near(src[:, 0]) | near(src[:, 1])).reshape(-1, S, S)
    return np.where(d.flip.numpy()[:, None, None], edge[:, :, ::-1], edge)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# (a) apply against _device_augment_jit, given JAX's draws
# ---------------------------------------------------------------------------

CASES = {
    "mosaic": (dict(IDENTITY, mosaic=1.0), 1.0, B),
    "mosaic_closed": (dict(IDENTITY, mosaic=0.5), 0.0, B),
    "no_mosaic": (dict(IDENTITY, mosaic=0.0), 0.0, B),
    "mosaic_geometry": (dict(GEOMETRY, mosaic=1.0), 1.0, B),
    "mosaic_closed_geometry": (dict(GEOMETRY, mosaic=0.5), 0.0, B),
    "no_mosaic_geometry": (dict(GEOMETRY, mosaic=0.0), 0.0, B),
    "batch_1": (dict(GEOMETRY, mosaic=1.0), 1.0, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_matches_jax_given_its_draws(case):
    hyp, mosaic_p, n = CASES[case]
    imgs, cb, mk = _batch(B=n, seed=len(case))
    key = jax.random.PRNGKey(len(case) + 3)
    want = J._device_augment_jit(jnp.asarray(imgs), jnp.asarray(cb), jnp.asarray(mk), key,
                                 jnp.float32(mosaic_p), tuple(sorted(hyp.items())))
    want_img, want_cb, want_mk = (np.asarray(w) for w in want)
    hyp = P.aug_hyp(hyp)
    d = jax_draws(key, n, S, hyp, mosaic_p)
    assert d.mosaic.all() if mosaic_p == 1.0 else not d.mosaic.any()
    img, got_cb, got_mk = (t.numpy() for t in P.apply(*_t(imgs, cb, mk), d, hyp))

    assert img.shape == want_img.shape == (n, S, S, 3) and img.dtype == np.float32
    np.testing.assert_array_equal(got_mk, want_mk)
    assert want_mk.any()
    np.testing.assert_allclose(got_cb[want_mk], want_cb[want_mk], rtol=0, atol=BOX_TOL)
    np.testing.assert_allclose(img, jax_staged_images(imgs, key, mosaic_p, hyp), rtol=0,
                               atol=IMG_TOL)
    edge = _top_left_edge(d)
    np.testing.assert_allclose(img[~edge], want_img[~edge], rtol=0, atol=IMG_TOL)


# ---------------------------------------------------------------------------
# (b) the JAX module's own tests, on the port's own draws
# ---------------------------------------------------------------------------

def _port_batch(B=2, S=64, M=8, seed=0):
    """``tests/test_device_augment.py``'s batch."""
    r = np.random.default_rng(seed)
    imgs = r.integers(0, 255, (B, S, S, 3)).astype(np.uint8)
    cb = np.zeros((B, M, 5), np.float32)
    mk = np.zeros((B, M), bool)
    cb[0, 0] = [1, 8, 8, 32, 40]
    cb[0, 1] = [2, 20, 16, 56, 48]
    cb[1, 0] = [0, 4, 4, 60, 60]
    mk[0, :2] = True
    mk[1, 0] = True
    return dict(zip(("img", "cls_boxes", "mask"), _t(imgs, cb, mk)))


def _gen(n_updates=0):
    return P.step_generator(0, n_updates)


def test_identity_config_is_noop():
    b = _port_batch()
    out = P.device_augment(b, _gen(), IDENTITY)
    torch.testing.assert_close(out["img"], b["img"].float(), rtol=0, atol=1.5)
    assert int(out["mask"].sum()) == int(b["mask"].sum())
    torch.testing.assert_close(out["cls_boxes"][b["mask"]], b["cls_boxes"][b["mask"]],
                               rtol=0, atol=1e-3)


def test_fliplr_boxes_mirror():
    b = _port_batch()
    out = P.device_augment(b, _gen(1), dict(IDENTITY, fliplr=1.0))
    torch.testing.assert_close(out["img"], b["img"].float().flip(2), rtol=0, atol=1.5)
    torch.testing.assert_close(out["cls_boxes"][0, 0], torch.tensor([1.0, S - 32, 8, S - 8, 40]),
                               rtol=0, atol=1e-3)


def test_mosaic_combines_batch_labels():
    b = _port_batch(B=4, M=4)
    out = P.device_augment(b, _gen(2), dict(IDENTITY, mosaic=1.0))
    cb, mk = out["cls_boxes"], out["mask"]
    assert mk.shape == b["mask"].shape  # repacked to M slots
    boxes = cb[mk]
    assert len(boxes) > 0
    assert (boxes[:, 1:] >= 0).all() and (boxes[:, 1:] <= 64).all()
    assert (boxes[:, 3] > boxes[:, 1]).all() and (boxes[:, 4] > boxes[:, 2]).all()


def test_affine_scale_moves_boxes():
    b = _port_batch()
    out = P.device_augment(b, _gen(3), dict(IDENTITY, degrees=10.0, translate=0.1, scale=0.4))
    assert out["img"].shape == (2, 64, 64, 3) and torch.isfinite(out["img"]).all()
    bx = out["cls_boxes"][out["mask"]][:, 1:]
    assert (bx >= 0).all() and (bx <= 64).all()


def test_hsv_jitter_bounds():
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (1, 8, 8, 3))).float()
    out = P.hsv_jitter(img, torch.tensor([[0.9, -0.8, 0.7]]), 0.5, 0.9, 0.9)
    assert (out >= 0).all() and (out <= 255).all()
    out0 = P.hsv_jitter(img, torch.tensor([[0.9, -0.8, 0.7]]), 0.0, 0.0, 0.0)
    torch.testing.assert_close(out0, img, rtol=0, atol=1.0)


def test_extra_keys_pass_through():
    b = _port_batch()
    b["txt_feats"] = torch.ones(2, 4, 8)
    out = P.device_augment(b, _gen(), IDENTITY)
    assert out["txt_feats"] is b["txt_feats"]


# ---------------------------------------------------------------------------
# (c) the draws, (d) batching
# ---------------------------------------------------------------------------

def test_draws_follow_seed_and_update_count():
    hyp = P.aug_hyp(dict(GEOMETRY, mosaic=0.5))
    d = lambda seed, n: P.draw(B, S, hyp, 0.5, P.step_generator(seed, n))
    a, again, later, other = d(0, 5), d(0, 5), d(0, 6), d(1, 5)
    for x, y in zip(a, again):
        assert torch.equal(x, y)
    for z in (later, other):
        assert not torch.equal(a.fwd, z.fwd) and not torch.equal(a.r, z.r)


@pytest.mark.parametrize("mosaic", [0.0, 1.0])
def test_affine_matrix_formulas_match_jax(mosaic):
    """The port's ``_affine_matrix`` on the uniforms JAX's draws from a
    key: the same forward and inverse matrices."""
    src = 2 * S if mosaic else S
    args = (GEOMETRY["degrees"], GEOMETRY["translate"], GEOMETRY["scale"], GEOMETRY["shear"])
    got, want = [], []
    for i in range(6):
        kaff = _split(jax.random.PRNGKey(i))[1]
        k1, k2, k3, k4, k5 = jax.random.split(kaff, 5)
        u = [jax.random.uniform(k) for k in (k1, k2, k3, k4, k5, jax.random.fold_in(k5, 1))]
        got.append(P._affine_matrix(torch.tensor([[float(x) for x in u]]), *args, src, S))
        want.append(J._affine_matrix(kaff, *args, src, S))
    for (gf, gi), (wf, wi) in zip(got, want):
        np.testing.assert_allclose(gf[0].numpy(), np.asarray(wf), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(gi[0].numpy(), np.asarray(wi), rtol=1e-5, atol=1e-4)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_aten_ops_do_not_grow_with_the_batch():
    hyp = dict(GEOMETRY, mosaic=1.0)
    counts = {}
    for n in (2, 8):
        imgs, cb, mk = _batch(B=n, S=32, M=4)
        batch = dict(zip(("img", "cls_boxes", "mask"), _t(imgs, cb, mk)))
        with _CountOps() as mode:
            P.device_augment(batch, P.step_generator(0, 1), hyp, mosaic_p=0.5)
        counts[n] = mode.ops
    assert counts[2] == counts[8] and len(counts[2]) > 0


# ---------------------------------------------------------------------------
# (e) multi_scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [32, 96], ids=["shrink", "grow"])
def test_resize_matches_jax_image_resize(size):
    x = np.random.default_rng(size).random((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, size, size, 3), "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), size, size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cfg_takes_both_keys_and_still_refuses_the_mesh():
    """Both keys are taken; the mesh keys, refused while the port ran on one
    card, are ints now (``parallel.mesh``): a value that is not one is
    still refused."""
    args = get_cfg(overrides={"device_augment": True, "multi_scale": True})
    assert args.device_augment is True and args.multi_scale is True
    for key, value in (("mesh_dp", 2), ("mesh_tp", 2), ("pp_microbatches", 4)):
        assert getattr(get_cfg(overrides={key: value}), key) == value
        with pytest.raises(TypeError, match=key):
            get_cfg(overrides={key: value + 0.5})


def test_multi_scale_bucket():
    assert multi_scale_sizes(640, True, (8, 16, 32)) == [320, 480, 640, 800, 960]
    assert multi_scale_sizes(64, True, (8, 16, 32)) == [32, 64, 96]
    assert multi_scale_sizes(640, False, (8, 16, 32)) == []


# ---------------------------------------------------------------------------
# the trainer under both keys
# ---------------------------------------------------------------------------

IMGSZ = 64


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return jax_synthetic(tmp_path_factory.mktemp("augds"), n_train=8, n_val=4, imgsz=IMGSZ)


def _overrides(data, save_dir: Path, epochs: int, **kw) -> dict:
    return {"data": data, "epochs": epochs, "imgsz": IMGSZ, "batch": 4, "nbs": 4,
            "dtype": "float32", "workers": 0, "plots": False, "project": str(save_dir.parent),
            "name": save_dir.name, "device_augment": True, "multi_scale": True, "mosaic": 1.0,
            "degrees": 5.0, "shear": 2.0, "scale": 0.3, **kw}


def _rows(path: Path) -> list:
    with open(path) as f:
        return list(csv.DictReader(f))


def _jax_step_draws(self, n, size, device):
    """``TrainStep.augment_draws`` as the JAX step keys its draws:
    ``fold_in(PRNGKey(seed + 7919), n_updates)``."""
    key = jax.random.fold_in(jax.random.PRNGKey(self.seed + P.SEED_OFFSET), self.n_updates)
    return jax_draws(key, n, size, self.augment, self.mosaic_p).to(device)


def test_trainer_matches_jax_under_device_augment_and_multi_scale(data, tmp_path, monkeypatch):
    sizes = {"jax": [], "port": []}
    default_rng = np.random.default_rng

    class Recording:
        """The multi-scale generator (seed + 4242), recording its choices."""

        def __init__(self, rng, out):
            self.rng, self.out = rng, out

        def choice(self, *a, **kw):
            self.out.append(int(self.rng.choice(*a, **kw)))
            return self.out[-1]

    side = {"now": "jax"}
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: (
        Recording(default_rng(seed), sizes[side["now"]]) if seed == 4242 else default_rng(seed)))
    monkeypatch.setattr(TrainStep, "augment_draws", _jax_step_draws)

    jm = JaxTaskModel("yolov8n.yaml", nc=3, verbose=False)
    v = jax.jit(lambda: jm.init(0, imgsz=IMGSZ))()
    port_model = load_jax_variables(TaskModel("yolov8n.yaml", nc=3, device="cpu"),
                                    flatten_variables(v))
    over = dict(epochs=2, close_mosaic=0, val=False)
    jt = JaxTrainer(jm, overrides=_overrides(data, tmp_path / "jax", **over))
    jt.variables = v  # the JAX step donates these buffers: the port's copy is made above
    jt.train()
    side["now"] = "port"
    tt = Trainer(port_model, overrides={**_overrides(data, tmp_path / "port", **over),
                                        "device": "cpu"})
    tt.train()
    assert sizes["port"] == sizes["jax"] and len(sizes["jax"]) == 4
    assert tt._ms_sizes_used == jt._ms_sizes_used and len(tt._ms_sizes_used) >= 2
    assert tt.step.mosaic_p == 1.0 and tt.step.n_updates == 4
    want, got = _rows(tmp_path / "jax" / "results.csv"), _rows(tmp_path / "port" / "results.csv")
    assert len(got) == len(want) == 2 and list(got[0]) == list(want[0])
    for g, w in zip(got, want):
        for k in w:
            if k.startswith("train/"):
                assert abs(float(g[k]) - float(w[k])) <= 1e-3 * abs(float(w[k])), (k, g[k], w[k])
        assert abs(float(g["lr"]) - float(w["lr"])) <= 1e-9 and g["epoch"] == w["epoch"]


def test_resume_under_device_augment_continues_as_the_uninterrupted_run(data, tmp_path):
    """3 epochs, ``mosaic`` 0.5 and ``close_mosaic`` 2 (the mosaic closes at
    the second epoch, before the cut), both keys; the resumed third epoch's
    row and the final weights equal the uninterrupted run's."""
    fresh = lambda: TaskModel("yolov8n.yaml", nc=3, device="cpu", seed=0)
    over = dict(epochs=3, close_mosaic=2, mosaic=0.5, device="cpu")
    full = Trainer(fresh(), overrides=_overrides(data, tmp_path / "full", **over))
    full.train()

    class Stop(Exception):
        pass

    def stop_at_third(trainer):
        if trainer.epoch == 2:
            raise Stop

    cut = Trainer(fresh(), overrides=_overrides(data, tmp_path / "cut", **over))
    cut.add_callback("on_train_epoch_start", stop_at_third)
    with pytest.raises(Stop):
        cut.train()
    resumed = Trainer(fresh(), overrides={**_overrides(data, tmp_path / "cut", **over),
                                          "resume": True})
    resumed.train()
    assert resumed.step.mosaic_p == full.step.mosaic_p == 0.0
    want, got = _rows(tmp_path / "full" / "results.csv"), _rows(tmp_path / "cut" / "results.csv")
    assert len(got) == len(want) == 3
    for k in want[2]:
        if not k.endswith("img_s"):
            assert float(got[2][k]) == pytest.approx(float(want[2][k]), rel=1e-6, abs=1e-9), k
    for a, b in zip(resumed.model.state_dict().values(), full.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)

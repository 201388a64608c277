"""Port parity: the bf16 arithmetic (the JAX package's default, bf16 operands
with fp32 accumulation) against the JAX package on the CPU.

* The plain bf16 ViL layer (``vil_layer_ref`` on bf16 x and conv_act)
  against the layer-fused Pallas kernel in interpret mode at
  ``mxu_dtype="bfloat16"``: within 1e-3 of the output's max (it rounds at
  the same points, so the two agree to the bit here); the fp32 plain layer
  is at least 2e-3 from it, so the test tells the two arithmetics apart.
* The plain bf16 chunkwise backward (``mlstm_chunkwise_bwd_plain`` on bf16
  q/k/v) against the Pallas backward kernel in interpret mode at
  ``mxu_dtype="bfloat16"``: each gradient within a quarter of the gap this
  test measures between that kernel at fp32 and at bf16. dq/dk/dv come
  back in bf16 on both sides; the port's are held before that rounding,
  beyond half a bf16 ulp of the JAX value (two correct roundings of fp32
  values that differ in their last bits can land a whole bf16 ulp apart,
  2^-7 of the element, more than a quarter of dv's gap at its largest
  element).
* The bf16 layer's hand backward (``vil_layer_bwd_ref``) against
  ``jax.vjp`` of the interpret-mode bf16 layer: each gradient (those of x
  and conv_act rounded to bf16, as the port's autograd returns them)
  within a relative L2 error of 1e-3, and the fp32 backward at least ten
  times further in the median over the gradients. XLA on the CPU has no
  kernel for a bf16 x bf16 -> fp32 dot, which the JAX backward's einsums
  ask for; the test runs them on the operands widened to fp32, which is
  the same arithmetic (a product of two bf16 values is exact in fp32).
* One AMP train step of a small ViL-YOLO (vil_yolon at 64 px, batch 2)
  against the JAX step ``Trainer._build_step`` builds with ``dtype:
  bfloat16`` on the same weights: each loss term within 2e-2 relative;
  every parameter gradient fp32; the ViL stages' inputs bf16. The
  gradients of a bf16 step are dominated by its rounding here: JAX's own
  bf16 step is about 0.2 (relative L2, the model's gradient as one vector)
  from its fp32 step, and a per-tensor agreement of 5e-2 does not hold
  between any two bf16 steps that round in a different order (behind each
  train-mode BatchNorm a weight's gradient is the small part of a large one
  that the normalization leaves). The port's AMP gradient is therefore held
  to that noise floor: within twice the distance between the port's fp32
  step (which matches JAX's fp32 step to 1e-4, ``test_torch_model.py``) and
  JAX's bf16 step.
* bf16 serving through ``Predictor(dtype="bfloat16")`` against the JAX
  ``bench.py`` pipeline with bf16 parameters (bf16 letterbox, forward,
  decode, fixed-shape NMS): candidate boxes within 5e-3 of their max and
  scores within 2e-2, each also within twice the JAX pipeline's own
  bf16-vs-fp32 gap; and the detections as sets (class, IoU above 0.9,
  score within 2e-2), at least 90% of either side's found in the other
  (a bf16 score that lands on the other side of the confidence threshold,
  or an IoU at the suppression threshold, can add or drop one).
"""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_model import _perturb
from test_torch_train import _labels
from test_torch_vil_layer import NAMES, layer_args
from xlstm_yolo_tpu.kernels.mlstm_pallas import mlstm_vil_layer_fused_pallas
from xlstm_yolo_tpu.kernels.mlstm_pallas_bwd import mlstm_chunkwise_pallas_bwd
from xlstm_yolo_tpu.nn.fuse import fuse_conv_bn as jax_fuse
from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_tpu.ops.letterbox import letterbox_device as jax_letterbox
from xlstm_yolo_tpu.ops.nms import non_max_suppression as jax_nms
from xlstm_yolo_torch.engine.predictor import Predictor
from xlstm_yolo_torch.engine.trainer import TrainStep
from xlstm_yolo_torch.kernels.mlstm_bwd import _natural, mlstm_chunkwise_bwd_plain
from xlstm_yolo_torch.kernels.vil_cell import Cfg
from xlstm_yolo_torch.kernels.vil_layer import _layer_plain, vil_layer_bwd_ref, vil_layer_ref
from xlstm_yolo_torch.nn.fuse import fuse_conv_bn
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables, port_named

BF = jnp.bfloat16


def _b16(a):
    """numpy fp32 -> its bf16 values, still fp32."""
    return np.array(jnp.asarray(a).astype(BF).astype(jnp.float32))


def _bf16_layer_inputs():
    a = layer_args(S=256)
    x16, c16 = _b16(a["x"]), _b16(a["conv"])
    j = [jnp.asarray(a[n]) for n in NAMES]
    j[0], j[1] = jnp.asarray(x16).astype(BF), jnp.asarray(c16).astype(BF)
    t = [torch.from_numpy(a[n]) for n in NAMES]
    t32 = list(t)
    t[0], t[1] = torch.from_numpy(x16).bfloat16(), torch.from_numpy(c16).bfloat16()
    t32[0], t32[1] = torch.from_numpy(x16), torch.from_numpy(c16)
    return j, t, t32


def _jax_layer(*args):
    return mlstm_vil_layer_fused_pallas(*args, 2, chunk_size=128, interpret=True,
                                        mxu_dtype="bfloat16")


def test_plain_bf16_layer_matches_jax_bf16_kernel():
    j, t, t32 = _bf16_layer_inputs()
    want = np.asarray(_jax_layer(*j).astype(jnp.float32))
    got = vil_layer_ref(*t, 2, chunk_size=128)
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= 1e-3 * scale
    fp32 = vil_layer_ref(*t32, 2, chunk_size=128).numpy()
    assert np.abs(fp32 - want).max() >= 2e-3 * scale


def test_plain_bf16_chunkwise_bwd_matches_jax_bf16_kernel():
    rng = np.random.default_rng(0)
    B, NH, S, DH = 2, 2, 256, 64
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v = (_b16(mk(B, NH, S, DH)) for _ in range(3))
    dh = mk(B, NH, S, DH)
    i, f = mk(B, NH, S), mk(B, NH, S) + 3.0

    def jax_grads(mxu, dt):
        c = lambda x: jnp.asarray(x).astype(dt)
        out = mlstm_chunkwise_pallas_bwd(c(q), c(k), c(v), jnp.asarray(i), jnp.asarray(f),
                                         jnp.asarray(dh), chunk_size=128, interpret=True,
                                         mxu_dtype=mxu)
        return [np.asarray(o.astype(jnp.float32)) for o in out]

    want16, want32 = jax_grads("bfloat16", BF), jax_grads("float32", jnp.float32)
    nat = lambda x: _natural(torch.from_numpy(x)).bfloat16()
    args = (nat(q), nat(k), nat(v), torch.from_numpy(i), torch.from_numpy(f),
            _natural(torch.from_numpy(dh)), NH)
    got16 = mlstm_chunkwise_bwd_plain(*args, chunk_size=128)
    assert [g.dtype for g in got16] == [torch.bfloat16] * 3 + [torch.float32] * 2
    got = mlstm_chunkwise_bwd_plain(*args, chunk_size=128, keep_fp32=True)
    heads = lambda g: (g.float().reshape(B, S, NH, DH).transpose(1, 2) if g.dim() == 3
                       and g.shape[1] == S else g).numpy()
    for name, g, w16, w32 in zip(("dq", "dk", "dv", "di", "df"), got, want16, want32):
        scale = np.abs(w16).max()
        gap = np.abs(w32 - w16).max() / scale
        err = np.abs(heads(g) - w16)
        if name in ("dq", "dk", "dv"):  # beyond the bf16 output's own rounding
            _, e = np.frexp(np.abs(w16))
            err = np.clip(err - 0.5 * np.ldexp(1.0, e - 8), 0, None)
        assert err.max() / scale <= gap / 4, name


def _einsum_widened(einsum):
    """jnp.einsum with bf16 operands widened to fp32 where fp32 results are
    asked for (``preferred_element_type``): XLA on the CPU has no bf16 x
    bf16 -> fp32 dot; the widened product is the same arithmetic."""
    def call(*args, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            args = [x.astype(jnp.float32) if getattr(x, "dtype", None) == BF else x
                    for x in args]
        return einsum(*args, preferred_element_type=preferred_element_type, **kw)
    return call


def test_bf16_layer_hand_backward_matches_jax_vjp():
    j, t, t32 = _bf16_layer_inputs()
    g = _b16(np.random.default_rng(9).normal(size=tuple(j[0].shape)).astype(np.float32))
    with mock.patch.object(jnp, "einsum", _einsum_widened(jnp.einsum)):
        _, vjp = jax.vjp(_jax_layer, *j)
        want = [np.asarray(w.astype(jnp.float32)) for w in vjp(jnp.asarray(g).astype(BF))]
    l2 = lambda u, w: np.linalg.norm(u - w) / np.linalg.norm(w)
    errs16, errs32 = [], []
    for args, errs in ((t, errs16), (t32, errs32)):
        _, acts = _layer_plain(args, Cfg(2, 128))
        grads = vil_layer_bwd_ref(args, acts, torch.from_numpy(g), 2, chunk_size=128)
        for name, arg, got, w in zip(NAMES, args, grads, want):
            if name != "bd":  # the output gradient's sum: exact in both
                errs.append(l2(got.to(arg.dtype).float().numpy(), w))
    assert max(errs16) <= 1e-3, dict(zip(NAMES, errs16))
    assert np.median(errs32) >= 10 * np.median(errs16)


@pytest.fixture(scope="module")
def vil():
    """JAX vil_yolon variables as ``test_torch_train.py`` seeds them."""
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


def test_amp_step_matches_jax_bf16_step(vil):
    jm, v = vil
    imgs = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    cb, mask = _labels()

    def loss_fn(p, img):  # Trainer._build_step's train_step under amp, before the update
        batch = {"img": img, "cls_boxes": jnp.asarray(cb), "mask": jnp.asarray(mask)}
        (total, aux), _ = jm.loss({"params": p, "batch_stats": v["batch_stats"]}, batch,
                                  train=True)
        return total, aux

    img16 = (jnp.asarray(imgs).astype(jnp.float32) / 255.0).astype(BF)
    (jtotal, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"],
                                                                                 img16)
    want = port_named(flatten_variables(jgrads))
    batch = {"img": torch.from_numpy(imgs), "cls_boxes": torch.from_numpy(cb),
             "mask": torch.from_numpy(mask)}
    steps = {}
    for amp in (True, False):
        model = load_jax_variables(TaskModel("vil_yolon.yaml", device="cpu"),
                                   flatten_variables(v))
        vil_inputs = []
        for m in model.modules():
            if type(m).__name__ == "ViLBlockPairBlock":
                m.register_forward_pre_hook(lambda mod, inp: vil_inputs.append(inp[0].dtype))
        step = TrainStep(model, amp=amp)
        total, aux = step.forward_loss(batch)
        step.backward(total)
        grads = {n: p.grad for n, p in model.named_parameters()}
        steps[amp] = (float(total.detach()), {k: float(x.detach()) for k, x in aux.items()},
                      grads, vil_inputs)

    total, aux, grads, vil_inputs = steps[True]
    assert vil_inputs == [torch.bfloat16] * 3
    assert all(g.dtype == torch.float32 for g in grads.values())
    for name, got in (("total", total), *aux.items()):
        ref = float(jtotal) if name == "total" else float(jaux[name])
        assert abs(got - ref) <= 2e-2 * abs(ref), name
    flat = lambda d: np.concatenate([np.asarray(d[n]).ravel() for n in want])
    w = flat(want)
    dist = lambda d: np.linalg.norm(flat(d) - w) / np.linalg.norm(w)
    amp_dist = dist({n: g.numpy() for n, g in grads.items()})
    fp32_dist = dist({n: g.numpy() for n, g in steps[False][2].items()})
    assert amp_dist <= 2 * fp32_dist, (amp_dist, fp32_dist)


def _match_fraction(dets_a, valid_a, dets_b, valid_b):
    """The share of a's detections (xyxy, score, class) that b has: same
    class, IoU above 0.9, score within 2e-2."""
    found = total = 0
    for da, va, db, vb in zip(dets_a, valid_a, dets_b, valid_b):
        a, b = da[va], db[vb]
        total += len(a)
        for box in a:
            same = b[(b[:, 5] == box[5]) & (np.abs(b[:, 4] - box[4]) <= 2e-2)]
            if len(same) == 0:
                continue
            lt = np.maximum(same[:, :2], box[:2])
            rb = np.minimum(same[:, 2:4], box[2:4])
            inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
            area = lambda x: np.prod(x[..., 2:4] - x[..., :2], axis=-1)
            found += bool((inter / (area(same) + area(box) - inter) > 0.9).any())
    return found / max(total, 1)


def test_bf16_predictor_matches_jax_bench_pipeline():
    jm = JaxTaskModel("vil_yolon.yaml")
    v = _perturb(jax.jit(lambda: jm.init(0, imgsz=64))(), seed=0)
    vf = jax_fuse(v)
    vb = {"params": jax.tree.map(lambda x: x.astype(BF), vf["params"]),  # bench.py's cast
          "batch_stats": vf["batch_stats"]}
    frames = np.random.default_rng(3).integers(0, 256, (2, 54, 81, 3), dtype=np.uint8)
    x16, _ = jax_letterbox(jnp.asarray(frames), imgsz=64)  # bf16, as bench.py's one()
    x32, _ = jax_letterbox(jnp.asarray(frames), imgsz=64, dtype_name="float32")
    want = np.asarray(jax.jit(jm.predictions)(vb, x16))
    want32 = np.asarray(jax.jit(jm.predictions)(vf, x32))
    # bench.py's fast_sel ranks bf16-rounded scores with approx_max_k, whose order among
    # equal scores is the backend's: the exact-top-k form of the same rule, as
    # test_torch_model.py holds the fp32 predictor
    rounded = jnp.asarray(want).at[..., 4:].set(jnp.asarray(want[..., 4:]).astype(BF)
                                                .astype(jnp.float32))
    jd, jv = jax_nms(rounded, conf_thres=0.25, iou_thres=0.7, max_det=300, pre_topk=512)

    model = fuse_conv_bn(load_jax_variables(TaskModel("vil_yolon.yaml", device="cpu"),
                                            flatten_variables(v)))
    td, tv, cands, _ = Predictor(model, imgsz=64, dtype="bfloat16")(frames)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert cands.dtype == torch.float32 and td.shape == (2, 300, 6)
    got = cands.numpy()
    box_err = np.abs(got[..., :4] - want[..., :4]).max() / np.abs(want[..., :4]).max()
    box_gap = np.abs(want32[..., :4] - want[..., :4]).max() / np.abs(want[..., :4]).max()
    score_err = np.abs(got[..., 4:] - want[..., 4:]).max()
    score_gap = np.abs(want32[..., 4:] - want[..., 4:]).max()
    assert box_err <= min(5e-3, 2 * box_gap) and score_err <= min(2e-2, 2 * score_gap)
    jd, jv, td, tv = np.asarray(jd), np.asarray(jv), td.numpy(), tv.numpy()
    assert jv.sum() > 0 and tv.sum() > 0
    assert _match_fraction(jd, jv, td, tv) >= 0.9 and _match_fraction(td, tv, jd, jv) >= 0.9

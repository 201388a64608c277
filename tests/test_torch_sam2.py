"""Port parity: SAM2 and TinyViT (``xlstm_yolo_torch/models_sam2.py``)
against the JAX ``xlstm_yolo_tpu/models_sam2.py``.

On the CPU, fp32, torch on one thread, on one seeded JAX tree of
``SAM2(img_size=128, embed_dim=32)`` (every parameter noised,
``maskmem_tpos_enc`` included) loaded into the port through
``load_jax_variables``; the JAX side compiled at XLA's lowest backend
optimization level (``test_torch_sam.LowOpt``). Tolerances: maps, masks, IoU
and memories within ``TOL`` = 1e-4 of each output's own max; the ring
buffer's ages, validity and pointer equal; boolean masks by
``test_torch_sam.assert_bool_near``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_sam import LowOpt, assert_bool_near, assert_close
from test_torch_yolo11 import one_thread, seeded_variables  # noqa: F401
from xlstm_yolo_tpu import models_sam2 as J2
from xlstm_yolo_torch import models_sam2 as T2
from xlstm_yolo_torch.models_sam import letterbox_meta_prompts
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables

S, M, MEM = 128, 7, 64
HW = (S // 16) ** 2


def track_step_fn(jm):
    return LowOpt(lambda v, x, b, a, va, p, lab: jm.apply(v, x, b, a, va, p, lab,
                                                          method=jm.track_step))


@pytest.fixture(scope="module")
def sam2():
    """(JAX SAM2, its seeded variables, the port on them, the compiled JAX
    track step)."""
    jm = J2.SAM2(img_size=S, embed_dim=32)
    v = seeded_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), jnp.zeros((1, M, HW, MEM)),
        jnp.zeros((1, M), jnp.int32), jnp.zeros((1, M), bool), None, None,
        method=jm.track_step), 0)
    tm = load_jax_variables(T2.SAM2(img_size=S, embed_dim=32, device="cpu"),
                            flatten_variables(v))
    return jm, v, tm, track_step_fn(jm)


def image(seed, b=1, hw=(S, S)):
    return np.random.default_rng(seed).random((b, *hw, 3)).astype(np.float32)


def test_hiera_fpn_and_encoder_match_jax(sam2):
    """The four Hiera levels (strides 4-32), the FPN's four maps and the
    stride-16 map ``encode_image`` returns."""
    jm, v, tm, _ = sam2
    x = image(1, b=2)
    levels, fpn = LowOpt(lambda v, x: jm.apply(
        v, x, method=lambda m, x: (m.trunk(x), m.neck(m.trunk(x)))))(v, jnp.asarray(x))
    with torch.no_grad():
        t_levels = tm.trunk(torch.from_numpy(x))
        t_fpn = tm.neck(t_levels)
        enc = tm.encode_image(torch.from_numpy(x))
    assert [tuple(t.shape) for t in t_levels] == [(2, 32, 32, 32), (2, 16, 16, 64),
                                                  (2, 8, 8, 128), (2, 4, 4, 256)]
    for i, (a, b) in enumerate(zip(t_levels, levels)):
        assert_close(a, b, what=f"hiera level {i}")
    for i, (a, b) in enumerate(zip(t_fpn, fpn)):
        assert_close(a, b, what=f"fpn {i}")
    assert torch.equal(enc, t_fpn[2])


@pytest.mark.parametrize("hw,dim", [((8, 8), 256), ((5, 7), 64), ((64, 64), 256)])
def test_sine_pe_matches_jax(hw, dim):
    """Within 1e-5: at 64 x 64 the sines of arguments up to 63 differ by an
    fp32 ulp of the argument between torch and XLA."""
    assert_close(T2.sine_pe_2d(*hw, dim), J2.sine_pe_2d(*hw, dim), tol=1e-5)


@pytest.mark.parametrize("n_in,n_out", [(14, 32), (14, 256), (14, 7), (7, 7)])
def test_bicubic_resize_matches_jax_matrix(n_in, n_out):
    """torch's own bicubic (kept in the port) against the JAX matrix form of
    it, ``_bicubic_resize_torch``."""
    x = np.random.default_rng(n_out).normal(size=(1, n_in, n_in, 8)).astype(np.float32)
    want = J2._bicubic_resize_torch(jnp.asarray(x), n_out, n_out)
    assert_close(T2.bicubic_resize(torch.from_numpy(x), n_out, n_out), want, tol=1e-6)


def memory(seed, b=2):
    rng = np.random.default_rng(seed)
    bank = rng.normal(size=(b, M, HW, MEM)).astype(np.float32)
    age = rng.integers(0, M + 3, (b, M)).astype(np.int32)  # ages past M - 1 clip
    return bank, age


@pytest.mark.parametrize("valid", ["none", "some", "mixed"])
def test_track_step_matches_jax(sam2, valid):
    """``track_step`` with a point: no valid slot and some valid slots at
    batch 1 (the video predictor's prompt-frame signature), and at batch 2
    one row of each (the where that gives ``x + no_mem_embed``): masks, IoU
    and the new memory."""
    jm, v, tm, step = sam2
    va = {"none": np.zeros((1, M), bool),
          "some": np.asarray([[1, 0, 1, 1, 0, 0, 1]], bool),
          "mixed": np.asarray([[0] * M, [1, 1, 0, 1, 0, 1, 1]], bool)}[valid]
    b = len(va)
    bank, age = memory(2, b)
    pts = np.asarray([[[30.0, 40.0]], [[100.0, 20.0]]], np.float32)[:b]
    lab = np.asarray([[1.0], [0.0]], np.float32)[:b]
    x = image(3, b=b)
    want = step(v, jnp.asarray(x), bank, age, va, pts, lab)
    with torch.no_grad():
        got = tm.track_step(*(torch.from_numpy(a) for a in (x, bank, age, va, pts, lab)))
    for a, w, what in zip(got, want, ("masks", "iou", "new memory")):
        assert torch.isfinite(a).all()
        assert_close(a, w, what=what)


def test_memory_attention_with_no_valid_slot_is_finite(sam2):
    """A row whose every key is masked: flax's ``finfo.min`` logits give
    uniform weights, finite, and equal to JAX's."""
    jm, v, tm, _ = sam2
    rng = np.random.default_rng(4)
    x, x_pe = (rng.normal(size=(2, HW, 256)).astype(np.float32) for _ in range(2))
    mem, mem_pe = (rng.normal(size=(2, 3 * HW, MEM)).astype(np.float32) for _ in range(2))
    mask = np.zeros((2, 3 * HW), bool)
    mask[1, HW:] = True
    want = LowOpt(lambda v, *a: jm.apply(v, method=lambda m: m.memory_attention(*a)))(
        v, x, x_pe, mem, mem_pe, mask)
    with torch.no_grad():
        got = tm.memory_attention(*(torch.from_numpy(a) for a in (x, x_pe, mem, mem_pe, mask)))
    assert torch.isfinite(got).all()
    assert_close(got, want, what="memory attention")


def jax_video(jm, v, step):
    jp = J2.SAM2VideoPredictor(jm, v, img_size=S)
    jp._step = step
    return jp


def test_video_predictor_matches_jax(sam2):
    """``SAM2VideoPredictor.track`` over 5 non-square frames, a point on the
    first: each mask, and the bank, ages, validity and pointer after every
    frame (slot 0 kept, slots 1.. cycling)."""
    jm, v, tm, step = sam2
    jp = jax_video(jm, v, step).init_state()
    tp = T2.SAM2VideoPredictor(tm, img_size=S).init_state()
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (96, 120, 3), dtype=np.uint8) for _ in range(5)]
    for i, f in enumerate(frames):
        kw = {"points": [[48, 40]]} if i == 0 else {}
        want, got = jp.track(f, **kw), tp.track(f, **kw)
        assert got.shape == (S // 4, S // 4)
        assert_close(got, want, what=f"mask {i}")
        js, ts = jp._state, tp._state
        assert_close(ts["bank"], js["bank"], what=f"bank {i}")
        assert np.array_equal(ts["age"].numpy(), np.asarray(js["age"]))
        assert np.array_equal(ts["valid"].numpy(), np.asarray(js["valid"]))
        assert ts["ptr"] == js["ptr"]
    assert tp._state["ptr"] == 4 and tp._state["valid"][0, :5].all()


def test_sam2_predictor_matches_jax(sam2):
    """``SAM2Predictor`` on a non-square uint8 image with a point."""
    import cv2

    jm, v, tm, _ = sam2
    img = np.random.default_rng(6).integers(0, 256, (90, 140, 3), dtype=np.uint8)
    jp = J2.SAM2Predictor(jm, v, img_size=S)
    jp._inner._encode = LowOpt(lambda v, x: jm.apply(v, x, method=jm.encode_image))
    jp._inner._decode = LowOpt(lambda v, e, p, lab, bx: jm.apply(v, e, p, lab, bx,
                                                                 method=jm.decode))
    tp = T2.SAM2Predictor(tm, img_size=S)
    jp.set_image(img)
    tp.set_image(img)
    wm, wi = jp.predict(points=[[70, 40]], point_labels=[1])
    gm, gi = tp.predict(points=[[70, 40]], point_labels=[1])
    assert_close(gi, wi, what="iou")
    inner = jp._inner
    _, px, py = inner._meta
    p, lab, _ = letterbox_meta_prompts(inner._meta, [[70, 40]], [1])
    masks = np.asarray(inner._decode(v, inner._embed, p, lab, None)[0][0])
    for k, m in enumerate(masks):
        full = cv2.resize(m, (S, S), interpolation=cv2.INTER_LINEAR)
        crop = full[int(py):S - int(py) or None, int(px):S - int(px) or None]
        f = cv2.resize(crop, (140, 90), interpolation=cv2.INTER_LINEAR)
        assert_bool_near(gm[k], wm[k], f, what=f"mask {k}")


def test_tinyvit_matches_jax():
    """TinyViT at dims (16, 32, 48): the query normalized, keys and values
    not; windows padded at every stage (32, 16, 8 over window 7)."""
    jm = J2.TinyViT(dims=(16, 32, 48), depths=(1, 1, 2), num_heads=(1, 2, 3))
    x = image(7)
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    tm = load_jax_variables(T2.TinyViT(dims=(16, 32, 48), depths=(1, 1, 2), num_heads=(1, 2, 3),
                                       device="cpu"), flatten_variables(v))
    want = LowOpt(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (1, S // 16, S // 16, 256)
    assert_close(got, want, what="tinyvit")


def test_sam2_seeded_init_follows_flax():
    m = T2.SAM2(img_size=64, embed_dim=16, device="cpu", seed=2)
    with torch.no_grad():
        assert not m.maskmem_tpos_enc.any()
        assert 0.01 < float(m.no_mem_embed.std()) < 0.03
        assert 0.01 < float(m.trunk.pos_embed_window.std()) < 0.03
        assert not m.trunk.b0.attn.qkv.bias.any()

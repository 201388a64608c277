"""Port parity: the YOLO11 blocks, head and detector against the JAX package.

On the CPU, NHWC for JAX and NCHW for the port, tolerance 1e-4 of each
output's max (fp32, summation order only):

* ``C3k``, ``C3k2`` (with Bottleneck and with C3k inside), ``Attention`` (two
  heads, so the channel order of q, k, v and of the positional conv's input
  shows), ``PSABlock``, ``C2PSA`` and ``Detect(legacy=False)``, each
  on seeded numpy variables in the JAX tree's structure (BatchNorm variances
  kept positive), loaded into the port in eval mode;
* ``yolo11n`` (``cfg/models/yolo11.yaml`` at scale n): its parameter count
  equal to the JAX ``TaskModel``'s and its predictions at 64 px, on the
  port's seeded init (perturbed) carried to a JAX tree through
  ``jax.eval_shape`` (a jitted JAX init costs seconds); one train-mode
  forward, v8 loss and backward: the loss and every gradient within 1e-3
  (rtol, with an atol of 1e-3 times the model's largest gradient).

Torch runs on one thread (module fixture), so the file stays fast under
parallel workers.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xlstm_yolo_tpu.nn import heads as JH
from xlstm_yolo_tpu.nn import modules as JM
from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_torch.nn import heads as TH
from xlstm_yolo_torch.nn import modules as TM
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils.jax_weights import (
    flatten_variables, load_jax_variables, port_named, torch_name)

TOL_REL = 1e-4
YOLO11N_PARAMS = 2_624_064  # Ultralytics' 2,624,080 less the functional DFL's 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(got, want, tol=TOL_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def seeded_variables(init_fn, seed):
    """Seeded numpy values for the variable tree ``init_fn`` would build
    (its structure from ``jax.eval_shape``; a jitted init costs seconds):
    kernels normal over sqrt(fan_in), BatchNorm variances in [0.5, 1.5),
    scales near one, other leaves small."""
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        key, shape = getattr(path[-1], "key", ""), sds.shape
        if key == "kernel":
            x = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif key == "var":
            x = rng.uniform(0.5, 1.5, shape)
        elif key == "scale":
            x = 1 + 0.1 * rng.normal(size=shape)
        else:
            x = 0.1 * rng.normal(size=shape)
        return jnp.asarray(x.astype(np.float32))

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn))


def nhwc(seed, b=2, hw=8, c=32):
    return np.random.default_rng(seed).normal(size=(b, hw, hw, c)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def check_block(jm, tm, x, seed):
    """A JAX block and its port on ``x`` (NHWC), the port in eval mode."""
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed)
    tm = load_jax_variables(tm, flatten_variables(v)).eval()
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree.leaves(v["params"]))
    want = jax.jit(lambda v, x: jm.apply(v, x))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x))
    assert_close(got.numpy().transpose(0, 2, 3, 1), want)


@pytest.mark.parametrize("k", [3, 5])
def test_c3k_matches_jax(k):
    check_block(JM.C3k(48, n=2, k=k), TM.C3k(32, 48, n=2, k=k), nhwc(0), 0)


@pytest.mark.parametrize("c3k", [False, True], ids=["bottleneck", "c3k"])
def test_c3k2_matches_jax(c3k):
    """The inner Bottleneck keeps e=0.5 (C2f's is 1.0)."""
    tm = TM.C3k2(32, 64, n=2, c3k=c3k, e=0.25)
    if not c3k:
        assert tm.m0.cv1.conv.out_channels == 8  # int(16 * 0.5)
    check_block(JM.C3k2(64, n=2, c3k=c3k, e=0.25), tm, nhwc(1), 1)


def test_attention_matches_jax():
    """dim 64, two heads: head dim 32, key dim 16."""
    check_block(JM.Attention(64, num_heads=2), TM.Attention(64, num_heads=2),
                nhwc(2, c=64, hw=6), 2)


def test_psa_block_matches_jax():
    check_block(JM.PSABlock(64, num_heads=2), TM.PSABlock(64, num_heads=2),
                nhwc(3, c=64, hw=5), 3)


def test_c2psa_matches_jax():
    """c2 256: PSABlocks of 128 channels, two heads each."""
    tm = TM.C2PSA(256, 256, n=2)
    assert tm.m0.attn.num_heads == 2
    check_block(JM.C2PSA(256, n=2), tm, nhwc(4, c=256, hw=4), 4)


def test_detect_depthwise_head_matches_jax():
    ch, nc = (16, 32, 64), 5
    feats = [nhwc(5 + i, hw=8 >> i, c=c) for i, c in enumerate(ch)]
    jm = JH.Detect(nc=nc, ch=ch, legacy=False)
    jfeats = [jnp.asarray(f) for f in feats]
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jfeats), 5)
    tm = load_jax_variables(TH.Detect(nc=nc, ch=ch, legacy=False), flatten_variables(v)).eval()
    assert hasattr(tm, "cv3_0_1_0") and not hasattr(tm, "cv3_0_1")
    want = jax.jit(jm.apply)(v, jfeats)
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    for (gb, gc), (wb, wc) in zip(got, want):
        assert_close(gb.numpy().transpose(0, 2, 3, 1), wb)
        assert_close(gc.numpy().transpose(0, 2, 3, 1), wc)


@pytest.fixture(scope="module")
def yolo11n():
    """(JAX model, JAX variables, port model): the port's seeded init with
    seeded noise on every parameter and BatchNorm statistic, carried to the
    JAX tree through ``torch_name``'s layouts run backwards."""
    tm = TaskModel("yolo11n.yaml", device="cpu")
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, t in tm.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            elif t.is_floating_point():
                t.add_(torch.from_numpy(0.05 * rng.normal(size=tuple(t.shape)).astype(np.float32)))
    jm = JaxTaskModel("yolo11n.yaml")
    state = tm.state_dict()

    def leaf(path, sds):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        idx = np.arange(int(np.prod(sds.shape))).reshape(sds.shape)
        name, where = torch_name(key, idx)
        out = np.empty(idx.size, np.float32)
        out[where.reshape(-1)] = state[name].numpy().reshape(-1)
        return jnp.asarray(out.reshape(sds.shape))

    v = jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(lambda: jm.init(0, imgsz=64)))
    return jm, v, tm


def test_yolo11n_param_count_and_strides_match_jax(yolo11n):
    jm, v, tm = yolo11n
    assert tm.num_params() == jm.num_params(v) == YOLO11N_PARAMS
    assert tm.strides == (8, 16, 32)
    det = getattr(tm, f"l{tm.parsed.head_index}")
    assert det.legacy is False and tm.scale == "n"


def test_yolo11n_predictions_match_jax(yolo11n):
    jm, v, tm = yolo11n
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(jm.predictions)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval().predictions(torch.from_numpy(x))
    assert got.shape == (2, 84, 84)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_REL, atol=TOL_REL)


def test_yolo11n_train_step_loss_and_grads_match_jax(yolo11n):
    """Train-mode forward (batch statistics), the v8 loss and its
    gradients."""
    jm, v, tm = yolo11n
    imgs = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    cb = np.zeros((2, 32, 5), np.float32)
    mask = np.zeros((2, 32), bool)
    cb[0, :2] = [[1, 10, 10, 40, 50], [3, 30, 5, 60, 30]]
    cb[1, :2] = [[1, 10, 10, 40, 50], [7, 2, 20, 30, 62]]
    mask[:, :2] = True
    jbatch = {"img": jnp.asarray(imgs), "cls_boxes": jnp.asarray(cb), "mask": jnp.asarray(mask)}

    @jax.jit
    def jloss(params):
        (total, _), _ = jm.loss({"params": params, "batch_stats": v["batch_stats"]}, jbatch,
                                train=True)
        return total

    jtotal, jgrads = jax.value_and_grad(jloss)(v["params"])
    tm = copy.deepcopy(tm).train()  # leave the fixture's BatchNorm statistics as they are
    total, _ = tm.loss({"img": torch.from_numpy(imgs), "cls_boxes": torch.from_numpy(cb),
                        "mask": torch.from_numpy(mask)})
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-3)
    want = port_named(flatten_variables(jgrads))
    gmax = max(np.abs(g).max() for g in want.values())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-3, atol=1e-3 * gmax,
                                   err_msg=name)

"""Port parity: stochastic depth and the standalone ViL classifier against the
JAX package.

Seeded numpy inputs on the CPU through the JAX modules and the port's, on
the same weights (``load_jax_variables``). Small sizes: dim 32, depth 2-3,
patch 8, 32 px images (a 4x4 token grid), head dim 16.

Stochastic depth: flax draws its masks with ``jax.random.bernoulli`` keyed
by module path, which torch cannot reproduce. The tests draw the masks as
the port documents it (one ``torch.rand(B, generator) < keep`` per active
DropPath, in call order) and hand the same masks to the JAX side by
replacing ``jax.random.bernoulli`` for the duration of the call.

Tolerances. Forward outputs: 1e-4 of the output's max (fp32; summation
order and chunking differ). Gradients: the port's ViL layers take the hand
backward (frozen stabilizer) while JAX on the CPU differentiates the native
form, so gradient cases keep the gate kernels at their init (zero): every
gradient but the gate kernels' and biases' at 1e-4 (rtol, atol 1e-4 of the
model's largest gradient), ``igate``/``fgate`` at 2e-2 of each tensor's max
(the dropped normalizer-floor terms).
"""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xlstm_yolo_tpu.nn import vil as JV
from xlstm_yolo_tpu.nn.vil_extra import VisionLSTM2 as JaxVisionLSTM2
from xlstm_yolo_tpu.utils.loss import classification_loss as jax_classification_loss
from xlstm_yolo_torch.kernels.mlstm_bwd import mlstm_chunkwise_bwd
from xlstm_yolo_torch.kernels.vil_cell import vil_cell_fwd, vil_cell_plain
from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd
from xlstm_yolo_torch.nn import vil as TV
from xlstm_yolo_torch.nn.vil_extra import VisionLSTM2, drop_path_rates
from xlstm_yolo_torch.nn.xlstm import xLSTMLMModel
from xlstm_yolo_torch.utils.jax_weights import (
    flatten_variables, load_jax_variables, port_named)
from xlstm_yolo_torch.utils.loss import classification_loss
from xlstm_yolo_torch.utils.train_utils import StepUpdate

SMALL = dict(dim=32, depth=3, patch_size=8, output_shape=(5,), qkv_block_size=16, chunk_size=8)


def close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def perturbed(variables, rng, gates=True):
    """Seeded noise on every leaf, so that every parameter matters;
    ``gates=False`` leaves the gate kernels at zero."""
    def f(path, p):
        names = [getattr(k, "key", "") for k in path]
        if not gates and names[-1] == "kernel" and names[-2] in ("igate", "fgate"):
            return p
        return p + 0.05 * jnp.asarray(rng.normal(size=p.shape), p.dtype)
    return jax.tree_util.tree_map_with_path(f, variables)


def port_masks(seed, batch, rates):
    """The keep masks the port draws from a generator seeded ``seed``: one
    per positive rate, in order."""
    g = torch.Generator().manual_seed(seed)
    return [(torch.rand(batch, generator=g) < 1.0 - r).numpy() for r in rates if r > 0]


def with_masks(masks):
    """``jax.random.bernoulli`` replaced by the given masks in call order."""
    it = iter(masks)
    return mock.patch.object(jax.random, "bernoulli",
                             lambda key, p, shape: jnp.asarray(next(it)).reshape(shape))


def port(module, variables):
    return load_jax_variables(module, flatten_variables(variables))


def check_grads(model, jax_grads):
    """The port model's ``.grad`` against a JAX gradient tree (see the module
    docstring for the tolerances)."""
    want = port_named(flatten_variables(jax_grads))
    gmax = max(np.abs(w).max() for w in want.values())
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for n, w in want.items():
        if "igate" in n or "fgate" in n:
            assert np.abs(got[n] - w).max() <= 2e-2 * max(np.abs(w).max(), 1e-6 * gmax), n
        else:
            np.testing.assert_allclose(got[n], w, rtol=1e-4, atol=1e-4 * gmax, err_msg=n)


# --- DropPath -------------------------------------------------------------

def test_drop_path_is_identity_in_eval_and_at_rate_zero():
    x = torch.randn(4, 3, 2, generator=torch.Generator().manual_seed(0))
    assert TV.DropPath(0.5).eval()(x) is x
    assert TV.DropPath(0.0).train()(x) is x  # no generator needed either


def test_drop_path_without_generator_raises_in_train_mode():
    with pytest.raises(ValueError):
        TV.DropPath(0.5).train()(torch.zeros(2, 3))


def test_drop_path_kept_and_dropped_samples_match_jax():
    x = np.random.default_rng(0).normal(size=(6, 3, 2)).astype(np.float32)
    (mask,) = port_masks(1, 6, [0.5])
    assert mask.any() and not mask.all()  # both a kept and a dropped sample
    got = TV.DropPath(0.5).train()(torch.from_numpy(x), torch.Generator().manual_seed(1)).numpy()
    np.testing.assert_array_equal(got[~mask], 0.0)
    np.testing.assert_array_equal(got[mask], x[mask] / 0.5)
    jm = JV.DropPath(0.5)
    with with_masks([mask]):
        want = jm.apply({}, jnp.asarray(x), deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(0)})
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("rate,depth,decay,want", [
    (0.3, 4, True, [0.0, 0.1, 0.2, 0.3]), (0.3, 1, True, [0.3]), (0.3, 3, False, [0.3] * 3)])
def test_drop_path_rates_follow_the_jax_schedule(rate, depth, decay, want):
    np.testing.assert_allclose(drop_path_rates(rate, depth, decay), want, rtol=1e-12)


# --- ViLLayer, the branch under stochastic depth --------------------------

LAYER = dict(dim=32, qkv_block_size=16, seqlens=(4, 6), chunk_size=8, drop_path=0.5)
MASK_SEED = 1  # keeps samples 1 and 2 of a batch of 4, drops 0 and 3


def _layer_case(direction, gates, seed=5, batch=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 24, 32)).astype(np.float32)
    jm = JV.ViLLayer(direction=direction, **LAYER)
    v = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng, gates=gates)
    (mask,) = port_masks(MASK_SEED, batch, [0.5])
    assert mask.any() and not mask.all()
    return x, jm, v, mask, port(TV.ViLLayer(direction=direction, **LAYER), v)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_vil_layer_under_drop_path_matches_jax(direction):
    x, jm, v, mask, tm = _layer_case(direction, gates=True)
    with with_masks([mask]):
        want = jm.apply(v, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(1)})
    before = (vil_cell_fwd.launches, vil_layer_fwd.launches)
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(x), generator=torch.Generator().manual_seed(MASK_SEED))
    assert (vil_cell_fwd.launches, vil_layer_fwd.launches) == before  # CPU: no kernel
    close(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[~mask], x[~mask])  # dropped: the residual, exactly


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_vil_layer_under_drop_path_gradients_match_jax(direction):
    x, jm, v, mask, tm = _layer_case(direction, gates=False, seed=6)

    def loss(params, xj):
        out = jm.apply({"params": params}, xj, rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out ** 2)

    with with_masks([mask]):
        gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (tm.train()(xt, generator=torch.Generator().manual_seed(MASK_SEED)) ** 2).sum().backward()
    check_grads(tm, gp)
    close(xt.grad.numpy(), gx)
    # a dropped sample's branch gets no gradient: d sum(x**2) / dx = 2 x
    np.testing.assert_allclose(xt.grad.numpy()[~mask], 2 * x[~mask], rtol=1e-6)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_vil_layer_branches_agree_in_eval(direction):
    x, _, _, _, tm = _layer_case(direction, gates=True, seed=7)
    tm.eval()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        fused = tm(xt)
        other = tm._forward_drop_path(xt, tm.seqlens, direction == "backward", None)
    close(other.numpy(), fused.numpy(), rel=1e-5)


def test_vil_layer_input_gradient_sums_both_paths():
    """x_mlstm feeds the conv (autograd) and the cell's v projection (the
    hand backward), conv_act the cell and the skip: the layer's input and
    parameter gradients equal those of the same layer with the cell's plain
    version under autograd (gate kernels zero, so the two backwards agree)."""
    x, _, _, _, tm = _layer_case("forward", gates=False, seed=8)
    tm.train()
    grads = []
    for patch in (False, True):
        tm.zero_grad()
        xt = torch.from_numpy(x).requires_grad_()
        ctx = mock.patch.object(TV, "vil_cell_fwd", vil_cell_plain) if patch else mock.MagicMock()
        with ctx:
            (tm(xt, generator=torch.Generator().manual_seed(MASK_SEED)) ** 2).sum().backward()
        grads.append({"x": xt.grad.clone(), **{n: p.grad.clone() for n, p in
                                                tm.named_parameters()}})
    hand, auto = grads
    for n, g in auto.items():
        if "igate" not in n and "fgate" not in n:
            np.testing.assert_allclose(hand[n].numpy(), g.numpy(), rtol=1e-4,
                                       atol=1e-5 * float(g.abs().max()) + 1e-7, err_msg=n)


def test_matrix_lstm_cell_block_entry_matches_layer():
    """``forward_block`` (the JAX ``fused_block=`` entry) on the layer's own
    intermediates is the layer."""
    x, _, _, _, tm = _layer_case("forward", gates=True, seed=9)
    tm.eval()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        x_mlstm, z = tm.proj_up(tm.norm(xt)).split(tm.inner, dim=-1)
        conv_act = torch.nn.functional.silu(tm.conv(x_mlstm, tm.seqlens))
        got = tm.mlstm_cell.forward_block(conv_act, x_mlstm, z, xt, tm.q_proj, tm.k_proj,
                                          tm.v_proj, tm.learnable_skip, tm.proj_down)
        close(got.numpy(), tm(xt).numpy(), rel=1e-5)


# --- VisionLSTM2 ----------------------------------------------------------

def _images(seed, batch=2):
    return np.random.default_rng(seed).normal(size=(batch, 32, 32, 3)).astype(np.float32)


def _pair(x, rng, gates=True, **kw):
    """(JAX model, its perturbed variables, the port's model on them)."""
    cfg = {**SMALL, **kw}
    jm = JaxVisionLSTM2(**cfg)
    v = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng, gates=gates)
    return jm, v, port(VisionLSTM2(**cfg, resolution=(32, 32), device="cpu"), v)


@pytest.mark.parametrize("mode", ["classifier", "features"])
@pytest.mark.parametrize("pooling", ["to_image", "bilateral_avg", "bilateral_flatten"])
def test_vision_lstm2_eval_matches_jax(pooling, mode):
    x = _images(1)
    jm, v, tm = _pair(x, np.random.default_rng(2), pooling=pooling, mode=mode,
                      drop_path_rate=0.2)
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape
    close(got.numpy(), want)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        p.size for p in jax.tree_util.tree_leaves(v))


def test_vision_lstm2_bidirectional_eval_matches_jax():
    x = _images(3)
    jm, v, tm = _pair(x, np.random.default_rng(4), depth=2, bidirectional=True)
    with torch.no_grad():
        close(tm(torch.from_numpy(x)).numpy(), jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("decay", [True, False])
def test_vision_lstm2_train_mode_matches_jax_under_the_same_masks(decay):
    x = _images(5, batch=4)
    jm, v, tm = _pair(x, np.random.default_rng(6), drop_path_rate=0.5, drop_path_decay=decay)
    masks = port_masks(9, 4, drop_path_rates(0.5, 3, decay))
    assert len(masks) == (2 if decay else 3)  # block 0 has rate 0 under the decay
    assert not all(m.all() for m in masks)
    with with_masks(masks):
        want = jm.apply(v, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = tm.train()(torch.from_numpy(x), generator=torch.Generator().manual_seed(9))
    close(got.numpy(), want)
    assert np.abs(got.numpy() - np.asarray(jm.apply(v, jnp.asarray(x)))).max() > 1e-3  # not eval


def test_vision_lstm2_train_step_matches_jax():
    """One stochastic-depth step: loss and every gradient against
    ``jax.value_and_grad`` of ``classification_loss`` under the same masks,
    then the update runs and moves the parameters (a gate bias of -10 may
    not move in fp32 under a tiny gradient)."""
    x = _images(8, batch=4)
    labels = np.array([0, 3, 1, 4])
    jm, v, tm = _pair(x, np.random.default_rng(9), gates=False, drop_path_rate=0.5)
    masks = port_masks(9, 4, drop_path_rates(0.5, 3, True))

    def loss(params):
        logits = jm.apply({"params": params}, jnp.asarray(x),
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_classification_loss(logits, jnp.asarray(labels))

    with with_masks(masks):
        want, grads = jax.value_and_grad(loss)(v["params"])
    tm.train()
    update = StepUpdate(tm)
    counts = (vil_layer_fwd.launches, vil_cell_fwd.launches, mlstm_chunkwise_bwd.launches)
    got = classification_loss(tm(torch.from_numpy(x), generator=torch.Generator().manual_seed(9)),
                              torch.from_numpy(labels))
    got.backward()
    assert counts == (vil_layer_fwd.launches, vil_cell_fwd.launches, mlstm_chunkwise_bwd.launches)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    check_grads(tm, grads)
    before = [p.detach().clone() for p in tm.parameters()]
    update(1)
    assert all(torch.isfinite(p).all() for p in tm.parameters())
    moved = sum(not torch.equal(p, b) for p, b in zip(tm.parameters(), before))
    assert moved >= len(before) - 3 * 4  # all but, at most, the gates of the three layers


def test_classification_loss_matches_jax():
    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(6, 9)) * 3).astype(np.float32)
    labels = rng.integers(0, 9, 6)
    want = jax_classification_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = classification_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_vision_lstm_backbone_matches_jax():
    x = _images(12)
    kw = dict(dim=32, depth=3, patch_size=8, output_indices=(0, 1), qkv_block_size=16,
              chunk_size=8)
    jm = JV.VisionLSTMBackbone(resolution=(32, 32), **kw)
    v = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), np.random.default_rng(13))
    tm = port(TV.VisionLSTMBackbone(resolution=(32, 32), device="cpu", **kw), v)
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 4, 4, 32)
        close(g.numpy(), w)


def test_pos_embed_at_another_grid_raises():
    pe = TV.VitPosEmbed2d(8, (4, 4))
    assert pe(torch.zeros(1, 4, 4, 8)).shape == (1, 4, 4, 8)
    with pytest.raises(NotImplementedError):
        pe(torch.zeros(1, 2, 6, 8))
    with pytest.raises(NotImplementedError):  # through the model: 64 px on a 32 px model
        VisionLSTM2(**SMALL, resolution=(32, 32), device="cpu")(torch.zeros(1, 64, 64, 3))


@pytest.mark.parametrize("build", [
    lambda **kw: VisionLSTM2(**SMALL, **kw), lambda **kw: TV.VisionLSTMBackbone(32, depth=1, **kw)],
    ids=["VisionLSTM2", "VisionLSTMBackbone"])
def test_default_device_is_the_card(build):
    if torch.cuda.is_available():
        assert next(build().parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    assert next(build(device="cpu").parameters()).device.type == "cpu"


def test_vision_lstm2_rejects_unknown_mode_and_pooling():
    with pytest.raises(ValueError):
        VisionLSTM2(**SMALL, mode="segment", device="cpu")
    with pytest.raises(ValueError):
        VisionLSTM2(**SMALL, pooling="mean", device="cpu")


def test_loader_still_raises_on_unknown_leaves():
    x = _images(14)
    jm = JaxVisionLSTM2(**SMALL)
    flat = flatten_variables(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    build = lambda: VisionLSTM2(**SMALL, resolution=(32, 32), device="cpu")
    load_jax_variables(build(), flat)  # the tree as it is loads
    with pytest.raises(KeyError, match="extra"):
        load_jax_variables(build(), {**flat, "params/pos_embed/other": np.zeros(3, np.float32)})
    missing = {k: a for k, a in flat.items() if k != "params/norm/bias"}
    with pytest.raises(KeyError, match="missing"):
        load_jax_variables(build(), missing)
    with pytest.raises(KeyError):
        load_jax_variables(build(), {**flat, "cache/pos_embed/embed": np.zeros(3, np.float32)})
    wrong = {**flat, "params/pos_embed/embed": np.zeros((1, 2, 2, 32), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(build(), wrong)


# --- names that must not move ---------------------------------------------

VIL_LAYER_KEYS = [
    "learnable_skip", "norm.scale", "proj_up.weight", "proj_up.bias", "conv.conv.weight",
    "conv.conv.bias", "q_proj.weight", "q_proj.bias", "k_proj.weight", "k_proj.bias",
    "v_proj.weight", "v_proj.bias", "mlstm_cell.igate.weight", "mlstm_cell.igate.bias",
    "mlstm_cell.fgate.weight", "mlstm_cell.fgate.bias", "mlstm_cell.outnorm.scale",
    "mlstm_cell.outnorm.bias", "proj_down.weight", "proj_down.bias"]


@pytest.mark.parametrize("drop_path", [0.0, 0.3])
def test_vil_state_dict_keys_are_unchanged(drop_path):
    pair = TV.ViLBlockPair(32, qkv_block_size=16, bidirectional=True, drop_path=drop_path)
    want = [f"{d}.layer.{k}" for d in ("fwd", "bwd") for k in VIL_LAYER_KEYS]
    assert list(pair.state_dict().keys()) == want


def test_lm_state_dict_keys_are_unchanged():
    lm = xLSTMLMModel(vocab_size=11, embedding_dim=16, num_blocks=1, num_heads=2, device="cpu")
    cell = [k for k in lm.state_dict() if ".mlstm_cell." in k]
    assert cell == [f"stack.block0.xlstm.mlstm_cell.{k}" for k in (
        "igate.weight", "igate.bias", "fgate.weight", "fgate.bias", "outnorm.scale")]

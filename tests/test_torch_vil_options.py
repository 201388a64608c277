"""Port parity: the ViLLayer options (``use_outnorm``, ``proj_bias``) in
every branch, the weight convention of ``MultiHeadLayerNorm(residual=
False)``, the ViT baseline (``VisionTransformer`` and the loader's
``DenseGeneral`` rule), and the small modules of ``nn/vil.py`` (1-D and 3-D
patch and position embeds with the JAX resizes, ``SequenceConv3d``,
``FeedForward``) against the JAX package, on the helpers and sizes of
``test_torch_vil_extra.py`` (tolerance 1e-5 where no ViL layer runs, 1e-4
where one does). ViLLayer without its outnorm is held to the JAX layer's
native branch (the CPU one): the TPU branches of the reference hand their
kernels a unit affine and still normalize (``ROADMAP.md`` section 3).
"""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vil_extra import (CHUNK, DIM, GRID, S, TOL, VIL_TOL, _apply, _close, _init,
                                  _load, _rand)
from xlstm_yolo_tpu.nn import vil as JV
from xlstm_yolo_tpu.nn import vil_extra as JE
from xlstm_yolo_torch.nn import vil as TV
from xlstm_yolo_torch.nn import vil_extra as TE
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, port_named, torch_name


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work while it runs (the
    suite runs test files in parallel processes), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- VisionTransformer ----------------------------------------------------------

@pytest.mark.parametrize("mode,depth", [("classifier", 2), ("features", 1)])
def test_vision_transformer_matches_jax(mode, depth):
    """The ViT baseline: flax's attention kernels (D, NH, hd) / (NH, hd, D)
    through the loader's DenseGeneral rule."""
    kw = dict(dim=DIM, depth=depth, num_heads=2, patch_size=8, num_classes=10, mode=mode)
    x = _rand(12, 2, 32, 32, 3)
    jm = JE.VisionTransformer(**kw)
    v = _init(jm, x)
    assert v["params"]["attn_0"]["query"]["kernel"].shape == (DIM, 2, 16)
    tm = _load(TE.VisionTransformer(**kw, resolution=(32, 32), device="cpu"), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == ((2, 10) if mode == "classifier" else (2, 4, 4, DIM))
    _close(got, _apply(jm, v, x), TOL)


def test_attention_kernels_of_another_shape_raise():
    w = np.zeros((DIM, 2, 16), np.float32)
    name, arr = torch_name("params/attn_0/query/kernel", w)
    assert name == "attn_0.query.weight" and arr.shape == (32, DIM)
    assert torch_name("params/attn_0/out/kernel", w.reshape(2, 16, DIM))[1].shape == (DIM, 32)
    assert torch_name("params/attn_0/key/bias", np.zeros((2, 16)))[1].shape == (32,)
    assert torch_name("params/head/query/kernel", np.zeros((4, 3)))[1].shape == (3, 4)  # a Dense
    for leaf, shape in (("kernel", (2, 2, 2, 2)), ("bias", (2, 2, 2))):
        with pytest.raises(ValueError, match="attention"):
            torch_name(f"params/attn_0/value/{leaf}", np.zeros(shape))
    with pytest.raises(ValueError, match="attention"):
        torch_name("params/attn_0/out/bias", np.zeros((2, 16)))


# --- ViLLayer without outnorm, without biases ---------------------------------

LAYER = dict(qkv_block_size=16, seqlens=GRID, chunk_size=CHUNK)
OPTIONS = {"no_outnorm": dict(use_outnorm=False), "no_proj_bias": dict(proj_bias=False),
           "neither": dict(use_outnorm=False, proj_bias=False)}


def _port_masks(seed, batch, rate):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(batch, generator=g) < 1.0 - rate).numpy()


@pytest.mark.parametrize("branch", ["layer_fused", "stochastic_depth"])
@pytest.mark.parametrize("opts", list(OPTIONS))
def test_vil_layer_options_match_jax_native(opts, branch):
    """``use_outnorm=False`` and ``proj_bias=False`` against the JAX layer's
    native branch, through the layer function (eval) and through the
    stochastic-depth branch (train mode, the JAX masks replaced by the
    port's); the trees leave out the outnorm's and the biases' keys."""
    kw = {**LAYER, **OPTIONS[opts], "drop_path": 0.5 if branch == "stochastic_depth" else 0.0}
    x = _rand(13, 4, S, DIM)
    jm = JV.ViLLayer(DIM, **kw)
    v = _init(jm, x)
    tm = _load(TV.ViLLayer(DIM, **kw), v)
    keys = set(port_named(flatten_variables(v["params"])))
    if not kw.get("use_outnorm", True):
        assert not any("outnorm" in k for k in keys) and tm.mlstm_cell.outnorm is None
    if not kw.get("proj_bias", True):
        assert not any(k.endswith("bias") for k in keys if "proj" in k), sorted(keys)
        assert "zeros" not in tm.state_dict()  # a non-persistent buffer
    xt = torch.from_numpy(x)
    if branch == "layer_fused":
        want = _apply(jm, v, x)
        with torch.no_grad():
            got = tm(xt)
    else:
        mask = _port_masks(1, 4, 0.5)
        assert mask.any() and not mask.all()
        with mock.patch.object(jax.random, "bernoulli",
                               lambda key, p, shape: jnp.asarray(mask).reshape(shape)):
            want = jm.apply(v, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(1)})
        with torch.no_grad():
            got = tm.train()(xt, generator=torch.Generator().manual_seed(1))
    _close(got, want, VIL_TOL)


def test_vil_layer_without_outnorm_or_biases_gradients_match_jax():
    """The layer function's hand backward without the outnorm and with zero
    biases against ``jax.grad`` of the native branch (gate kernels at zero,
    where the frozen stabilizer agrees); the conv-fused entry and the block
    entry give the layer's output."""
    kw = {**LAYER, **OPTIONS["neither"]}
    x = _rand(14, 2, S, DIM)
    jm = JV.ViLLayer(DIM, **kw)
    v = _init(jm, x, gates=False)
    gout = _rand(15, 2, S, DIM)

    def loss(params, xj):
        return jnp.sum(jm.apply({"params": params}, xj) * gout)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], jnp.asarray(x))
    tm = _load(TV.ViLLayer(DIM, **kw), v).train()
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    (out * torch.from_numpy(gout)).sum().backward()
    want = port_named(flatten_variables(gp))
    gmax = max(np.abs(w).max() for w in want.values())
    got = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, rtol=1e-4, atol=1e-4 * gmax, err_msg=n)
    _close(xt.grad, gx, VIL_TOL)
    with torch.no_grad():
        tm.eval()
        ref = tm(xt)
        _close(tm.forward_conv_fused(xt), ref, TOL)
        a = tm.norm(xt)
        x_mlstm, z = torch.nn.functional.linear(a, tm.proj_up.weight).split(tm.inner, -1)
        conv_act = torch.nn.functional.silu(tm.conv(x_mlstm, GRID))
        by_block = tm.mlstm_cell.forward_block(conv_act, x_mlstm, z, xt, tm.q_proj, tm.k_proj,
                                               tm.v_proj, tm.learnable_skip, tm.proj_down,
                                               tm.zeros)
        _close(by_block, ref, TOL)


def test_vil_block_pair_without_outnorm_matches_jax():
    x = _rand(16, 2, S, DIM)
    jm = JV.ViLBlockPair(DIM, qkv_block_size=16, seqlens=GRID, chunk_size=CHUNK,
                         use_outnorm=False, bidirectional=True)
    v = _init(jm, x)
    tm = _load(TV.ViLBlockPair(DIM, qkv_block_size=16, seqlens=GRID, chunk_size=CHUNK,
                               use_outnorm=False, bidirectional=True), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, _apply(jm, v, x), VIL_TOL)


def test_multihead_layernorm_weight_stored_directly_matches_jax():
    x = _rand(17, 2, 4, 8, 6)
    for residual in (True, False):
        jm = JV.MultiHeadLayerNorm(num_heads=4, eps=1e-6, residual=residual)
        v = _init(jm, x)
        tm = _load(TV.MultiHeadLayerNorm(4, 24, eps=1e-6, residual=residual), v)
        with torch.no_grad():
            _close(tm(torch.from_numpy(x)), _apply(jm, v, x), TOL)


# --- the small modules: 1-D and 3-D embeds, SequenceConv3d, FeedForward -----

def test_patch_embeds_1d_3d_and_sequence_conv3d_match_jax():
    x1, x3 = _rand(18, 2, 16, 3), _rand(19, 2, 4, 8, 8, 3)
    for x, nd, patch, shape in ((x1, 1, 4, (2, 4, 8)), (x3, 3, 2, (2, 2, 4, 4, 8))):
        jm = JV.VitPatchEmbed(dim=8, patch_size=patch)
        v = _init(jm, x)
        with torch.no_grad():
            got = _load(TV.VitPatchEmbed(8, patch, ndim=nd), v)(torch.from_numpy(x))
        assert tuple(got.shape) == shape
        _close(got, _apply(jm, v, x), TOL)
    xs = _rand(20, 2, 32, 6)
    jm = JV.SequenceConv3d(out_channels=8, seqlens=(2, 4, 4))
    v = _init(jm, xs)
    with torch.no_grad():
        got = _load(TV.SequenceConv3d(6, 8, seqlens=(2, 4, 4)), v)(torch.from_numpy(xs))
    _close(got, _apply(jm, v, xs), TOL)
    with pytest.raises(ValueError, match="rank"):
        TV.VitPatchEmbed(8, 4, ndim=1)(torch.from_numpy(x3))


@pytest.mark.parametrize("length", [16, 10, 24], ids=["same", "shrink", "grow"])
def test_pos_embed_1d_resized_linearly_matches_jax(length):
    jm = JV.VitPosEmbed1d(dim=8, seqlens=(16,))
    v = _init(jm, np.zeros((1, 16, 8), np.float32))
    x = _rand(21, 2, length, 8)
    with torch.no_grad():
        got = _load(TV.VitPosEmbed1d(8, (16,)), v)(torch.from_numpy(x))
    _close(got, _apply(jm, v, x), TOL)


@pytest.mark.parametrize("grid", [(4, 4, 4), (2, 6, 6), (3, 2, 5)], ids=["same", "mixed", "shrink"])
def test_pos_embed_3d_resized_trilinearly_matches_jax(grid):
    jm = JV.VitPosEmbed3d(dim=8, seqlens=(4, 4, 4))
    v = _init(jm, np.zeros((1, 4, 4, 4, 8), np.float32))
    x = _rand(22, 1, *grid, 8)
    with torch.no_grad():
        got = _load(TV.VitPosEmbed3d(8, (4, 4, 4)), v)(torch.from_numpy(x))
    _close(got, _apply(jm, v, x), TOL)


@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "no_bias"])
def test_feed_forward_matches_jax(use_bias):
    x = _rand(23, 2, S, DIM)
    jm = JV.FeedForward(DIM, use_bias=use_bias, num_blocks=2)
    v = _init(jm, x)
    tm = _load(TV.FeedForward(DIM, use_bias=use_bias, num_blocks=2), v)
    assert tm.up == 128  # int(2.6667 * 32) = 85, rounded up to 128
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), _apply(jm, v, x), TOL)

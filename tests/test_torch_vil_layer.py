"""Port parity: the ViL layer function and modules against the JAX package.

``vil_layer_ref`` (the CUDA kernel's plain version) is held against the JAX
layer-fused Pallas kernel in interpret mode with fp32 operands, and against
the JAX composite, with S both a chunk multiple and not. The port's
ViLLayer / ViLBlockPair on the CPU are held against the JAX modules on the
CPU on the same weights. Tolerance 1e-4 (rtol and atol, outputs O(1)): fp32
throughout, differences come from summation order and chunking only.
``vil_layer_fwd`` on the card is checked in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xlstm_yolo_tpu.kernels.mlstm_pallas import (
    _vil_layer_composite, mlstm_vil_layer_fused_pallas)
from xlstm_yolo_tpu.nn import vil as JV
from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd, vil_layer_ref
from xlstm_yolo_torch.nn import vil as TV
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables

TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ["x", "conv", "nrm", "wu", "bu", "wq", "bq", "wk", "bk", "wv", "bv",
         "wgi", "bgi", "wgf", "bgf", "nsc", "nbi", "skip", "wd", "bd"]


def layer_args(B=2, NH=2, S=256, DH=16, DIM=16, seed=3):
    """Seeded fp32 numpy arguments of the layer function, JAX layouts."""
    rng = np.random.default_rng(seed)
    INNER = NH * DH
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(
        x=mk(B, S, DIM), conv=mk(B, S, INNER), nrm=1.0 + mk(DIM) * 0.2,
        wu=mk(DIM, 2 * INNER) * 0.3, bu=mk(2 * INNER) * 0.1,
        wq=mk(NH, DH, DH) * 0.3, bq=mk(INNER) * 0.1,
        wk=mk(NH, DH, DH) * 0.3, bk=mk(INNER) * 0.1,
        wv=mk(NH, DH, DH) * 0.3, bv=mk(INNER) * 0.1,
        wgi=mk(3 * INNER, NH) * 0.05, bgi=np.full((NH,), -8.0, np.float32),
        wgf=mk(3 * INNER, NH) * 0.05, bgf=np.full((NH,), 4.0, np.float32),
        nsc=1.0 + mk(INNER) * 0.2, nbi=mk(INNER) * 0.1, skip=1.0 + mk(INNER) * 0.1,
        wd=mk(INNER, DIM) * 0.2, bd=mk(DIM) * 0.1)


def _ref(a, nh, **kw):
    return vil_layer_ref(*(torch.from_numpy(a[n]) for n in NAMES), nh, **kw).numpy()


@pytest.mark.parametrize("S", [256, 200])
def test_vil_layer_ref_matches_jax_kernel_interpret(S):
    a = layer_args(S=S)
    j = [jnp.asarray(a[n]) for n in NAMES]
    want = mlstm_vil_layer_fused_pallas(*j, 2, chunk_size=128, interpret=True,
                                        mxu_dtype="float32")
    np.testing.assert_allclose(_ref(a, 2, chunk_size=128), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,igate_act", [(256, "exp"), (200, "exp"), (200, "sigmoid")])
def test_vil_layer_ref_matches_jax_composite(S, igate_act):
    a = layer_args(S=S, seed=4)
    j = {n: jnp.asarray(a[n]) for n in NAMES}
    want = _vil_layer_composite(
        j["x"], j["conv"], j["nrm"], j["wu"], j["bu"], j["wq"], j["wk"], j["wv"],
        j["bq"], j["bk"], j["bv"], j["wgi"], j["bgi"], j["wgf"], j["bgf"], j["nsc"],
        j["nbi"], j["skip"], j["wd"], j["bd"], 2, 128, igate_act, 1e-6, 1e-3, 1e-6)
    got = _ref(a, 2, chunk_size=128, igate_act=igate_act)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_vil_layer_fwd_on_cpu_is_the_plain_version():
    a = layer_args(S=64)
    before = vil_layer_fwd.launches
    got = vil_layer_fwd(*(torch.from_numpy(a[n]) for n in NAMES), 2, chunk_size=32)
    assert vil_layer_fwd.launches == before  # no kernel launched for CPU tensors
    np.testing.assert_array_equal(got.numpy(), _ref(a, 2, chunk_size=32))


def test_vil_layer_fwd_rejects_other_devices():
    a = layer_args(S=8)
    with pytest.raises(ValueError):
        vil_layer_fwd(*(torch.from_numpy(a[n]).to("meta") for n in NAMES), 2)


def test_vil_layer_fwd_off_cpu_refuses_grad():
    """Off the CPU and CUDA, a call refuses whether or not it needs
    gradients: there is no plain fallback for another device, and the
    autograd Function (the hand-written backward) is not entered."""
    a = layer_args(S=8)
    args = [torch.from_numpy(a[n]).to("meta") for n in NAMES]
    args[3].requires_grad_()  # proj_up kernel, as a module parameter would be
    with pytest.raises(ValueError):
        vil_layer_fwd(*args, 2)
    with torch.no_grad(), pytest.raises(ValueError):
        vil_layer_fwd(*args, 2)


def _port(module, jax_vars):
    return load_jax_variables(module, flatten_variables(jax_vars)).eval()


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_vil_layer_module_matches_jax(direction):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 48, 32)).astype(np.float32)  # 6 x 8 token grid
    kw = dict(dim=32, direction=direction, qkv_block_size=16, seqlens=(6, 8), chunk_size=16)
    jm = JV.ViLLayer(**kw)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # random gate kernels and norm affines, so every parameter matters
    v = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(rng.normal(size=p.shape), p.dtype), v)
    want = jm.apply(v, jnp.asarray(x))
    tm = _port(TV.ViLLayer(**kw), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_vil_block_pair_matches_jax(bidirectional):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 8, 8, 32)).astype(np.float32)  # (B, H, W, D) image tokens
    kw = dict(dim=32, qkv_block_size=16, seqlens=(8, 8), chunk_size=16,
              bidirectional=bidirectional)
    jm = JV.ViLBlockPair(**kw)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    v = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(rng.normal(size=p.shape), p.dtype), v)
    want = jm.apply(v, jnp.asarray(x))
    tm = _port(TV.ViLBlockPair(**kw), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_multihead_layernorm_matches_jax():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 3, 5, 8)) * 3 + 1).astype(np.float32)
    jm = JV.MultiHeadLayerNorm(num_heads=3)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(lambda p: p + jnp.asarray(rng.normal(size=p.shape), p.dtype), v)
    tm = _port(TV.MultiHeadLayerNorm(3, 24), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(v, jnp.asarray(x))), **TOL)

"""Port parity at the ViL head dims below 64 that the JAX package's blocks
default to (16 in the YAML blocks, 4 in ``VisionLSTM2``) and the others the
CUDA kernels are instantiated for (4, 8, 16, 32). Head dim 16 is also held
by ``test_torch_vil_layer.py`` and ``test_torch_vil_cls.py``; here DH 4, 8
and 32, with S 64 to 128, B 1 or 2 and 2 to 4 heads:

* the layer's plain version (the CUDA K3's oracle, ``vil_layer_ref``)
  against the layer-fused Pallas kernel in interpret mode at fp32
  operands, and the cell's (K4's, ``vil_cell_plain``) against the
  cell-fused one;
* the plain chunkwise backward (K2's oracle) against the JAX reference,
  and the layer's hand backward against ``jax.grad`` through the fused
  entry's custom VJP in interpret mode;
* the ``ViLLayer`` module against the JAX module on weights loaded with
  ``load_jax_variables``.

Tolerance 1e-4 (rtol and atol, outputs O(1)): fp32 throughout, differences
from summation order and chunk length only. The bf16 plain versions are
held at DH 16 and 32 against the interpret-mode kernels at
``mxu_dtype="bfloat16"`` by the rules of ``test_torch_amp.py`` (the layer
within 1e-3 of its max; each gradient of the backward within a quarter of
the gap between that kernel at fp32 and at bf16). The kernels themselves
run on the card only (``test_torch_cuda.py``).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_amp import BF, _b16
from test_torch_vil_cell import CELL, _j, _natural, _t, block_args
from test_torch_vil_layer import NAMES, layer_args
from xlstm_yolo_tpu.kernels.mlstm_bwd import mlstm_chunkwise_bwd_ref as jax_bwd_ref
from xlstm_yolo_tpu.kernels.mlstm_pallas import (mlstm_vil_fused_pallas,
                                                 mlstm_vil_layer_fused_pallas)
from xlstm_yolo_tpu.kernels.mlstm_pallas_bwd import mlstm_chunkwise_pallas_bwd
from xlstm_yolo_tpu.nn import vil as JV
from xlstm_yolo_torch.kernels import mlstm_bwd as T
from xlstm_yolo_torch.kernels.vil_cell import Cfg, vil_cell_plain
from xlstm_yolo_torch.kernels.vil_layer import _layer_plain, vil_layer_bwd_ref, vil_layer_ref
from xlstm_yolo_torch.nn import vil as TV
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work while it runs (the
    suite runs test files in parallel processes; as in
    ``test_torch_device_augment.py``), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)
DHS = [4, 8, 32]
HEADS = {4: 4, 8: 4, 16: 2, 32: 2}  # heads at each head dim: INNER 16, 32, 32, 64


def _layer(DH, S, B=1, seed=0):
    nh = HEADS[DH]
    return layer_args(B=B, NH=nh, S=S, DH=DH, DIM=nh * DH // 2, seed=seed), nh


@pytest.mark.parametrize("DH", DHS)
def test_plain_layer_matches_jax_kernel_interpret(DH):
    """K3's plain version at S 96 (ragged at its chunk 64) against the
    interpret-mode layer kernel (chunk 128)."""
    a, nh = _layer(DH, 96, seed=DH)
    want = mlstm_vil_layer_fused_pallas(*(jnp.asarray(a[n]) for n in NAMES), nh,
                                        chunk_size=128, interpret=True, mxu_dtype="float32")
    got = vil_layer_ref(*(torch.from_numpy(a[n]) for n in NAMES), nh, chunk_size=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("DH", DHS)
def test_plain_cell_matches_jax_kernel_interpret(DH):
    """K4's plain version at S 64 against the interpret-mode cell kernel."""
    nh = HEADS[DH]
    a = block_args(B=1, NH=nh, S=64, DH=DH, DIM=8, seed=DH + 1, gate_scale=0.1,
                   unit_gates=True)
    want = mlstm_vil_fused_pallas(*_j(a, CELL), nh, chunk_size=128, interpret=True,
                                  mxu_dtype="float32")
    got = vil_cell_plain(*_t(a, CELL), nh, chunk_size=64)
    np.testing.assert_allclose(got.numpy(), _natural(want, 1, nh), **TOL)


def _cell_inputs(seed, B, NH, S, DH):
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, NH, S, DH)).astype(np.float32)
    k = (q + 0.1 * r.normal(size=q.shape)).astype(np.float32)
    v, dh = (r.normal(size=(B, NH, S, DH)).astype(np.float32) for _ in range(2))
    i = r.normal(size=(B, NH, S)).astype(np.float32)
    f = (r.normal(size=(B, NH, S)) + 2).astype(np.float32)
    return q, k, v, i, f, dh


@pytest.mark.parametrize("DH", DHS)
def test_plain_chunkwise_bwd_matches_jax(DH):
    """K2's oracle, and its plain version on the natural (B, S, NH*DH)
    layout at a ragged S, against the JAX frozen-stabilizer reference."""
    B, NH, S = 1, HEADS[DH], 128
    a = _cell_inputs(DH, B, NH, S, DH)
    ref = jax.jit(jax_bwd_ref, static_argnames="chunk_size")
    want = ref(*map(jnp.asarray, a), chunk_size=64)
    got = T.mlstm_chunkwise_bwd_ref(*map(torch.from_numpy, a), chunk_size=64)
    for name, g, w in zip("qkvif", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"d{name}", **TOL)
    S2 = 100  # ragged: the plain version pads to a chunk multiple, as the kernel masks
    nat = lambda t: torch.from_numpy(t[:, :, :S2]).transpose(1, 2).reshape(B, S2, NH * DH)
    q, k, v, i, f, dh = a
    got = T.mlstm_chunkwise_bwd_plain(nat(q), nat(k), nat(v), torch.from_numpy(i[..., :S2]),
                                      torch.from_numpy(f[..., :S2]), nat(dh), NH)
    pad = lambda t: jnp.pad(jnp.asarray(t[:, :, :S2]),
                            [(0, 0), (0, 0), (0, S - S2)] + [(0, 0)] * (t.ndim - 3))
    want = ref(*(pad(t) for t in a), chunk_size=64)
    for name, g, w in zip("qkv", got[:3], want[:3]):
        w = np.asarray(w)[:, :, :S2].transpose(0, 2, 1, 3).reshape(B, S2, NH * DH)
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **TOL)
    for name, g, w in zip("if", got[3:], want[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[..., :S2], err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("DH", DHS)
def test_layer_hand_backward_matches_jax_custom_vjp(DH):
    """Loss sum(out * g) at S 77, g seeded with std 0.1 (the gradients
    O(1)): ``jax.grad`` through the interpret-mode layer kernel's custom VJP
    against the port's hand backward on the plain forward's activations
    (K2's plain version inside), and autograd through ``vil_layer_fwd`` on
    the CPU against that."""
    from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd

    a, nh = _layer(DH, 77, seed=DH + 2)
    g = (0.1 * np.random.default_rng(DH).normal(size=a["x"].shape)).astype(np.float32)

    def loss(*t):
        out = mlstm_vil_layer_fused_pallas(*t, nh, chunk_size=64, interpret=True,
                                           mxu_dtype="float32")
        return jnp.sum(out * g)

    want = jax.jit(jax.grad(loss, argnums=tuple(range(20))))(*(jnp.asarray(a[n]) for n in NAMES))
    args = [torch.from_numpy(a[n]) for n in NAMES]
    _, acts = _layer_plain(args, Cfg(nh, 64))
    got = vil_layer_bwd_ref(args, acts, torch.from_numpy(g), nh, chunk_size=64)
    for n, mine, w in zip(NAMES, got, want):
        np.testing.assert_allclose(mine.numpy(), np.asarray(w), err_msg=n, **TOL)
    leaves = [t.clone().requires_grad_() for t in args]
    (vil_layer_fwd(*leaves, nh, chunk_size=64) * torch.from_numpy(g)).sum().backward()
    for n, leaf, mine in zip(NAMES, leaves, got):
        np.testing.assert_allclose(leaf.grad.numpy(), mine.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("DH", DHS)
def test_vil_layer_module_matches_jax(DH):
    """``ViLLayer(qkv_block_size=DH)`` on a 6 x 8 token grid against the JAX
    module on the same (perturbed) weights; the JAX module built and
    initialized once per head dim."""
    nh = HEADS[DH]
    dim = nh * DH // 2
    rng = np.random.default_rng(DH + 3)
    x = rng.normal(size=(2, 48, dim)).astype(np.float32)
    kw = dict(dim=dim, qkv_block_size=DH, seqlens=(6, 8), chunk_size=16)
    jm = JV.ViLLayer(**kw)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(rng.normal(size=p.shape), p.dtype), v)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    tm = load_jax_variables(TV.ViLLayer(**kw), flatten_variables(v)).eval()
    assert tm.num_heads == nh
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("DH", [16, 32])
def test_plain_bf16_layer_matches_jax_bf16_kernel(DH):
    """The plain bf16 layer (K3 bf16's oracle) within 1e-3 of the output's
    max of the interpret-mode kernel at mxu bf16, and the fp32 plain layer
    at least 2e-3 from it (the test tells the two arithmetics apart)."""
    a, nh = _layer(DH, 128, B=2, seed=DH + 4)
    x16, c16 = _b16(a["x"]), _b16(a["conv"])
    j = [jnp.asarray(a[n]) for n in NAMES]
    j[0], j[1] = jnp.asarray(x16).astype(BF), jnp.asarray(c16).astype(BF)
    want = np.asarray(mlstm_vil_layer_fused_pallas(*j, nh, chunk_size=128, interpret=True,
                                                   mxu_dtype="bfloat16").astype(jnp.float32))
    t = [torch.from_numpy(a[n]) for n in NAMES]
    t32 = [torch.from_numpy(x16), torch.from_numpy(c16), *t[2:]]
    t16 = [t32[0].bfloat16(), t32[1].bfloat16(), *t[2:]]
    got = vil_layer_ref(*t16, nh, chunk_size=128)
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= 1e-3 * scale
    fp32 = vil_layer_ref(*t32, nh, chunk_size=128).numpy()
    assert np.abs(fp32 - want).max() >= 2e-3 * scale


@pytest.mark.parametrize("DH", [16, 32])
def test_plain_bf16_chunkwise_bwd_matches_jax_bf16_kernel(DH):
    """The plain bf16 backward (K2 bf16's oracle) against the interpret-mode
    Pallas backward at mxu bf16: each gradient within a quarter of the gap
    between that kernel at fp32 and at bf16 (dq/dk/dv beyond half a bf16
    ulp, as ``test_torch_amp.py`` holds them at 64)."""
    rng = np.random.default_rng(DH)
    B, NH, S = 1, HEADS[DH], 128
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v = (_b16(mk(B, NH, S, DH)) for _ in range(3))
    dh = mk(B, NH, S, DH)
    i, f = mk(B, NH, S), mk(B, NH, S) + 3.0

    def jax_grads(mxu, dt):
        c = lambda x: jnp.asarray(x).astype(dt)
        bwd = jax.jit(functools.partial(mlstm_chunkwise_pallas_bwd, chunk_size=128,
                                        interpret=True, mxu_dtype=mxu))
        out = bwd(c(q), c(k), c(v), jnp.asarray(i), jnp.asarray(f), jnp.asarray(dh))
        return [np.asarray(o.astype(jnp.float32)) for o in out]

    want16, want32 = jax_grads("bfloat16", BF), jax_grads("float32", jnp.float32)
    nat = lambda x: T._natural(torch.from_numpy(x)).bfloat16()
    args = (nat(q), nat(k), nat(v), torch.from_numpy(i), torch.from_numpy(f),
            T._natural(torch.from_numpy(dh)), NH)
    got = T.mlstm_chunkwise_bwd_plain(*args, chunk_size=128, keep_fp32=True)
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

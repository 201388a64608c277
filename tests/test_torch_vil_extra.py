"""Port parity: the rest of the ViL family (``xlstm_yolo_torch/nn/vil_extra.py``:
``mlstm_chunkwise`` from a carried state, ViLLayerLarge, mLSTMVisionBlock,
the nine fusion MLPs in FusionViLLayer, HierarchicalVisionLSTM; the two ViL
YAML adapters of ``nn/vil_blocks.py``) against the JAX package. The
ViLLayer options, the ViT baseline and the small modules of ``nn/vil.py``
are in ``test_torch_vil_options.py``, on this file's helpers.

Each module is initialized in JAX, every variable moved off its init with
seeded noise (so that every parameter matters), loaded into the port with
``load_jax_variables`` (which raises on any missing or extra key) and run on
the same seeded numpy input at a small size: dim 32, a 4 x 4 grid, chunk 8.
The JAX sides are jitted; torch runs on one thread. Tolerance (rtol and
atol): 1e-5 where no ViL layer runs, 1e-4 where one does (a ViLBlockPair,
``ViLLayerLarge``), as ``test_torch_vil_yaml.py`` holds them: fp32, summation
order and chunking only. The ViL layers run their
plain versions here; on the card ``chip_smoke.py`` (``vil_family_path``)
and ``test_torch_cuda.py`` run the kernels.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xlstm_yolo_tpu.kernels import mlstm_native as JN
from xlstm_yolo_tpu.nn import vil_extra as JE
from xlstm_yolo_tpu.nn.graph import GraphModel as JaxGraphModel
from xlstm_yolo_tpu.nn.graph import parse_model as jax_parse_model
from xlstm_yolo_torch.kernels import mlstm_native as TN
from xlstm_yolo_torch.nn import vil_extra as TE
from xlstm_yolo_torch.nn.graph import GraphModel, parse_model
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work while it runs (the
    suite runs test files in parallel processes), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)
VIL_TOL = dict(rtol=1e-4, atol=1e-4)
DIM, GRID, CHUNK = 32, (4, 4), 8
S = GRID[0] * GRID[1]


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _perturbed(variables, seed, gates=True):
    """Every leaf moved off its init (variances kept positive); ``gates=
    False`` leaves the ViL gate kernels at zero (where the hand backward's
    frozen stabilizer and jax.grad agree)."""
    rng = np.random.default_rng(seed)

    def move(path, p):
        names = [getattr(k, "key", "") for k in path]
        if not gates and names[-1] == "kernel" and names[-2] in ("igate", "fgate"):
            return p
        noise = jnp.asarray(0.1 * rng.normal(size=p.shape), p.dtype)
        return jnp.abs(p + noise) + 0.5 if names[-1] == "var" else p + noise

    return jax.tree_util.tree_map_with_path(move, variables)


def _init(jmod, *xs, seed=0, gates=True, **kw):
    """Jitted init of ``jmod`` on ``xs``, perturbed."""
    jx = [jnp.asarray(x) for x in xs]
    v = jax.jit(lambda *a: jmod.init(jax.random.PRNGKey(seed), *a, **kw))(*jx)
    return _perturbed(v, seed + 100, gates)


def _apply(jmod, v, *xs, **kw):
    return jax.jit(lambda v_, *a: jmod.apply(v_, *a, **kw))(v, *(jnp.asarray(x) for x in xs))


def _load(tmod, v):
    return load_jax_variables(tmod, flatten_variables(v)).eval()


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# --- mlstm_chunkwise with a carried state -----------------------------------

def _mlstm_args(seed, B=2, NH=2, S_=16, DQK=4, DV=8):
    q, k = _rand(seed, B, NH, S_, DQK), _rand(seed + 1, B, NH, S_, DQK)
    v = _rand(seed + 2, B, NH, S_, DV)
    i, f = _rand(seed + 3, B, NH, S_) - 1.0, _rand(seed + 4, B, NH, S_) + 2.0
    state = (_rand(seed + 5, B, NH, DQK, DV, scale=0.3), _rand(seed + 6, B, NH, DQK, scale=0.3),
             _rand(seed + 7, B, NH, scale=0.5))
    return (q, k, v, i, f), state


def test_mlstm_chunkwise_initial_state_dqk_ne_dv_matches_jax():
    """h and the last (C, n, m) from a given state, C (DQK, DV) = (4, 8);
    two carried halves are the whole sequence; a length no chunk multiple
    raises (nothing is padded)."""
    args, state = _mlstm_args(0)
    want_h, want_last = JN.mlstm_chunkwise(*map(jnp.asarray, args), chunk_size=CHUNK,
                                           initial_state=tuple(map(jnp.asarray, state)),
                                           return_last_state=True)
    targs = [torch.from_numpy(a) for a in args]
    got_h, got_last = TN.mlstm_chunkwise(*targs, chunk_size=CHUNK,
                                         initial_state=tuple(map(torch.from_numpy, state)),
                                         return_last_state=True)
    assert tuple(got_last[0].shape) == (2, 2, 4, 8)
    _close(got_h, want_h, TOL)
    for g, w in zip(got_last, want_last):
        _close(g, w, TOL)
    half = lambda lo, hi: [t[:, :, lo:hi] for t in targs]
    h1, mid = TN.mlstm_chunkwise(*half(0, 8), chunk_size=CHUNK, return_last_state=True)
    h2 = TN.mlstm_chunkwise(*half(8, 16), chunk_size=CHUNK, initial_state=mid)
    _close(torch.cat([h1, h2], 2), TN.mlstm_chunkwise(*targs, chunk_size=CHUNK), TOL)
    with pytest.raises(ValueError, match="divisible"):
        TN.mlstm_chunkwise(*half(0, 12), chunk_size=CHUNK)


def test_soft_cap_matches_jax():
    x = _rand(1, 64, scale=30.0)
    _close(TN.soft_cap(torch.from_numpy(x), 15.0), JN.soft_cap(jnp.asarray(x), 15.0), TOL)
    t = torch.from_numpy(x)
    assert TN.soft_cap(t, None) is t  # no cap: the identity


# --- ViLLayerLarge, mLSTMVisionBlock ----------------------------------------

@pytest.mark.parametrize("use_bias", [False, True], ids=["no_bias", "bias"])
def test_vil_layer_large_with_carried_state_matches_jax(use_bias):
    """The layer from a seeded (C, n, m) state, its output and its last
    state, whose C is (B, NH, DQK, DV) = (2, 4, 4, 8) at qk_dim_factor 0.5;
    the per-head norm stores its weight directly (init ones)."""
    x = _rand(2, 2, S, DIM)
    state = (_rand(3, 2, 4, 4, 8, scale=0.3), _rand(4, 2, 4, 4, scale=0.3),
             _rand(5, 2, 4, scale=0.5))
    jm = JE.ViLLayerLarge(DIM, num_heads=4, chunk_size=CHUNK, seqlens=GRID, use_bias=use_bias)
    v = _init(jm, x)
    assert "multihead_norm" in v["params"]
    want, want_last = _apply(jm, v, x, initial_state=tuple(map(jnp.asarray, state)),
                             return_last_state=True)
    tm = _load(TE.ViLLayerLarge(DIM, 4, chunk_size=CHUNK, seqlens=GRID, use_bias=use_bias), v)
    assert float(TE.ViLLayerLarge(DIM).multihead_norm.scale.detach().min()) == 1.0  # direct
    with torch.no_grad():
        got, last = tm(torch.from_numpy(x), initial_state=tuple(map(torch.from_numpy, state)),
                       return_last_state=True)
    assert tuple(last[0].shape) == (2, 4, 4, 8)
    _close(got, want, VIL_TOL)
    for g, w in zip(last, want_last):
        _close(g, w, VIL_TOL)


@pytest.mark.parametrize("dim", [32, 16], ids=["ffn64", "ffn_dim"])
def test_mlstm_vision_block_matches_jax(dim):
    """At dim 32 the FFN is int(2.6667 * 32 // 64 * 64) = 64 wide; at 16
    the floor is 0 and the width falls back to dim."""
    x = _rand(6, 2, S, dim)
    jm = JE.mLSTMVisionBlock(dim, num_heads=4, chunk_size=CHUNK, seqlens=GRID)
    v = _init(jm, x)
    tm = _load(TE.mLSTMVisionBlock(dim, 4, chunk_size=CHUNK, seqlens=GRID), v)
    assert tm.up == (64 if dim == 32 else dim)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, _apply(jm, v, x), VIL_TOL)


def test_mlstm_vision_block_refuses_a_grid_its_chunk_does_not_divide():
    """At the default chunk 64 a 20 x 20 grid (S 400) runs in neither
    package: JAX asserts, the port raises."""
    x = np.zeros((1, 400, 16), np.float32)
    with pytest.raises(AssertionError, match="divisible"):
        JE.mLSTMVisionBlock(16, seqlens=(20, 20)).init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = TE.mLSTMVisionBlock(16, seqlens=(20, 20))
    with pytest.raises(ValueError, match="divisible"), torch.no_grad():
        tm(torch.from_numpy(x))


# --- the fusion MLPs and FusionViLLayer -------------------------------------

@pytest.mark.parametrize("mlp_type", list(JE.MLP_REGISTRY))
def test_fusion_vil_layer_matches_jax(mlp_type):
    """Each of the nine MLPs behind the ViLBlockPair, with a second stream
    ``ctx`` (read by crossattn and film)."""
    assert list(TE.MLP_REGISTRY) == list(JE.MLP_REGISTRY)
    x, ctx = _rand(7, 2, S, DIM), _rand(8, 2, S, DIM)
    jm = JE.FusionViLLayer(DIM, mlp_type=mlp_type, seqlens=GRID, chunk_size=CHUNK, seq_len=S)
    v = _init(jm, x, ctx)
    tm = _load(TE.FusionViLLayer(DIM, mlp_type=mlp_type, seqlens=GRID, chunk_size=CHUNK,
                                 seq_len=S), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(ctx))
    _close(got, _apply(jm, v, x, ctx), VIL_TOL)


def test_fusion_vil_layer_without_mlp_or_skip_matches_jax():
    x = _rand(9, 2, S, DIM)
    for kw in (dict(use_mlp=False), dict(use_skip=False, mlp_type="geglu")):
        jm = JE.FusionViLLayer(DIM, seqlens=GRID, chunk_size=CHUNK, **kw)
        v = _init(jm, x)
        with torch.no_grad():
            got = _load(TE.FusionViLLayer(DIM, seqlens=GRID, chunk_size=CHUNK, **kw), v)(
                torch.from_numpy(x))
        _close(got, _apply(jm, v, x), VIL_TOL)


# --- the two YAML adapters in one graph -------------------------------------

GRAPH = {"nc": 2, "backbone": [
    [-1, 1, "Conv", [32, 3, 2]],
    [-1, 2, "FusionViLLayerBlock", [32, 32, {"mlp_type": "swiglu", "chunk_size": 8}]],
    [-1, 1, "VilLayerUpdated", [32, 32, {"num_heads": 4, "chunk_size": 8}]],
    [-1, 1, "mLSTMVisionBlock", [32, {"num_heads": 2, "chunk_size": 16}]],
]}


def test_fusion_and_mlstm_vision_blocks_in_one_graph_match_jax():
    """``tests/test_vil_extra.py``'s graph (plus the ``mLSTMVisionBlock``
    name) through both graph compilers: the maps come back NCHW here, and
    the row's repeats are dropped in both (the loader finds one block)."""
    x = _rand(10, 2, 16, 16, 3)
    gm = JaxGraphModel(jax_parse_model(GRAPH, ch=3))
    v = _init(gm, x, train=False)
    want = _apply(gm, v, x, train=False)
    tm = _load(GraphModel(parse_model(GRAPH, ch=3)), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert tuple(got.shape) == (2, 32, 8, 8)
    _close(got.numpy().transpose(0, 2, 3, 1), want, VIL_TOL)


def test_moeffn_is_refused_with_what_it_waits_on():
    """Named when the port refused MoEFFN: the graph builds it now
    (``parallel/moe.py``), channel-preserving over an NCHW map, and refuses
    a top k above its expert count."""
    cfg = {"nc": 2, "backbone": [[-1, 1, "MoEFFN", [4, 1]]]}
    g = GraphModel(parse_model(cfg, ch=8))
    assert tuple(g.l0.moe.w_gate.shape) == (4, 8, 64)
    with torch.no_grad():
        assert tuple(g(torch.zeros(2, 8, 4, 4)).shape) == (2, 8, 4, 4)
    cfg["backbone"][0][3] = [4, 5]
    with pytest.raises(ValueError, match="top_k=5"):
        GraphModel(parse_model(cfg, ch=8))


def test_fusion_block_mixer_needs_its_token_count():
    from xlstm_yolo_torch.nn.vil_blocks import FusionViLLayerBlock

    with pytest.raises(ValueError, match="seq_len"):
        FusionViLLayerBlock(16, {"mlp_type": "mixer"})
    assert FusionViLLayerBlock(16, {"mlp_type": "mixer", "seqlens": [4, 4]}).fusion \
        .mlp_mixer.Dense_0.weight.shape == (16, 16)


# --- HierarchicalVisionLSTM -------------------------------

def test_hierarchical_vision_lstm_matches_jax():
    """Three stages (8 x 8, 4 x 4, 2 x 2 grids), two token merges."""
    kw = dict(dims=(16, 32, 32), depths=(1, 1, 2), patch_size=4, qkv_block_size=16,
              chunk_size=CHUNK)
    x = _rand(11, 2, 32, 32, 3)
    jm = JE.HierarchicalVisionLSTM(**kw)
    v = _init(jm, x)
    want = _apply(jm, v, x)
    tm = _load(TE.HierarchicalVisionLSTM(**kw, resolution=(32, 32), device="cpu"), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert [tuple(o.shape) for o in got] == [(2, 8, 8, 16), (2, 4, 4, 32), (2, 2, 2, 32)]
    for g, w in zip(got, want):
        _close(g, w, VIL_TOL)

"""Port parity: the ViL YAML blocks (``xlstm_yolo_torch/nn/vil_blocks.py``)
against the JAX blocks of ``xlstm_yolo_tpu/nn/vil_blocks.py``.

Each block runs on the same seeded numpy input on both sides, the port's
weights loaded from the JAX variables (perturbed from their init, batch
statistics included, so that every parameter matters) with
``load_jax_variables``; image tensors are NHWC in the JAX package and NCHW
in the port, so the test transposes. Also: the two wrapper-block graphs of
``tests/test_vil.py`` compiled by both graph compilers, their outputs
compared; ``VitPosEmbed2d`` resized to a larger and to a smaller grid
against ``jax.image.resize``; and the ``seqlens`` and ``backend`` keys of
``ViLBlockPairBlock``. Tolerance 1e-5 (rtol and atol) for the blocks
without a ViL layer, 1e-4 for those with one (as ``test_torch_vil_layer.py``
holds the layer): fp32, summation order only. The ViL layers run their
plain versions here; on the card the graph of the ``VisionLSTM`` row runs
in ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xlstm_yolo_tpu.nn import vil as JV
from xlstm_yolo_tpu.nn import vil_blocks as JB
from xlstm_yolo_tpu.nn.graph import GraphModel as JaxGraphModel
from xlstm_yolo_tpu.nn.graph import parse_model as jax_parse_model
from xlstm_yolo_torch.nn import vil as TV
from xlstm_yolo_torch.nn import vil_blocks as TB
from xlstm_yolo_torch.nn.graph import REGISTRY, GraphModel, parse_model
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


TOL = dict(rtol=1e-5, atol=1e-5)
VIL_TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _perturbed(variables, seed):
    """Every leaf moved off its init (variances kept positive)."""
    rng = np.random.default_rng(seed)

    def move(path, p):
        noise = jnp.asarray(0.1 * rng.normal(size=p.shape), p.dtype)
        name = jax.tree_util.keystr(path)
        return jnp.abs(p + noise) + 0.5 if "var" in name else p + noise

    return jax.tree_util.tree_map_with_path(move, variables)


def _nhwc(x):  # port NCHW -> JAX NHWC (numpy)
    return np.asarray(x.detach()).transpose(0, 2, 3, 1)


def _pair(jmod, tmod, *xs, seed=0, nchw_in=(), nchw_out=False, tol=TOL, jit=False):
    """Init ``jmod`` on the JAX inputs, perturb, load into ``tmod``, run both
    in eval mode and compare; inputs in ``nchw_in`` (positions) are images,
    given NHWC and fed NCHW to the port. ``jit``: trace the JAX side (the
    blocks with ViL layers, which run slowly op by op)."""
    jx = [jnp.asarray(x) for x in xs]
    wrap = jax.jit if jit else (lambda f: f)
    v = _perturbed(wrap(lambda *a: jmod.init(jax.random.PRNGKey(seed), *a))(*jx), seed)
    want = wrap(lambda v_, *a: jmod.apply(v_, *a))(v, *jx)
    if flatten_variables(v):
        load_jax_variables(tmod, flatten_variables(v))
    tmod.eval()
    tx = [torch.from_numpy(x.transpose(0, 3, 1, 2).copy() if i in nchw_in else x)
          for i, x in enumerate(xs)]
    with torch.no_grad():
        got = tmod(*tx)
    got = _nhwc(got) if nchw_out else got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), **tol)
    return got, v


def test_registry_has_the_jax_names():
    """The port's graph compiler takes the ViL block names the JAX package
    registers, ``VisionLSTM``, ``FusionViLLayerBlock``, ``VilLayerUpdated``
    and ``mLSTMVisionBlock`` included, and ``MoEFFN`` (the last of them,
    refused until ``parallel/moe.py`` was ported)."""
    for name in ("ViLBlockPairBlock", "SequenceToImage", "ImageToSequence", "PermuteBlock",
                 "FeatureSplitIndex", "VitPatchEmbedBlock", "VitPosEmbedBlock",
                 "FlattenPosEmbedBlock", "SequenceConv2dBlock", "PatchMergeBlock", "PatchMerging",
                 "VisionClueMerge", "PatchMerger", "ViLLayerNormBlock", "MultiScaleFusionBlock",
                 "ViLFusionBlock", "VisionLSTM", "FusionViLLayerBlock", "VilLayerUpdated",
                 "mLSTMVisionBlock", "MoEFFN"):
        assert REGISTRY[name][1] == "custom", name
    from xlstm_yolo_tpu.nn.graph import REGISTRY as JAX_REGISTRY

    jax_vil = {n for n, (cls, _) in JAX_REGISTRY.items() if cls.__module__ == JB.__name__}
    assert len(jax_vil) == 21 and not jax_vil - set(REGISTRY)
    cfg = {"nc": 2, "backbone": [[-1, 1, "MoEFFN", [4, 1]]]}
    assert parse_model(cfg, ch=8).specs[0].name == "MoEFFN"


def test_sequence_image_views():
    x = _rand(0, 2, 12, 8)
    want = np.asarray(JB.SequenceToImage(seqlens=(3, 4)).apply({}, jnp.asarray(x)))
    for cls in (TB.SequenceToImage, TB.PermuteBlock):
        got = cls((3, 4))(torch.from_numpy(x))
        np.testing.assert_array_equal(_nhwc(got), want)
    img = _rand(1, 2, 3, 4, 8)
    want = np.asarray(JB.ImageToSequence().apply({}, jnp.asarray(img)))
    got = TB.ImageToSequence()(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="sequence length"):
        TB.SequenceToImage((3, 5))(torch.from_numpy(x))
    parts = [torch.zeros(1), torch.ones(1)]
    assert TB.FeatureSplitIndex(1)(parts) is parts[1]


def test_vit_patch_embed_block():
    _pair(JB.VitPatchEmbedBlock(dim=16, patch_size=4), TB.VitPatchEmbedBlock(3, 16, 4),
          _rand(2, 2, 16, 16, 3), nchw_in=(0,), nchw_out=True)


@pytest.mark.parametrize("grid", [(4, 4), (6, 5), (3, 2)], ids=["same", "larger", "smaller"])
def test_vit_pos_embed_block_and_resize(grid):
    """On the embedding's own grid, and resized bicubically (Keys a = -0.5,
    antialiased when shrinking) to a larger and a smaller one, as
    ``jax.image.resize`` resizes it."""
    jm = JB.VitPosEmbedBlock(dim=8, seqlens=(4, 4))
    v = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 8))), 3)
    x = _rand(4, 2, *grid, 8)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = load_jax_variables(TB.VitPosEmbedBlock(8, (4, 4)), flatten_variables(v))
    with torch.no_grad():
        got = _nhwc(tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())))
    np.testing.assert_allclose(got, want, **TOL)
    pe = np.asarray(v["params"]["embed"]["embed"])
    resized = np.asarray(jax.image.resize(jnp.asarray(pe), (1, *grid, 8), method="bicubic"))
    with torch.no_grad():
        ours = TV.VitPosEmbed2d(8, (4, 4))
        ours.embed.copy_(torch.from_numpy(pe.copy()))
        np.testing.assert_allclose(ours(torch.zeros(1, *grid, 8)).numpy(), resized, **TOL)


def test_flatten_pos_embed_block():
    _pair(JB.FlattenPosEmbedBlock(dim=8, seqlen=12), TB.FlattenPosEmbedBlock(8, 12),
          _rand(5, 2, 12, 8))


@pytest.mark.parametrize("k,s", [(3, 2), (3, 1)], ids=["strided", "unpadded"])
def test_sequence_conv2d_block(k, s):
    cfg = {"seqlens": [4, 6]}
    _pair(JB.SequenceConv2dBlock(c2=12, k=k, s=s, config=tuple(cfg.items())),
          TB.SequenceConv2dBlock(8, 12, k, s, cfg), _rand(6, 2, 24, 8))


def test_patch_merge_block():
    _pair(JB.PatchMergeBlock(seqlens=(4, 4), merge_factor=2, out_dim=12),
          TB.PatchMergeBlock(8, (4, 4), 2, 12), _rand(7, 2, 16, 8))


def test_patch_merging_sequence_and_image():
    _pair(JB.PatchMerging(), TB.PatchMerging(8), _rand(8, 2, 16, 8))
    _pair(JB.PatchMerging(), TB.PatchMerging(8), _rand(9, 2, 4, 6, 8), nchw_in=(0,),
          nchw_out=True)


def test_vision_clue_merge():
    cfg = {"seqlens": [4, 6]}
    _pair(JB.VisionClueMerge(out_dim=12, config=tuple(cfg.items())),
          TB.VisionClueMerge(8, 12, cfg), _rand(10, 2, 24, 8))


def test_patch_merger():
    _pair(JB.PatchMerger(num_tokens_out=3), TB.PatchMerger(8, 3), _rand(11, 2, 16, 8))


def test_vil_layer_norm_block_sequence_and_image():
    _pair(JB.ViLLayerNormBlock(), TB.ViLLayerNormBlock(8), _rand(12, 2, 16, 8))
    _pair(JB.ViLLayerNormBlock(), TB.ViLLayerNormBlock(8), _rand(13, 2, 3, 4, 8),
          nchw_in=(0,), nchw_out=True)


def test_multi_scale_fusion_block():
    """Two inputs: a high-resolution sequence and a low-resolution map."""
    high, low = _rand(14, 2, 16, 8), _rand(15, 2, 2, 3, 6)
    jm = JB.MultiScaleFusionBlock(fused_dim=10)
    v = _perturbed(jm.init(jax.random.PRNGKey(0), [jnp.asarray(high), jnp.asarray(low)]), 1)
    want = np.asarray(jm.apply(v, [jnp.asarray(high), jnp.asarray(low)]))
    tm = load_jax_variables(TB.MultiScaleFusionBlock(8, 6, 10), flatten_variables(v))
    with torch.no_grad():
        got = tm([torch.from_numpy(high), torch.from_numpy(low.transpose(0, 3, 1, 2).copy())])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_vil_fusion_block():
    """in_proj (c1 != c2), LSBlock, one ViLBlockPair at the block default head
    dim 16, the RGBlock MLP; eval mode (the BatchNorms on their perturbed
    running statistics)."""
    cfg = {"chunk_size": 8}
    _pair(JB.ViLFusionBlock(c2=32, config=tuple(cfg.items())), TB.ViLFusionBlock(8, 32, cfg),
          _rand(16, 2, 4, 6, 8), nchw_in=(0,), nchw_out=True, tol=VIL_TOL, jit=True)


def test_vision_lstm_block():
    """The ``VisionLSTM`` row: two ViLBlockPairs at the default head dim 16
    (dim 32: inner 64, four heads), partials after block 0 and at the end,
    NCHW."""
    cfg = {"depth": 2, "resolution": [16, 16], "patch_size": 4, "output_indices": [0]}
    jm = JB.VisionLSTMBlock(dim=32, config=tuple(cfg.items()))
    x = _rand(17, 2, 16, 16, 3)
    v = _perturbed(jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), a))(jnp.asarray(x)), 2)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    tm = load_jax_variables(TB.VisionLSTMBlock(3, 32, cfg), flatten_variables(v)).eval()
    assert tm.backbone.block0.fwd.layer.num_heads == 4
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), **VIL_TOL)


def test_vil_block_pair_block_seqlens_and_backend():
    """A (B, S, D) sequence takes the config's ``seqlens`` (here 3 x 4, not
    the square grid a 12-token sequence has none of); ``backend: native``
    runs the plain torch version (on the CPU the same numbers as ``auto``),
    and ``pallas`` refuses the CPU, where there is no kernel."""
    cfg = {"seqlens": [3, 4], "chunk_size": 8}
    x = _rand(18, 2, 12, 16)
    jm = JB.ViLBlockPairBlock(c2=16, config=tuple(cfg.items()))
    got, v = _pair(jm, TB.ViLBlockPairBlock(16, cfg), x, seed=3, tol=VIL_TOL, jit=True)
    for backend, err in (("native", None), ("auto", None), ("pallas", ValueError)):
        tm = load_jax_variables(TB.ViLBlockPairBlock(16, {**cfg, "backend": backend}),
                                flatten_variables(v)).eval()
        assert tm.pair0.fwd.layer.mlstm_backend == backend
        with torch.no_grad():
            if err is None:
                np.testing.assert_array_equal(tm(torch.from_numpy(x)).numpy(), got)
            else:
                with pytest.raises(err, match="pallas"):
                    tm(torch.from_numpy(x))
    with pytest.raises(ValueError, match="mlstm_backend"):
        TB.ViLBlockPairBlock(16, {"backend": "cuda"})


# the two wrapper-block graphs of tests/test_vil.py
GRAPHS = {
    "embed_vil_merge": ({"nc": 2, "backbone": [
        [-1, 1, "VitPatchEmbedBlock", [3, 32, [32, 32], 8]],      # 0: (B, 32, 4, 4)
        [-1, 1, "VitPosEmbedBlock", [32, 32, [4, 4]]],            # 1
        [-1, 1, "ImageToSequence", []],                           # 2: (B, 16, 32)
        [-1, 1, "ViLBlockPairBlock", [32, 32, {"seqlens": [4, 4], "chunk_size": 8}]],  # 3
        [-1, 1, "PatchMerging", []],                              # 4: (B, 4, 64)
        [-1, 1, "PatchMerger", [64, 2]],                          # 5: (B, 2, 64)
        [-1, 1, "ViLLayerNormBlock", [64]],                       # 6
    ]}, (2, 32, 32, 3), False),
    "clue_merge_to_image": ({"nc": 2, "backbone": [
        [-1, 1, "VitPatchEmbedBlock", [3, 16, [32, 32], 4]],       # 0: (B, 16, 8, 8)
        [-1, 1, "ImageToSequence", []],                            # 1: (B, 64, 16)
        [-1, 1, "VisionClueMerge", [16, 32, {"seqlens": [8, 8]}]], # 2: (B, 16, 32)
        [-1, 1, "SequenceToImage", [[4, 4]]],                      # 3: (B, 32, 4, 4)
    ]}, (1, 32, 32, 3), True),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_wrapper_graphs_match_jax(name):
    """Both graph compilers on the same YAML: the same channels per layer,
    and the port's graph on the JAX graph's (perturbed) variables gives the
    JAX output."""
    cfg, shape, image_out = GRAPHS[name]
    jp = jax_parse_model(cfg, ch=3)
    tp = parse_model(cfg, ch=3)
    assert [s.c2 for s in tp.specs] == [s.c2 for s in jp.specs]
    x = _rand(19, *shape)
    jm = JaxGraphModel(jp)
    v = _perturbed(jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False))(
        jnp.asarray(x)), 4)
    want = np.asarray(jax.jit(lambda v_, a: jm.apply(v_, a, train=False))(v, jnp.asarray(x)))
    tm = load_jax_variables(GraphModel(tp), flatten_variables(v)).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    got = _nhwc(got) if image_out else got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **VIL_TOL)

"""Port parity: the torch xLSTM language model against the JAX one.

Every module of ``xlstm_yolo_torch.nn.xlstm`` and the whole model are held
against their ``xlstm_yolo_tpu.nn.xlstm`` counterparts on the CPU: the JAX
module is initialized, every parameter is perturbed with seeded numpy noise
(so the gate kernels and the recurrent kernel, zero at init, matter), the
tree is loaded into the port with ``load_jax_variables``, and the same numpy
input goes through both. On the CPU the port's two kernels take their plain
versions and the JAX cell its native chunkwise form. Tolerance 1e-4 of each
output's max: fp32 throughout, differences come from summation order and
chunking only.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as jnn

from xlstm_yolo_tpu.nn import vil as JV
from xlstm_yolo_tpu.nn import xlstm as JX
from xlstm_yolo_torch.nn import vil as TV
from xlstm_yolo_torch.nn import xlstm as TX
from xlstm_yolo_torch.utils.jax_weights import (
    flatten_variables, load_jax_variables, port_named, torch_name)
from xlstm_yolo_torch.utils.loss import lm_loss
from xlstm_yolo_torch.utils.train_utils import StepUpdate

TOL_REL = 1e-4
LM = dict(vocab_size=50, embedding_dim=32, num_blocks=2, slstm_at=(1,), num_heads=4,
          chunk_size=8)


def assert_close(got, want, tol=TOL_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def jax_init(jm, x, seed, noise=0.05):
    """JAX variables of ``jm`` at input ``x``, every leaf perturbed."""
    rng = np.random.default_rng(seed)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return jax.tree_util.tree_map(
        lambda p: p + noise * jnp.asarray(rng.normal(size=p.shape), p.dtype), v)


def port(module, jax_vars):
    return load_jax_variables(module, flatten_variables(jax_vars)).eval()


def n_params(tree):
    return sum(x.size for x in jax.tree.leaves(tree))


def check_module(jm, tm, x, seed):
    v = jax_init(jm, x, seed)
    tm = port(tm, v)
    assert sum(p.numel() for p in tm.parameters()) == n_params(v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_close(got.numpy(), jm.apply(v, jnp.asarray(x)))


def seq(seed, S=16, D=32, B=2):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(np.float32)


@pytest.mark.parametrize("kernel_size", [4, 0])
def test_causal_conv1d_matches_jax(kernel_size):
    check_module(JX.CausalConv1d(32, kernel_size), TX.CausalConv1d(32, kernel_size), seq(0), 0)


def test_causal_conv1d_is_causal():
    conv = TX.CausalConv1d(8, 4)
    conv.init_params(torch.Generator().manual_seed(0))
    x = torch.from_numpy(seq(1, S=10, D=8))
    x2 = x.clone()
    x2[:, 6:] += 1.0
    with torch.no_grad():
        assert torch.equal(conv(x)[:, :6], conv(x2)[:, :6])


@pytest.mark.parametrize("use_bias", [True, False])
def test_linear_headwise_expand_forward_matches_jax(use_bias):
    """Heads of 4 x 4, the language model's q/k/v projections."""
    check_module(JV.LinearHeadwiseExpand(32, 8, use_bias=use_bias),
                 TV.LinearHeadwiseExpand(32, 8, use_bias=use_bias), seq(2), 2)


def test_layer_norm_applies_one_plus_scale():
    x = seq(3)
    jm = JV.LayerNorm()
    check_module(jm, TV.LayerNorm(32), x, 3)
    tm = TV.LayerNorm(32)
    assert tm.eps == 1e-5 and bool((tm.scale == 0).all())  # weight 1 at init
    want = torch.nn.functional.layer_norm(torch.from_numpy(x), (32,), eps=1e-5)
    with torch.no_grad():
        assert_close(tm(torch.from_numpy(x)).numpy(), want.numpy(), 1e-6)


def test_multihead_layernorm_without_bias_matches_jax():
    x = np.random.default_rng(4).normal(size=(2, 4, 9, 8)).astype(np.float32) * 3 + 1
    tm = TV.MultiHeadLayerNorm(4, 32, eps=1e-5, with_bias=False)
    assert [n for n, _ in tm.named_parameters()] == ["scale"]
    check_module(JV.MultiHeadLayerNorm(num_heads=4, with_bias=False, eps=1e-5), tm, x, 4)
    fresh = TV.MultiHeadLayerNorm(4, 32)
    assert bool((fresh.scale == 0).all()) and bool((fresh.affine()[0] == 1).all())  # 1 + scale


@pytest.mark.parametrize("S", [16, 13])
def test_matrix_lstm_cell_forward_matches_jax(S):
    """The natural-layout cell at whole and ragged S: on the CPU the JAX cell
    halves the chunk until it divides S, the port pads its plain version."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, S, 64)).astype(np.float32) for _ in range(3))
    kw = dict(dim=64, num_heads=4, chunk_size=8, norm_bias=False, norm_eps=1e-5,
              igate_init="xlstm")
    jm = JV.MatrixLSTMCell(**kw)
    rngp = np.random.default_rng(6)
    var = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, (q, k, v)))
    var = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(rngp.normal(size=p.shape), p.dtype), var)
    tm = port(TV.MatrixLSTMCell(**kw), var)
    assert "outnorm.bias" not in tm.state_dict()
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (q, k, v)))
    assert_close(got.numpy(), jm.apply(var, *map(jnp.asarray, (q, k, v))))


def test_matrix_lstm_cell_igate_init():
    g = torch.Generator().manual_seed(0)
    vil_cell, lm_cell = TV.MatrixLSTMCell(64, 4), TV.MatrixLSTMCell(64, 4, igate_init="xlstm")
    vil_cell.init_params(g)
    lm_cell.init_params(g)
    assert bool((vil_cell.igate.bias == -10.0).all())
    ibias = lm_cell.igate.bias.detach()
    assert float(ibias.abs().max()) < 1.0 and float(ibias.std()) > 0
    assert bool((lm_cell.igate.weight == 0).all()) and bool((lm_cell.fgate.weight == 0).all())
    with pytest.raises(ValueError):
        TV.MatrixLSTMCell(64, 4, igate_init="other")


@pytest.mark.parametrize("S,conv", [(16, 4), (13, 4), (16, 0)])
def test_slstm_layer_matches_jax(S, conv):
    kw = dict(embedding_dim=32, num_heads=4, conv1d_kernel_size=conv, block_idx=1, num_blocks=2)
    check_module(JX.sLSTMLayer(**kw), TX.sLSTMLayer(**kw), seq(7, S=S), 7)


def test_slstm_layer_state_carry_matches_jax():
    kw = dict(embedding_dim=32, num_heads=4, conv1d_kernel_size=0)
    x = seq(8, S=12)
    jm = JX.sLSTMLayer(**kw)
    v = jax_init(jm, x, 8)
    tm = port(TX.sLSTMLayer(**kw), v)
    y1j, stj = jm.apply(v, jnp.asarray(x[:, :6]), return_last_state=True)
    y2j = jm.apply(v, jnp.asarray(x[:, 6:]), initial_state=stj)
    with torch.no_grad():
        y1t, stt = tm(torch.from_numpy(x[:, :6]), return_last_state=True)
        y2t = tm(torch.from_numpy(x[:, 6:]), initial_state=stt)
        full = tm(torch.from_numpy(x))
    assert_close(y1t.numpy(), y1j)
    assert_close(y2t.numpy(), y2j)
    assert_close(torch.cat([y1t, y2t], 1).numpy(), full.numpy())  # no conv: carry is exact


def test_slstm_layer_gate_sources():
    """i and f read the conv branch, z and o the raw input."""
    layer = TX.sLSTMLayer(32, num_heads=4)
    g = torch.Generator().manual_seed(0)
    for m in layer.modules():
        if hasattr(m, "init_params"):
            m.init_params(g)
    x = torch.from_numpy(seq(9))
    with torch.no_grad():
        base = layer(x)
        layer.conv1d.conv.weight.mul_(2.0)  # changes i/f only
        layer.zgate.weight.zero_()
        layer.ogate.weight.zero_()
        no_zo = layer(x)
    assert not torch.allclose(base, no_zo)
    # with z and o cut, y = sigmoid(0) c / n with c = sum of tanh(0) = 0: the group norm of 0
    assert float(no_zo.abs().max()) == 0.0


def test_slstm_layer_init_bias():
    layer = TX.sLSTMLayer(32, num_heads=4, block_idx=1, num_blocks=2)
    layer.init_params(torch.Generator().manual_seed(0))
    want = JX.powerlaw_blockdependent_bias(4, 8, 1, 2)
    assert_close(layer.bias[:, 1].detach().numpy(), want)
    assert bool((layer.bias[:, [0, 2, 3]] == 0).all()) and bool((layer.recurrent_kernel == 0).all())


@pytest.mark.parametrize("S", [16, 13])
def test_mlstm_layer1d_matches_jax(S):
    kw = dict(embedding_dim=32, num_heads=4, chunk_size=8, num_blocks=2)
    check_module(JX.mLSTMLayer1d(**kw), TX.mLSTMLayer1d(**kw), seq(10, S=S), 10)


def test_mlstm_layer1d_heads_and_branches():
    """Projection heads (inner // 4 blocks of 4 x 4) and cell heads (4) are
    different numbers; q and k come from the conv branch, v from the raw one."""
    layer = TX.mLSTMLayer1d(32, num_heads=4)
    assert layer.inner == 64  # 2 x 32 rounded up to a multiple of 64
    assert tuple(layer.q_proj.weight.shape) == (16, 4, 4) and layer.q_proj.bias is None
    assert layer.mlstm_cell.num_heads == 4 and layer.mlstm_cell.outnorm.eps == 1e-5
    assert tuple(layer.mlstm_cell.igate.weight.shape) == (4, 192)
    g = torch.Generator().manual_seed(0)
    for m in layer.modules():
        if hasattr(m, "init_params"):
            m.init_params(g)
    x = torch.from_numpy(seq(11))
    with torch.no_grad():
        base = layer(x)
        layer.v_proj.weight.zero_()  # v = 0 -> h = 0 -> outnorm(0) = 0: only the skip is left
        x_m, z = layer.proj_up(x).split(64, dim=-1)
        skip_only = torch.nn.functional.silu(layer.conv1d(x_m)) * torch.nn.functional.silu(z)
        assert_close(layer(x).numpy(), layer.proj_down(skip_only).numpy(), 1e-5)
    assert not torch.allclose(base, layer(x))


@pytest.mark.parametrize("proj_factor,num_blocks", [(1.3, 2), (2.0, 1), (4.0, 7)])
def test_gated_feed_forward_matches_jax(proj_factor, num_blocks):
    kw = dict(embedding_dim=32, proj_factor=proj_factor, num_blocks=num_blocks)
    check_module(JX.GatedFeedForward(**kw), TX.GatedFeedForward(**kw), seq(12) * 2.0, 12)


def test_gated_feed_forward_gelu_is_the_tanh_approximation():
    """flax's ``nn.gelu`` defaults to the tanh approximation, torch's
    ``F.gelu`` to the exact form; they differ by up to 5e-4 near |x| = 2."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    ffn = TX.GatedFeedForward(2)  # on rows (x, 1): gate 0 passes x, up 0 passes 1
    with torch.no_grad():
        for w in (ffn.proj_up.weight, ffn.proj_down.weight):
            w.zero_()
        ffn.proj_up.weight[0, 0] = ffn.proj_up.weight[ffn.up, 1] = ffn.proj_down.weight[0, 0] = 1.0
        got = ffn(torch.stack([torch.from_numpy(x), torch.ones(101)], dim=1))[:, 0].numpy()
    np.testing.assert_allclose(got, np.asarray(jnn.gelu(jnp.asarray(x))), rtol=0, atol=1e-6)
    assert np.abs(got - torch.nn.functional.gelu(torch.from_numpy(x)).numpy()).max() > 1e-4
    assert TX.GatedFeedForward(32).up == TX._round_up_proj(32, 1.3) == 64
    assert TX._round_up_proj(128, 1.3) == 192 and JX._round_up_proj(128, 1.3) == 192


@pytest.mark.parametrize("kind,ffn", [("mlstm", 0.0), ("slstm", 1.3)])
def test_xlstm_block_matches_jax(kind, ffn):
    kw = dict(embedding_dim=32, kind=kind, num_heads=4, chunk_size=8, ffn_proj_factor=ffn,
              block_idx=1, num_blocks=2)
    check_module(JX.xLSTMBlock(**kw), TX.xLSTMBlock(**kw), seq(13), 13)


def test_xlstm_block_stack_matches_jax():
    kw = dict(embedding_dim=32, num_blocks=3, slstm_at=(1,), num_heads=4, chunk_size=8)
    tm = TX.xLSTMBlockStack(**kw)
    # only the sLSTM block carries the FFN
    assert tm.block1.ffn is not None and tm.block0.ffn is None and tm.block2.ffn is None
    check_module(JX.xLSTMBlockStack(**kw), tm, seq(14), 14)


@pytest.mark.parametrize("tie_weights", [False, True])
@pytest.mark.parametrize("S", [16, 13])
def test_xlstm_lm_model_matches_jax(tie_weights, S):
    tokens = np.random.default_rng(15).integers(0, 50, (2, S))
    jm = JX.xLSTMLMModel(**LM, tie_weights=tie_weights)
    v = jax_init(jm, tokens, 15)
    tm = port(TX.xLSTMLMModel(**LM, tie_weights=tie_weights, device="cpu"), v)
    assert tm.num_params() == n_params(v)
    assert ("lm_head.weight" in tm.state_dict()) == (not tie_weights)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens))
    assert got.shape == (2, S, 50)
    assert_close(got.numpy(), jax.jit(jm.apply)(v, jnp.asarray(tokens)))


def test_xlstm_lm_model_init_matches_jax_statistics():
    """Seeded init with the JAX scheme: the same parameter tree, zero gate
    and recurrent kernels, and weight scales of the same size."""
    tokens = np.zeros((1, 8), np.int64)
    jm = JX.xLSTMLMModel(**LM)
    flat = flatten_variables(jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens)))
    tm = TX.xLSTMLMModel(**LM, device="cpu", seed=0)
    state = tm.state_dict()
    named = dict(torch_name(k, a) for k, a in flat.items())
    assert sorted(named) == sorted(state)
    for name, arr in named.items():
        assert tuple(state[name].shape) == arr.shape, name
        js, ts = float(arr.std()), float(state[name].float().std())
        if js == 0.0:
            assert ts == 0.0 or "igate.bias" in name, name
        elif arr.size >= 1024:
            assert 0.8 < ts / js < 1.25, (name, ts, js)
    again = TX.xLSTMLMModel(**LM, device="cpu", seed=0).state_dict()
    assert all(torch.equal(state[k], again[k]) for k in state)


def test_xlstm_lm_model_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TX.xLSTMLMModel(**LM)


def test_generate_greedy_matches_jax():
    prompt = np.random.default_rng(16).integers(0, 50, 6)
    jm = JX.xLSTMLMModel(**LM)
    v = jax_init(jm, prompt[None], 16, noise=0.2)
    tm = port(TX.xLSTMLMModel(**LM, device="cpu"), v)
    want = JX.generate(jm, v, prompt, max_new_tokens=4)
    got = TX.generate(tm, prompt, max_new_tokens=4)
    assert got.shape == (10,) and got.tolist() == want
    with torch.no_grad():
        logits = tm(got[None, :-1])[0, -1]
    assert_close(logits.numpy(), jm.apply(v, jnp.asarray([want[:-1]]))[0, -1])
    assert int(logits.argmax()) == want[-1]


def test_generate_batched_and_sampled():
    tm = TX.xLSTMLMModel(**LM, device="cpu", seed=1)
    prompt = torch.from_numpy(np.random.default_rng(17).integers(0, 50, (3, 5)))
    greedy = TX.generate(tm, prompt, max_new_tokens=2)
    assert greedy.shape == (3, 7) and torch.equal(greedy[:, :5], prompt)
    for b in range(3):  # a batch row is generated as it would be alone
        assert torch.equal(TX.generate(tm, prompt[b], max_new_tokens=2), greedy[b])
    state = torch.random.get_rng_state()
    draws = [TX.generate(tm, prompt, max_new_tokens=3, temperature=1.0,
                         generator=torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert torch.equal(state, torch.random.get_rng_state())  # the global RNG is untouched
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < 50


def test_loader_rules_for_the_language_model():
    rng = np.random.default_rng(18)
    conv = rng.normal(size=(4, 1, 6)).astype(np.float32)
    name, arr = torch_name("params/stack/block0/xlstm/conv1d/conv/kernel", conv)
    assert name == "stack.block0.xlstm.conv1d.conv.weight" and arr.shape == (6, 1, 4)
    np.testing.assert_array_equal(arr[:, 0, :], conv[:, 0, :].T)
    emb = rng.normal(size=(50, 8)).astype(np.float32)
    name, arr = torch_name("params/embedding/embedding", emb)
    assert name == "embedding.weight"
    np.testing.assert_array_equal(arr, emb)  # not transposed
    head = rng.normal(size=(8, 50)).astype(np.float32)
    name, arr = torch_name("params/lm_head/kernel", head)
    assert name == "lm_head.weight"
    np.testing.assert_array_equal(arr, head.T)
    # the rank rules apply to leaves named ``kernel`` only
    for leaf, shape in (("recurrent_kernel", (4, 8, 4, 8)), ("bias", (4, 4, 8)),
                        ("weight", (16, 4, 4))):
        a = rng.normal(size=shape).astype(np.float32)
        name, arr = torch_name(f"params/stack/block1/xlstm/{leaf}", a)
        assert name == f"stack.block1.xlstm.{leaf}"
        np.testing.assert_array_equal(arr, a)
    # 5-D is a 3-D conv's DHWIO kernel (the video embeds), OIDHW in the port
    vid = rng.normal(size=(2, 3, 4, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(torch_name("params/x/kernel", vid)[1],
                                  vid.transpose(4, 3, 0, 1, 2))
    with pytest.raises(ValueError, match="kernel rank"):
        torch_name("params/x/kernel", np.zeros((2, 2, 2, 2, 2, 2), np.float32))
    with pytest.raises(ValueError, match="kernel rank"):
        torch_name("params/x/kernel", np.zeros((3,), np.float32))


def test_loader_rejects_a_mismatched_language_model():
    tokens = np.zeros((1, 8), np.int64)
    v = jax_init(JX.xLSTMLMModel(**LM), tokens, 19)
    flat = flatten_variables(v)
    with pytest.raises(KeyError, match="extra"):  # an untied head into a tied model
        load_jax_variables(TX.xLSTMLMModel(**LM, tie_weights=True, device="cpu"), flat)
    wide = TX.xLSTMLMModel(**{**LM, "vocab_size": 60}, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_variables(wide, flat)


def test_lm_loss_matches_optax():
    import optax

    rng = np.random.default_rng(20)
    logits = (rng.normal(size=(2, 7, 11)) * 3).astype(np.float32)
    targets = rng.integers(0, 11, (2, 7))
    want = optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(logits),
                                                           jnp.asarray(targets)).mean()
    got = lm_loss(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _train_step_matches_jax(cfg, S, seed, recurrent_std=0.0):
    """One train step of ``xLSTMLMModel(**cfg)``: next-token loss and every
    gradient against ``jax.value_and_grad`` (loss rtol 1e-5, gradients 1e-4
    of each tensor's max), then the parameters and their EMA after
    ``StepUpdate`` against the JAX package's SGD step. Every JAX leaf is
    perturbed with seeded noise; the sLSTM recurrent kernels (zero at init)
    get ``recurrent_std`` more, so the recurrence's gradient matters."""
    import optax  # noqa: F401  (build_flat_step's optimizer)

    from xlstm_yolo_tpu.utils import train_utils as JTU

    tokens = np.random.default_rng(seed).integers(0, cfg["vocab_size"], (2, S))
    x, y = tokens[:, :-1], tokens[:, 1:]
    jm = JX.xLSTMLMModel(**cfg)
    v = jax_init(jm, x, seed)
    rng = np.random.default_rng(seed + 1)
    v = jax.tree_util.tree_map_with_path(
        lambda path, p: p + recurrent_std * jnp.asarray(rng.normal(size=p.shape), p.dtype)
        if "recurrent_kernel" in jax.tree_util.keystr(path) else p, v)

    def loss_fn(params):
        import optax as ox

        logits = jm.apply({"params": params}, jnp.asarray(x))
        return ox.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    want, grads = jax.value_and_grad(loss_fn)(v["params"])
    tm = port(TX.xLSTMLMModel(**cfg, device="cpu"), v).train()
    update = StepUpdate(tm)
    got = lm_loss(tm(torch.from_numpy(x)), torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    named = dict(tm.named_parameters())
    want_g = port_named(flatten_variables(grads))
    assert sorted(want_g) == sorted(named)
    for n, g in want_g.items():
        assert_close(named[n].grad.numpy(), g)

    step_update, init_fn, *_ = JTU.build_flat_step(v["params"], name="SGD", lr=0.01,
                                                   momentum=0.937, clip_norm=0.5)
    p, ema, _ = step_update(grads, init_fn(v["params"]), v["params"], v["params"],
                            jnp.float32(0.01), 1)
    update(1)
    want_p, want_e = port_named(flatten_variables(p)), port_named(flatten_variables(ema))
    for i, n in enumerate(update.names):
        np.testing.assert_allclose(named[n].detach().numpy(), want_p[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)
        np.testing.assert_allclose(update.ema[i].numpy(), want_e[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("S", [17, 14])
def test_mlstm_lm_train_step_matches_jax(S):
    """One train step of a small mLSTM-only language model (the class
    default ``slstm_at=()``), as ``_train_step_matches_jax`` checks it."""
    _train_step_matches_jax(dict(vocab_size=50, embedding_dim=32, num_blocks=2, num_heads=4,
                                 chunk_size=8), S, seed=21)


def test_slstm_lm_train_step_matches_jax():
    """One train step of a small language model with an sLSTM block
    (``slstm_at=(1,)``, sLSTM head dim 8), its recurrent kernel drawn well
    away from zero: on the CPU the sLSTM scan is differentiated by autograd,
    as the JAX entry's backward takes ``jax.vjp`` of its scan."""
    _train_step_matches_jax(dict(vocab_size=50, embedding_dim=32, num_blocks=2, slstm_at=(1,),
                                 num_heads=4, chunk_size=8), 17, seed=22, recurrent_std=0.2)


def test_lm_train_step_at_head_dim_128_matches_jax():
    """One train step of an mLSTM-only language model whose cell runs at
    head dim 128 (embedding 256, inner 512 over 4 heads), the width at
    which the chunkwise backward's wide path runs on the card."""
    _train_step_matches_jax(dict(vocab_size=50, embedding_dim=256, num_blocks=2, num_heads=4,
                                 chunk_size=8), 17, seed=23)

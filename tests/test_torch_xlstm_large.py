"""Port parity: the torch xLSTM-7B text model against the JAX one.

``xlstm_yolo_torch.nn.xlstm_large`` against ``xlstm_yolo_tpu.nn.xlstm_large``
on the CPU at the JAX test's small config (vocab 41, embedding 32, 2 blocks,
2 heads, chunk 8): seeded numpy values fill the JAX model's variable tree
(its structure from ``jax.eval_shape``; nonzero gate biases, norm scales
away from one), the tree is loaded into the port with
``load_jax_variables``, and the same token ids go through both. Logits and
the carried (C, n, m) state within 1e-4 of each output's max (fp32,
summation order only); generated tokens exactly; the checkpoint round trip
within 1e-5 (rtol and atol, the JAX test's), a BF16 tensor read as the JAX
reader reads it. Also ``mlstm_parallel``, ``mlstm_recurrent(initial_state=)``
at DQK != DV and ``GatedFeedForward`` at each ``act_fn``. Torch runs on one
thread (module fixture), so the file stays fast under parallel workers.
"""
import json
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors.numpy import save_file

from xlstm_yolo_tpu.kernels import mlstm_native as JN
from xlstm_yolo_tpu.nn import xlstm as JX
from xlstm_yolo_tpu.nn import xlstm_large as JL
from xlstm_yolo_torch.kernels import mlstm_native as TN
from xlstm_yolo_torch.nn import xlstm as TX
from xlstm_yolo_torch.nn import xlstm_large as TL
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables
from xlstm_yolo_torch.utils.safetensors_np import read_safetensors

TOL_REL = 1e-4
CFG = dict(vocab_size=41, embedding_dim=32, num_blocks=2, num_heads=2, chunk_size=8)


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
    kernels and embeddings normal over sqrt(fan_in), norm scales near one,
    biases small."""
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        key, shape = getattr(path[-1], "key", ""), sds.shape
        if key in ("kernel", "embedding"):
            x = rng.normal(size=shape) / np.sqrt(shape[0] if key == "kernel" else shape[1])
        elif key == "scale":
            x = 1 + 0.1 * rng.normal(size=shape)
        else:
            x = 0.1 * rng.normal(size=shape)
        return jnp.asarray(x.astype(np.float32))

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, seeded variables, the port model holding them)."""
    jm = JL.xLSTMLarge(**CFG)
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)), 0)
    tm = load_jax_variables(TL.xLSTMLarge(**CFG, device="cpu"), flatten_variables(v))
    return jm, v, tm


def tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], shape)


def test_param_count_and_init_match_jax(pair):
    jm, v, tm = pair
    n_jax = sum(x.size for x in jax.tree.leaves(v))
    assert tm.num_params() == n_jax
    fresh = TL.xLSTMLarge(**CFG, device="cpu", seed=3)
    ml = fresh.blocks_0.mlstm_layer
    assert bool((ml.multihead_norm.scale == 1).all()) and ml.multihead_norm.bias is None
    assert ml.q.bias is None and bool((ml.igate_preact.bias == 0).all())  # gates keep a bias
    assert ml.q.weight.abs().max() <= 2 * (1 / 32) ** 0.5 / 0.87962566103423978 + 1e-6  # trunc


@pytest.mark.parametrize("S", [16, 9], ids=["chunkwise", "recurrent"])
def test_logits_match_jax(pair, S):
    jm, v, tm = pair
    t = tokens(1, (2, S))
    want = jax.jit(jm.apply)(v, jnp.asarray(t))
    with torch.no_grad():
        got = tm(torch.from_numpy(t))
    assert got.shape == (2, S, CFG["vocab_size"])
    assert float(got.abs().max()) <= jm.output_logit_soft_cap + 1e-4
    assert_close(got.numpy(), want)


def test_prefill_and_step_state_and_logits_match_jax(pair):
    """The chunkwise prefill's state, then one recurrent step from it, as
    JAX; the step's logits also equal a from-scratch forward over the 9
    tokens (the JAX test's 2e-3)."""
    jm, v, tm = pair
    t = tokens(2, (1, 9))
    prompt, nxt = jnp.asarray(t[:, :8]), jnp.asarray(t[:, 8:])
    run = jax.jit(lambda v, x, s: jm.apply(v, x, state=s, return_last_states=True))
    jl, js = jax.jit(lambda v, x: jm.apply(v, x, return_last_states=True))(v, prompt)
    jl2, js2 = run(v, nxt, js)
    with torch.no_grad():
        tl, ts = tm(torch.from_numpy(t[:, :8]), return_last_states=True)
        tl2, ts2 = tm(torch.from_numpy(t[:, 8:]), state=ts, return_last_states=True)
        full = tm(torch.from_numpy(t))
    assert_close(tl.numpy(), jl)
    assert_close(tl2.numpy(), jl2)
    for got, want in ((ts, js), (ts2, js2)):
        for i in range(CFG["num_blocks"]):
            for g, w in zip(got[i], want[i]):
                assert_close(g.numpy(), w)
    assert ts[0][0].shape == (1, 2, 8, 16)  # C is (DQK, DV)
    np.testing.assert_allclose(tl2[:, 0].numpy(), full[:, -1].numpy(), rtol=2e-3, atol=2e-3)


def test_generate_greedy_matches_jax(pair):
    jm, v, tm = pair
    prompt = [[3, 5, 7, 11, 13]]
    want = np.asarray(JL.generate(jm, v, jnp.asarray(prompt), max_new_tokens=6))
    got = TL.generate(tm, prompt, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["greedy", "sampled"])
def test_generate_scan_matches_generate(pair, temperature):
    """On the CPU the decode step runs eagerly on the static buffers; it
    gives ``generate``'s tokens, and a seeded generator the same draws
    twice."""
    _, _, tm = pair
    prompt = tokens(3, (2, 8))

    def gen(fn, seed):
        return fn(tm, prompt, max_new_tokens=7, temperature=temperature,
                  generator=torch.Generator().manual_seed(seed))

    want = gen(TL.generate, 5)
    np.testing.assert_array_equal(gen(TL.generate_scan, 5).numpy(), want.numpy())
    np.testing.assert_array_equal(gen(TL.generate_scan, 5).numpy(), want.numpy())
    assert want.shape == (2, 15)
    if temperature:
        assert not torch.equal(gen(TL.generate, 6), want)


def torch_named(params, num_blocks):
    """A JAX ``xLSTMLarge`` params tree -> the torch state dict of an
    xLSTM-7B checkpoint (the JAX test's ``_write_fake_ckpt`` names)."""
    p = jax.tree.map(np.asarray, params)
    sd = {"embedding.weight": p["embedding"]["embedding"],
          "backbone.out_norm.weight": p["out_norm"]["scale"],
          "lm_head.weight": p["lm_head"]["kernel"].T.copy()}
    for i in range(num_blocks):
        b, blk = f"backbone.blocks.{i}", p[f"blocks_{i}"]
        sd[f"{b}.norm_mlstm.weight"] = blk["norm_mlstm"]["scale"]
        sd[f"{b}.norm_ffn.weight"] = blk["norm_ffn"]["scale"]
        ml = blk["mlstm_layer"]
        for lin in ("q", "k", "v", "ogate_preact", "igate_preact", "fgate_preact", "out_proj"):
            sd[f"{b}.mlstm_layer.{lin}.weight"] = ml[lin]["kernel"].T.copy()
            if "bias" in ml[lin]:
                sd[f"{b}.mlstm_layer.{lin}.bias"] = ml[lin]["bias"]
        sd[f"{b}.mlstm_layer.multihead_norm.weight"] = ml["multihead_norm"]["scale"]
        for lin in ("proj_up_gate", "proj_up", "proj_down"):
            sd[f"{b}.ffn.{lin}.weight"] = blk["ffn"][lin]["kernel"].T.copy()
    return sd


def write_checkpoint(path, sd, layout, cfg=CFG):
    """``sd`` under ``path`` as ``model.safetensors`` ("single"),
    ``model-0000{k}-of-00002.safetensors`` ("shards") or
    ``model_{k}.safetensors`` ("numbered"), with ``config.json``."""
    names = sorted(sd)
    if layout == "single":
        save_file(sd, str(path / "model.safetensors"))
    else:
        for k, part in enumerate((names[::2], names[1::2])):
            fname = (f"model-{k + 1:05d}-of-00002.safetensors" if layout == "shards"
                     else f"model_{k}.safetensors")
            save_file({n: sd[n] for n in part}, str(path / fname))
    (path / "config.json").write_text(json.dumps(cfg))


@pytest.mark.parametrize("layout", ["single", "shards", "numbered"])
def test_from_pretrained_matches_jax(tmp_path, pair, layout):
    jm, v, tm = pair
    write_checkpoint(tmp_path, torch_named(v["params"], CFG["num_blocks"]), layout)
    jm2, v2 = JL.from_pretrained(tmp_path)
    t = tokens(4, (1, 16))
    want = jax.jit(jm2.apply)(v2, jnp.asarray(t))
    model = TL.from_pretrained(tmp_path, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), tm(torch.from_numpy(t)).numpy(),
                                   rtol=1e-5, atol=1e-5)


def write_raw_file(path, name, dtype, values: np.ndarray):
    """A one-tensor safetensors file of ``dtype`` holding the bytes of
    ``values``, written by hand (numpy has no bf16 or fp8 type to hand
    ``save_file``)."""
    raw = values.tobytes()
    header = json.dumps({name: {"dtype": dtype, "shape": list(values.shape),
                                "data_offsets": [0, len(raw)]}}).encode()
    path.write_bytes(struct.pack("<Q", len(header)) + header + raw)


def bf16_checkpoint(tmp_path, params, dtype="BF16"):
    """The checkpoint of ``params`` in two shards, the second holding
    ``lm_head.weight`` alone as a ``dtype`` tensor: its fp32 values'
    top 16 bits for BF16 (their bf16 truncation), their top byte for an
    8-bit type."""
    sd = torch_named(params, CFG["num_blocks"])
    head = sd.pop("lm_head.weight")
    write_checkpoint(tmp_path, sd, "single")
    (tmp_path / "model.safetensors").rename(tmp_path / "model-00001-of-00002.safetensors")
    bits = np.ascontiguousarray(head).view(np.uint32)
    raw = (bits >> 16).astype(np.uint16) if dtype == "BF16" else (bits >> 24).astype(np.uint8)
    write_raw_file(tmp_path / "model-00002-of-00002.safetensors", "lm_head.weight", dtype, raw)
    return (bits & 0xFFFF0000).view(np.float32)


def test_from_pretrained_reads_bf16_as_jax_does(tmp_path, pair):
    """The JAX reader, in a process that has imported JAX, reads a BF16
    tensor as ``ml_dtypes.bfloat16`` (JAX registers it with numpy) and the
    Dense computes with its values in fp32; the port widens it to fp32
    exactly. Logits within 1e-5 of JAX's on the same directory."""
    jm, v, _ = pair
    head = bf16_checkpoint(tmp_path, v["params"])
    jm2, v2 = JL.from_pretrained(tmp_path)
    assert v2["params"]["lm_head"]["kernel"].dtype == jnp.bfloat16
    model = TL.from_pretrained(tmp_path, device="cpu")
    np.testing.assert_array_equal(model.lm_head.weight.detach().numpy(), head)
    t = tokens(10, (1, 16))
    want = jax.jit(jm2.apply)(v2, jnp.asarray(t))
    with torch.no_grad():
        got = model(torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_from_pretrained_refuses_fp8_as_jax_does(tmp_path, pair):
    """An 8-bit float tensor: the JAX reader raises (numpy has no
    ``float8_e4m3fn``), the port's reader a ValueError naming it."""
    jm, v, _ = pair
    bf16_checkpoint(tmp_path, v["params"], dtype="F8_E4M3")
    with pytest.raises(AttributeError):
        JL.from_pretrained(tmp_path)
    with pytest.raises(ValueError, match="lm_head.weight.*F8_E4M3"):
        TL.from_pretrained(tmp_path, device="cpu")


def test_from_pretrained_refuses_a_shape_mismatch(tmp_path, pair):
    jm, v, _ = pair
    write_checkpoint(tmp_path, torch_named(v["params"], CFG["num_blocks"]), "single",
                     cfg={**CFG, "embedding_dim": 64})
    with pytest.raises(ValueError):
        JL.from_pretrained(tmp_path)
    with pytest.raises(ValueError, match="shapes"):
        TL.from_pretrained(tmp_path, device="cpu")


def test_safetensors_reader_matches_the_package(tmp_path):
    rng = np.random.default_rng(5)
    sd = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": np.arange(6, dtype=np.int64),
          "c": rng.normal(size=(2, 2, 2)).astype(np.float16), "d": np.zeros((0, 3), np.float32)}
    save_file(sd, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got = read_safetensors(tmp_path / "x.safetensors")
    assert sorted(got) == sorted(sd)
    for k, want in sd.items():
        assert got[k].dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got[k]), want)


def mlstm_inputs(seed, S=12, DQK=8, DV=16, B=2, NH=2):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(B, NH, S, DQK)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, NH, S, DV)).astype(np.float32)
    i, f = (rng.normal(size=(B, NH, S)).astype(np.float32) * 2 for _ in range(2))
    return q, k, v, i, f


@pytest.mark.parametrize("igate_act", ["exp", "sigmoid"])
def test_mlstm_parallel_matches_jax(igate_act):
    args = mlstm_inputs(6)
    want = JN.mlstm_parallel(*map(jnp.asarray, args), igate_act=igate_act)
    got = TN.mlstm_parallel(*map(torch.from_numpy, args), igate_act=igate_act)
    assert_close(got.numpy(), want)
    assert_close(got.numpy(), TN.mlstm_recurrent(*map(torch.from_numpy, args),
                                                  igate_act=igate_act).numpy())


def test_mlstm_recurrent_from_a_carried_state_matches_jax():
    """At DQK 8, DV 16, from the state a first segment leaves."""
    first, rest = mlstm_inputs(7, S=8), mlstm_inputs(8, S=5)
    _, state = JN.mlstm_recurrent(*map(jnp.asarray, first), return_last_state=True)
    want, want_last = JN.mlstm_recurrent(*map(jnp.asarray, rest), initial_state=state,
                                         return_last_state=True)
    tstate = tuple(torch.from_numpy(np.array(s)) for s in state)
    got, last = TN.mlstm_recurrent(*map(torch.from_numpy, rest), initial_state=tstate,
                                   return_last_state=True)
    assert_close(got.numpy(), want)
    for g, w in zip(last, want_last):
        assert_close(g.numpy(), w)
    assert last[0].shape == (2, 2, 8, 16)


@pytest.mark.parametrize("act_fn", ["gelu", "relu", "swish", "sigmoid", "selu", "relu^2"])
def test_gated_feedforward_act_fn_matches_jax(act_fn):
    x = np.random.default_rng(9).normal(size=(2, 5, 32)).astype(np.float32)
    jm = JX.GatedFeedForward(32, act_fn=act_fn)
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 9)
    tm = load_jax_variables(TX.GatedFeedForward(32, act_fn=act_fn), flatten_variables(v))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_close(got.numpy(), jm.apply(v, jnp.asarray(x)))

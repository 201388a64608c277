"""The port's parallel stack (``xlstm_yolo_torch/parallel``,
``kernels/mlstm_sp.py``) against the JAX package's, on the CPU.

One gloo world of four spawned ranks (``tests/torch_parallel_ranks.py``,
a ``FileStore`` in a temporary directory, one torch thread a rank) runs
every multi-rank case once; the tests below read its results. The JAX
references run here, in the parent, on the conftest's 8 virtual devices.
Tolerances are the JAX package's own for its sharded runs
(``tests/test_parallel.py``, ``tests/test_pp_ep.py``) where they exist:
the sp mLSTM rtol = atol = 3e-4, the dp loss rtol 1e-4, the multi-step
losses rtol 2e-3, the pipeline 2e-5, the MoE 1e-5.
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_ranks as R
from xlstm_yolo_torch.kernels.mlstm_native import mlstm_chunkwise
from xlstm_yolo_torch.kernels.mlstm_sp import (exclusive_prefix, mlstm_chunkwise_sp,
                                               seeded_pass, segment_summary)
from xlstm_yolo_torch.parallel.mesh import build_mesh, jax_rule, param_sharding_rules
from xlstm_yolo_torch.parallel.moe import MoEFeedForward
from xlstm_yolo_torch.utils.jax_weights import jax_named, load_jax_variables


def _jax_moe(top_k=R.MOE["top_k"]):
    from xlstm_yolo_tpu.parallel.moe import MoEFeedForward as JaxMoE

    m = JaxMoE(dim=R.MOE["dim"], num_experts=R.MOE["num_experts"], top_k=top_k)
    x, _ = R.moe_inputs()
    variables = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    return m, variables


def _compiled(f, *args):
    """``f`` jitted and compiled for ``args`` at XLA's lowest backend
    optimization level (the shard_map compiles are most of this file's
    JAX time)."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _task_model(cfg):
    from xlstm_yolo_torch.nn.tasks import TaskModel

    return TaskModel(dict(cfg), device="cpu")


def _flat_params(variables) -> dict:
    from xlstm_yolo_torch.utils.jax_weights import flatten_variables

    return flatten_variables({"params": jax.device_get(variables["params"])})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks' results of every case (``torch_parallel_ranks.CASES``)."""
    from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset

    tmp = str(tmp_path_factory.mktemp("world"))
    _, variables = _jax_moe()
    np.savez(os.path.join(tmp, "moe.npz"), **_flat_params(variables))
    make_synthetic_dataset(os.path.join(tmp, "ds"), n_train=8, n_val=2, imgsz=64)
    mp.spawn(R.worker, args=(R.WORLD, tmp, list(R.CASES)), nprocs=R.WORLD)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(R.WORLD)]


# -- sequence parallelism --------------------------------------------------------------------

def _jax_sp_reference():
    from xlstm_yolo_tpu.kernels.mlstm_native import mlstm_chunkwise as jax_chunkwise
    from xlstm_yolo_tpu.kernels.mlstm_sp import mlstm_chunkwise_sp as jax_sp
    from xlstm_yolo_tpu.parallel import mesh as JM

    arrs, w = R.sp_inputs()
    mesh = JM.build_mesh(dp=1, tp=1, sp=R.WORLD, devices=jax.devices()[:R.WORLD])
    unsplit = jax_chunkwise(*map(jnp.asarray, arrs), chunk_size=R.SP["chunk"])

    def loss(*a):
        out = jax_sp(*a, mesh=mesh, axis="sp", chunk_size=R.SP["chunk"])
        return jnp.sum(out * w), out

    args = tuple(map(jnp.asarray, arrs))
    (_, out), grads = _compiled(jax.value_and_grad(loss, argnums=tuple(range(5)),
                                                   has_aux=True), *args)(*args)
    return np.asarray(out), np.asarray(unsplit), [np.asarray(g) for g in grads]


def test_sequence_parallel_mlstm_matches_jax_at_sp4(world):
    """``mlstm_chunkwise_sp`` over an sp group of 4 ranks: the segments'
    outputs and the five inputs' gradients against JAX's at sp 4, and the
    outputs against the unsplit chunkwise mLSTM, rtol = atol = 3e-4 (the
    JAX test's)."""
    want, unsplit, grads = _jax_sp_reference()
    ranks = sorted((r["sp"] for r in world), key=lambda r: r["index"])
    got = np.concatenate([r["out"] for r in ranks], 2)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, unsplit, rtol=3e-4, atol=3e-4)
    for j, g in enumerate(grads):
        mine = np.concatenate([r["grads"][j] for r in ranks], 2)
        np.testing.assert_allclose(mine, g, rtol=3e-4, atol=3e-4 * np.abs(g).max())


@pytest.mark.parametrize("segments", [2, 8])
def test_sp_segment_functions_match_the_unsplit_run(segments):
    """The three plain functions over ``segments`` segments in one process
    (no collective) give the unsplit ``mlstm_chunkwise``; the collective
    form outside a world is the unsplit run on its one segment."""
    arrs, _ = R.sp_inputs()
    ts = [torch.from_numpy(a) for a in arrs]
    want = mlstm_chunkwise(*ts, chunk_size=R.SP["chunk"]).numpy()
    n = R.SP["S"] // segments
    parts = [[t[:, :, j * n:(j + 1) * n] for t in ts] for j in range(segments)]
    states = exclusive_prefix([segment_summary(*p, chunk_size=R.SP["chunk"]) for p in parts])
    got = torch.cat([seeded_pass(*p, s, chunk_size=R.SP["chunk"])
                     for p, s in zip(parts, states)], 2).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    one = mlstm_chunkwise_sp(*ts, build_mesh(), chunk_size=R.SP["chunk"]).numpy()
    np.testing.assert_allclose(one, want, rtol=1e-6, atol=1e-6)


# -- pipeline parallelism --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_pipeline(pp: int):
    from jax.sharding import Mesh

    from xlstm_yolo_tpu.parallel.pipeline import (pipeline_apply, stack_stage_params,
                                                  stage_sharding)

    stages, x, w = R.pipe_inputs()
    stages = [{k: jnp.asarray(v) for k, v in s.items()} for s in stages[:pp]]
    mesh = Mesh(np.asarray(jax.devices()[:pp]), axis_names=("pp",))
    stacked = stack_stage_params(stages)
    stacked = jax.device_put(stacked, stage_sharding(mesh, stacked))
    fn = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])

    def loss(p, h):
        out = pipeline_apply(mesh, fn, p, h, num_microbatches=pp)
        return jnp.sum(out * w), out

    args = (stacked, jnp.asarray(x))
    (_, out), (gp, gx) = _compiled(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
                                   *args)(*args)
    return np.asarray(out), np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()}


def _sequential(pp: int):
    stages, x, w = R.pipe_inputs()
    ps = [{k: torch.from_numpy(v).requires_grad_() for k, v in s.items()} for s in stages[:pp]]
    xt = torch.from_numpy(x).requires_grad_()
    h = xt
    for p in ps:
        h = R.pipe_stage(p, h)
    (h * torch.from_numpy(w)).sum().backward()
    return h.detach().numpy(), xt.grad.numpy(), [{k: v.grad.numpy() for k, v in p.items()}
                                                 for p in ps]


@pytest.mark.parametrize("case,pp", [("pp4", 4), ("pp2", 2), ("pp2_nested", 2)])
def test_pipeline_matches_jax_and_sequential(world, case, pp):
    """GPipe over pp ranks (pp 4: 4 microbatches; pp 2 inside a (dp 2, pp
    2) mesh: 2, and 4 through ``pipeline_apply_nested``): every pp rank's
    output, the input's gradient and each stage's parameter gradients
    against JAX's ``pipeline_apply`` under ``jax.grad`` and against the
    stages applied in sequence, 2e-5."""
    jout, jgx, jgp = _jax_pipeline(pp)
    sout, sgx, sgp = _sequential(pp)
    for r in world:
        res = r["pipeline"][case]
        i = res["index"]
        for ref_out, ref_gx in ((jout, jgx), (sout, sgx)):
            np.testing.assert_allclose(res["out"], ref_out, rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(res["dx"], ref_gx, rtol=2e-5, atol=2e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(res["dparams"][k], jgp[k][i], rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(res["dparams"][k], sgp[i][k], rtol=2e-5, atol=2e-5)


def test_pipeline_microbatch_checks_raise(world):
    """The JAX checks, before any collective: B % M and M >= pp."""
    for r in world:
        assert r["pipeline"]["raised"] == ["batch 8 % microbatches 3 != 0",
                                           "need >= 4 microbatches to fill a 4-stage pipeline"]


# -- mixture of experts ----------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_matches_jax_on_loaded_weights(top_k):
    """``MoEFeedForward`` on the JAX module's init: the output, the Switch
    aux loss and the gradients of sum(y w) + 0.01 aux against ``jax.grad``,
    1e-5; top 1 and top 2 routing differ."""
    m, variables = _jax_moe(top_k)
    x, w = R.moe_inputs()

    def loss(params, xx):
        y, state = m.apply({"params": params}, xx, mutable=["losses"])
        aux = state["losses"]["moe_aux"][0]
        return jnp.sum(y * w) + 0.01 * aux, (y, aux)

    args = (variables["params"], jnp.asarray(x))
    (_, (y, aux)), (gp, gx) = _compiled(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
                                        *args)(*args)
    port = load_jax_variables(MoEFeedForward(R.MOE["dim"], R.MOE["num_experts"], top_k),
                              _flat_params(variables))
    xt = torch.from_numpy(x).requires_grad_()
    yt = port(xt)
    ((yt * torch.from_numpy(w)).sum() + 0.01 * port.aux).backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(port.aux.detach()), float(aux), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.router.weight.grad.numpy(),
                               np.asarray(gp["router"]["kernel"]).T, rtol=1e-5, atol=1e-5)
    for k in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(getattr(port, k).grad.numpy(), np.asarray(gp[k]),
                                   rtol=1e-5, atol=1e-5)


def test_moe_expert_parallel_matches_ep1(world):
    """ep 2 in a (dp 2, ep 2) mesh: each rank holds 2 of the 4 experts (the
    rules of ``expert_sharding``, as JAX's); the output, aux loss, the
    input's and the router's gradients equal the unsharded module's, each
    rank's expert gradients its slice of them."""
    from xlstm_yolo_torch.parallel.mesh import Mesh
    from xlstm_yolo_torch.parallel.moe import expert_sharding

    rules = expert_sharding(Mesh({"dp": 2, "tp": 1, "sp": 1, "pp": 1, "ep": 2}),
                            MoEFeedForward(R.MOE["dim"], R.MOE["num_experts"]))
    assert rules == {"router.weight": None, "w_gate": ("ep", 0), "w_up": ("ep", 0),
                     "w_down": ("ep", 0)}
    for r in world:
        res = r["moe"]
        one, two, i = res["ep1"], res["ep2"], res["index"]
        assert res["shards"] == ["w_down", "w_gate", "w_up"]
        np.testing.assert_allclose(two["y"], one["y"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(two["aux"], one["aux"], rtol=1e-6)
        np.testing.assert_allclose(two["dx"], one["dx"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(two["grads"]["router.weight"], one["grads"]["router.weight"],
                                   rtol=1e-5, atol=1e-6)
        for k in ("w_gate", "w_up", "w_down"):
            assert two["grads"][k].shape[0] == 2
            np.testing.assert_allclose(two["grads"][k], one["grads"][k][2 * i:2 * i + 2],
                                       rtol=1e-5, atol=1e-6)


# -- data parallelism and tensor parallelism -------------------------------------------------

def test_dp_step_matches_one_process(world):
    """One step of the thinned ViL graph at dp 2 (sp 2 repeats it), batch 2
    a rank, against one process on the global batch of 4: the summed loss
    at rtol 1e-4 (the JAX test's), every gradient within 1e-4 of its
    tensor's largest (the BatchNorm statistics and the loss normalizers are
    the global batch's), the running means 1e-6."""
    for r in world:
        d = r["dp"]
        np.testing.assert_allclose(d["dp_loss"], d["one_loss"], rtol=1e-4)
        assert d["dp_grads"].keys() == d["one_grads"].keys()
        for k, ref in d["one_grads"].items():
            np.testing.assert_allclose(d["dp_grads"][k], ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max(), err_msg=k)
        for a, b in zip(d["running_mean"], d["one_running_mean"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_dp_tp_multistep_matches_one_process(world):
    """Three SGD steps at dp 2 x tp 2 against one process, rtol 2e-3 (the
    JAX test's): the tp rules store proj_up by columns, proj_down by rows,
    the headwise q/k/v by heads, so each rank holds fewer parameters."""
    for r in world:
        d = r["dp"]
        np.testing.assert_allclose(d["tp_losses"], d["one_losses"], rtol=2e-3)
        assert d["one_losses"][-1] < d["one_losses"][0]
        shards = d["tp_shards"]
        assert shards["l2.pair0.fwd.layer.proj_up.weight"] == ["tp", 0]
        assert shards["l2.pair0.fwd.layer.proj_down.weight"] == ["tp", 1]
        assert shards["l2.pair0.fwd.layer.q_proj.weight"] == ["tp", 0]
        local, full = d["tp_numel"]
        assert local < full


def test_tp_rules_follow_jax():
    """The rules on the port's ViL pair: the JAX rule's axis of each JAX
    tree leaf, mapped to the port tensor's dim (a dense kernel is
    transposed)."""
    from xlstm_yolo_torch.parallel.mesh import Mesh

    mesh = Mesh({"dp": 2, "tp": 2, "sp": 2, "pp": 1, "ep": 1})
    model = _task_model(R.TP_CFG)
    rules = param_sharding_rules(mesh, model)
    assert rules["l2.pair0.fwd.layer.proj_up.weight"] == ("tp", 0)  # JAX kernel axis 1
    assert rules["l2.pair0.fwd.layer.proj_up.bias"] == ("tp", 0)
    assert rules["l2.pair0.fwd.layer.proj_down.weight"] == ("tp", 1)  # JAX kernel axis 0
    assert rules["l2.pair0.fwd.layer.proj_down.bias"] is None
    assert rules["l2.pair0.fwd.layer.k_proj.weight"] == ("tp", 0)
    assert rules["l0.conv.weight"] is None
    assert jax_rule(mesh, ["l9", "conv", "kernel"], (3, 3, 64, 256)) == ("tp", 3)
    assert jax_rule(mesh, ["l2", "pairs", "fwd", "layer", "proj_up", "kernel"],
                    (2, 64, 256)) == ("tp", 2)  # pp 1: the tp rules see a 3-D leaf


# -- the pipelined ViL graph -----------------------------------------------------------------

def test_pipelined_vil_graph_matches_sequential(world):
    """``enable_pipeline`` over (dp 2, pp 2) on the JAX pp/ep test's graph:
    both ViL rows stacked, each rank holding its stage; eval predictions
    equal the stacked layout run in sequence (exactly), the train step's
    summed loss rtol 1e-4 and every gradient (a stage's: its slice) within
    1e-4 of its tensor's largest."""
    for r in world:
        p = r["pipelined_vil"]
        assert p["n"] == 2 and any(".pairs." in s for s in p["shards"])
        b = p["p_mine"].shape[0]
        np.testing.assert_allclose(p["p_mine"], p["p_ref"][p["dp"] * b:(p["dp"] + 1) * b],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(p["loss"], p["one_loss"], rtol=1e-4)
        for k, g in p["grads"].items():
            ref = p["one_grads"][k]
            if ".pairs." in k:
                n = g.shape[0]
                ref = ref[p["pp"] * n:(p["pp"] + 1) * n]
            np.testing.assert_allclose(g, ref, rtol=0, atol=1e-4 * np.abs(ref).max(), err_msg=k)


# -- the trainer's mesh keys -----------------------------------------------------------------

@pytest.mark.parametrize("axis", ["pp", "ep"])
def test_trainer_mesh_keys(world, axis):
    """``Trainer`` with mesh_dp 2 and mesh_pp 2 (3 epochs, validated after
    each by the first rank on the whole, unstacked EMA model) or mesh_ep 2
    (3 epochs, the MoEFFN graph): the mesh, the stacked pairs or sharded
    experts, finite falling losses, ``train/moe_aux`` in the CSV of the ep
    run, the same validation metrics on every rank, a whole checkpoint
    that loads in one process, and a whole final model on every rank."""
    runs = [r["trainer"][axis] for r in world]
    for run in runs:
        assert run["mesh"][axis] == 2 and run["mesh"]["dp"] == 2
    rows = runs[0]["rows"]
    losses = [float(row["train/loss"]) for row in rows]
    assert len(losses) == 3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    if axis == "pp":
        assert all(run["pairs"] for run in runs)
        assert all(any(".pairs." in s for s in run["shards"]) for run in runs)
        assert "metrics/mAP50-95" in rows[0] and "fitness" in runs[0]["metrics"]
        assert all(run["metrics"] == runs[0]["metrics"] for run in runs)
    else:
        assert "train/moe_aux" in rows[0] and float(rows[0]["train/moe_aux"]) > 0
        assert all(run["shards"] == ["l2.moe.w_down", "l2.moe.w_gate", "l2.moe.w_up"]
                   for run in runs)
    assert len({run["final_params"] for run in runs}) == 1
    assert runs[0]["reloaded"] == runs[0]["final_params"]


def test_trainer_shrinks_dp_to_divide_the_batch(world):
    """``mesh_dp: -1`` over four ranks with a batch of 6: dp shrinks to 3
    (the JAX trainer's rule), ranks 0-2 train on batches of 2, rank 3 sits
    outside the mesh and returns no metrics."""
    runs = [r["trainer"]["shrunk"] for r in world]
    assert all(run["mesh"]["dp"] == 3 for run in runs)
    assert [run["member"] for run in runs] == [True, True, True, False]
    assert [run["loader_batch"] for run in runs] == [2, 2, 2, None]
    assert runs[3]["metrics"] == {} and np.isfinite(runs[0]["metrics"]["train_loss"])


# -- single-process pieces -------------------------------------------------------------------

def test_distributed_helpers_single_process():
    """Outside a torchrun world ``ensure_initialized`` is an idempotent
    no-op and the helpers report rank 0 of 1 (the JAX test's); the mesh is
    this one process, with no groups."""
    from xlstm_yolo_torch.parallel import distributed as D

    assert D.ensure_initialized("cpu") == (0, 1) == D.ensure_initialized("cpu")
    assert D.local_shard() == (0, 1) and D.is_main_process()
    mesh = build_mesh()
    assert mesh.shape == {"dp": 1, "tp": 1, "sp": 1, "pp": 1, "ep": 1}
    assert mesh.group is None and mesh.group_of("dp") is None and mesh.member
    with pytest.raises(AssertionError, match="mesh 2x1x1x1x1 != 1 devices"):
        build_mesh(dp=2)


def test_loader_shards_cover_the_set_once():
    """``Loader(shard_index, num_shards)`` as the JAX test's: two shards of
    16 indices, batch 4, no shuffle, cover the set once; with drop_last
    every shard takes len // num_shards."""
    from xlstm_yolo_torch.data.dataset import Loader

    class DS:
        rect = False

        def __len__(self):
            return 16

        def get_sample(self, i, rng, shape=None):
            return i

        def collate(self, samples, idxs=None):
            return list(samples)

    seen = []
    for si in range(2):
        ld = Loader(DS(), batch_size=4, shuffle=False, num_shards=2, shard_index=si,
                    drop_last=False)
        assert len(ld) == 2
        for b in ld:
            seen.extend(b)
    assert sorted(seen) == list(range(16))
    lens = [len(Loader(DS(), 3, shuffle=True, num_shards=3, shard_index=i)) for i in range(3)]
    assert lens == [1, 1, 1]
    with pytest.raises(ValueError, match="shard 2 of 2"):
        Loader(DS(), 4, num_shards=2, shard_index=2)


def _jax_tree(cfg, pp: int = 1):
    from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
    from xlstm_yolo_tpu.parallel import mesh as JM

    m = JaxTaskModel(dict(cfg))
    if pp > 1:
        m.enable_pipeline(JM.build_mesh(dp=2, tp=2, sp=1, pp=pp, ep=1))
    shapes = jax.eval_shape(lambda: m.init(0, imgsz=64))
    from xlstm_yolo_torch.utils.jax_weights import flatten_variables

    shapes = {k: shapes[k] for k in ("params", "batch_stats")}  # not the sown "losses"
    flat = flatten_variables(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    rng = np.random.default_rng(0)
    return {k: rng.normal(size=v.shape).astype(np.float32) for k, v in flat.items()}


@pytest.mark.parametrize("cfg", ["stacked", "moe"])
def test_jax_weights_load_stacked_and_moe_trees(cfg):
    """The JAX tree of the pipelined ``_VIL_PP_CFG`` (``l2/pairs/...``, each
    leaf with leading axis 2) and of the MoEFFN graph (``l2/moe/router``,
    ``w_gate`` ...) load into the port with no missing or extra key, and
    ``jax_named`` gives them back."""
    model = _task_model(R.VIL_PP_CFG if cfg == "stacked" else R.MOE_CFG)
    if cfg == "stacked":
        assert model.enable_pipeline(stages=2) == 2
    flat = _jax_tree(R.VIL_PP_CFG if cfg == "stacked" else R.MOE_CFG,
                     pp=2 if cfg == "stacked" else 1)
    assert any("/pairs/" in k for k in flat) == (cfg == "stacked")
    load_jax_variables(model, flat)
    back = jax_named(model)
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)

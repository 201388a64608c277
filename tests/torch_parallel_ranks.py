"""The rank side of ``tests/test_torch_parallel.py``: the cases each rank of
a spawned gloo world runs, in one order (every mesh is built collectively).
Imports torch and the port only, so that a spawned rank starts without JAX.
Inputs come from seeded numpy generators, the same in every rank and in
the parent test, which holds the gathered results against the JAX package.
"""
from __future__ import annotations

import copy
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4

# the mLSTM of the JAX test_sequence_parallel_mlstm, over 4 segments
SP = dict(B=2, NH=4, S=4 * 32, DH=16, chunk=16)
PIPE_D, PIPE_B = 16, 8
MOE = dict(dim=16, num_experts=4, top_k=2)

# the thinned 2-stage ViL graph of the JAX tp/sp multistep test
TP_CFG = {
    "nc": 3,
    "backbone": [
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 1, "ViLBlockPairBlock", [64, 64, {"qkv_block_size": 32, "chunk_size": 64}]],
        [-1, 1, "Conv", [128, 3, 2]],
        [-1, 1, "ViLBlockPairBlock", [128, 128, {"qkv_block_size": 32, "chunk_size": 64}]],
    ],
    "head": [[[2, 4], 1, "Detect", ["nc"]]],
}
# tests/test_pp_ep.py:_VIL_PP_CFG
VIL_PP_CFG = {
    "nc": 3,
    "backbone": [
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 2, "ViLBlockPairBlock", [64, 64, {"qkv_block_size": 16, "chunk_size": 16}]],
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 2, "ViLBlockPairBlock", [64, 64, {"qkv_block_size": 16, "chunk_size": 16}]],
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 1, "SPPF", [64, 5]],
    ],
    "head": [[[2, 4, 6], 1, "Detect", ["nc"]]],
}
# tests/test_pp_ep.py:test_model_train_mesh_ep's graph
MOE_CFG = {
    "nc": 3,
    "backbone": [
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 1, "MoEFFN", [4, 2]],
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 1, "SPPF", [64, 5]],
    ],
    "head": [[[2, 4, 5], 1, "Detect", ["nc"]]],
}
TRAIN_KEYS = {"epochs": 4, "imgsz": 64, "batch": 8, "val": False, "max_labels": 8,
              "optimizer": "SGD", "lr0": 0.01, "warmup_epochs": 0.0, "nbs": 8, "mosaic": 0.0,
              "scale": 0.0, "translate": 0.0, "fliplr": 0.0, "hsv_h": 0.0, "hsv_s": 0.0,
              "hsv_v": 0.0, "workers": 0, "plots": False, "seed": 0, "device": "cpu",
              "dtype": "float32"}


def sp_inputs():
    rng = np.random.default_rng(0)
    B, NH, S, DH = SP["B"], SP["NH"], SP["S"], SP["DH"]
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v = mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S, DH)
    i, f = mk(B, NH, S), mk(B, NH, S) + 2.0
    w = mk(B, NH, S, DH)  # the loss's weights: sum(h * w)
    return (q, k, v, i, f), w


def pipe_inputs():
    rng = np.random.default_rng(0)
    stages = [{"w": (rng.normal(size=(PIPE_D, PIPE_D)) * 0.2).astype(np.float32),
               "b": (rng.normal(size=(PIPE_D,)) * 0.1).astype(np.float32)} for _ in range(4)]
    x = rng.normal(size=(PIPE_B, PIPE_D)).astype(np.float32)
    w = rng.normal(size=(PIPE_B, PIPE_D)).astype(np.float32)
    return stages, x, w


def pipe_stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def moe_inputs():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, MOE["dim"])).astype(np.float32)
    w = rng.normal(size=(2, 8, MOE["dim"])).astype(np.float32)
    return x, w


def det_batch(n: int, imgsz: int = 64, seed: int = 0) -> dict:
    """The JAX dp test's batch: random images, four copies of one box."""
    rng = np.random.default_rng(seed)
    return {"img": rng.random((n, imgsz, imgsz, 3)).astype(np.float32),
            "cls_boxes": np.tile(np.asarray([[1.0, 8, 8, 40, 40]], np.float32), (n, 4, 1)),
            "mask": np.ones((n, 4), bool)}


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _grads(model) -> dict:
    return {n: p.grad.detach().clone().numpy() for n, p in model.named_parameters()
            if p.grad is not None}


# -- cases ----------------------------------------------------------------------------------

def case_sp(tmp):
    from xlstm_yolo_torch.kernels.mlstm_sp import mlstm_chunkwise_sp
    from xlstm_yolo_torch.parallel.mesh import build_mesh

    mesh = build_mesh(dp=1, sp=WORLD)
    arrs, w = sp_inputs()
    r, n = mesh.index("sp"), SP["S"] // WORLD
    seg = slice(r * n, (r + 1) * n)
    ts = [torch.from_numpy(np.ascontiguousarray(a[:, :, seg])).requires_grad_() for a in arrs]
    out = mlstm_chunkwise_sp(*ts, mesh, axis="sp", chunk_size=SP["chunk"])
    (out * torch.from_numpy(np.ascontiguousarray(w[:, :, seg]))).sum().backward()
    return {"index": r, "out": out.detach().numpy(), "grads": [t.grad.numpy() for t in ts]}


def _pipe_run(mesh, stages, x, w, M, nested=False):
    from xlstm_yolo_torch.parallel.pipeline import (pipeline_apply, pipeline_apply_nested,
                                                    stack_stage_params, stage_slice)

    stacked = stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()}
                                  for s in stages])
    local = {k: v.clone().requires_grad_() for k, v in stage_slice(mesh, stacked).items()}
    xt = torch.from_numpy(x).requires_grad_()
    fn = pipeline_apply_nested if nested else pipeline_apply
    out = fn(mesh, pipe_stage, local, xt, num_microbatches=M)
    (out * torch.from_numpy(w)).sum().backward()
    return {"index": mesh.index("pp"), "out": out.detach().numpy(), "dx": xt.grad.numpy(),
            "dparams": {k: v.grad.numpy() for k, v in local.items()}}


def case_pipeline(tmp):
    from xlstm_yolo_torch.parallel.mesh import build_mesh
    from xlstm_yolo_torch.parallel.pipeline import pipeline_apply

    stages, x, w = pipe_inputs()
    mesh4 = build_mesh(dp=1, pp=4)
    res = {"pp4": _pipe_run(mesh4, stages, x, w, 4)}
    raised = []
    for M in (3, 2):  # 8 % 3 != 0; 2 microbatches cannot fill 4 stages
        try:
            pipeline_apply(mesh4, pipe_stage, {"w": torch.eye(PIPE_D), "b": torch.zeros(PIPE_D)},
                           torch.from_numpy(x), num_microbatches=M)
        except AssertionError as e:
            raised.append(str(e))
    res["raised"] = raised
    mesh2 = build_mesh(dp=2, pp=2)
    res["pp2"] = _pipe_run(mesh2, stages[:2], x, w, 2)
    res["pp2_nested"] = _pipe_run(mesh2, stages[:2], x, w, 4, nested=True)
    return res


def case_moe(tmp):
    from xlstm_yolo_torch.parallel.mesh import build_mesh, shard_params
    from xlstm_yolo_torch.parallel.moe import MoEFeedForward
    from xlstm_yolo_torch.utils.jax_weights import load_jax_variables

    flat = dict(np.load(os.path.join(tmp, "moe.npz")))
    full = load_jax_variables(MoEFeedForward(**MOE), flat)
    mesh = build_mesh(dp=2, ep=2)
    part = copy.deepcopy(full)
    shards = shard_params(mesh, part)
    x, w = moe_inputs()
    out = {"index": mesh.index("ep"), "shards": sorted(shards)}
    for tag, m in (("ep1", full), ("ep2", part)):
        xt = torch.from_numpy(x).requires_grad_()
        y = m(xt)
        ((y * torch.from_numpy(w)).sum() + 0.01 * m.aux).backward()
        out[tag] = {"y": y.detach().numpy(), "aux": float(m.aux.detach()), "dx": xt.grad.numpy(),
                    "grads": _grads(m)}
    return out


def case_dp(tmp):
    from xlstm_yolo_torch.engine.trainer import TrainStep
    from xlstm_yolo_torch.nn.tasks import TaskModel
    from xlstm_yolo_torch.parallel.mesh import build_mesh, shard_batch, shard_params

    model = TaskModel(TP_CFG, nc=3, device="cpu")
    batch = det_batch(4)
    kw = dict(optimizer="SGD", lr=0.01, momentum=0.9, amp=False)

    # one step's loss and gradients: dp 2 (sp 2 repeats the work) vs one process
    mesh = build_mesh(dp=2, sp=2)
    ref = TrainStep(copy.deepcopy(model), **kw)
    total, _ = ref.forward_loss(_t(batch))
    ref.backward(total)
    mine_model = copy.deepcopy(model)
    shard_params(mesh, mine_model)
    mine = TrainStep(mine_model, mesh=mesh, **kw)
    part, _ = mine.forward_loss(_t(shard_batch(mesh, batch)))
    mine.backward(part)
    loss = part.detach().clone()
    dist.all_reduce(loss, group=mesh.group_of("dp"))
    res = {"dp_loss": float(loss), "one_loss": float(total.detach()),
           "dp_grads": _grads(mine.model), "one_grads": _grads(ref.model),
           "running_mean": [b.numpy().copy() for n, b in mine.model.named_buffers()
                            if n.endswith("running_mean")],
           "one_running_mean": [b.numpy().copy() for n, b in ref.model.named_buffers()
                                if n.endswith("running_mean")]}

    # three SGD steps at dp 2 x tp 2 vs one process
    mesh = build_mesh(dp=2, tp=2)
    ref = TrainStep(copy.deepcopy(model), **kw)
    res["one_losses"] = [float(ref(_t(batch))[0]) for _ in range(3)]
    mine_model = copy.deepcopy(model)
    shards = shard_params(mesh, mine_model)
    mine = TrainStep(mine_model, mesh=mesh, **kw)
    res["tp_losses"] = [float(mine(_t(shard_batch(mesh, batch)))[0]) for _ in range(3)]
    res["tp_shards"] = {n: list(s) for n, s in shards.items()}
    res["tp_numel"] = (sum(p.numel() for p in mine_model.parameters()),
                       sum(p.numel() for p in model.parameters()))
    return res


def case_pipelined_vil(tmp):
    from xlstm_yolo_torch.engine.trainer import TrainStep
    from xlstm_yolo_torch.nn.tasks import TaskModel
    from xlstm_yolo_torch.parallel.mesh import build_mesh, shard_batch, shard_params

    mesh = build_mesh(dp=2, pp=2)
    model = TaskModel(VIL_PP_CFG, device="cpu")
    ref = copy.deepcopy(model)
    ref.enable_pipeline(stages=2)  # the stacked layout in sequence, no mesh
    mine = copy.deepcopy(model)
    n = mine.enable_pipeline(mesh)
    shards = shard_params(mesh, mine)
    batch = det_batch(4, seed=1)
    local = shard_batch(mesh, batch)
    with torch.no_grad():
        p_ref = ref.eval().predictions(torch.from_numpy(batch["img"])).numpy()
        p_mine = mine.eval().predictions(torch.from_numpy(local["img"])).numpy()
    kw = dict(optimizer="SGD", lr=0.01, momentum=0.9, amp=False)
    st_ref, st = TrainStep(ref, **kw), TrainStep(mine, mesh=mesh, **kw)
    total, _ = st_ref.forward_loss(_t(batch))
    st_ref.backward(total)
    part, _ = st.forward_loss(_t(local))
    st.backward(part)
    loss = part.detach().clone()
    dist.all_reduce(loss, group=mesh.group_of("dp"))
    return {"n": n, "dp": mesh.index("dp"), "pp": mesh.index("pp"), "shards": sorted(shards),
            "p_ref": p_ref, "p_mine": p_mine, "loss": float(loss),
            "one_loss": float(total.detach()), "grads": _grads(mine),
            "one_grads": _grads(ref)}


def _train(tmp, name, cfg, **keys):
    import csv

    from xlstm_yolo_torch.engine.trainer import Trainer
    from xlstm_yolo_torch.nn.tasks import TaskModel

    tr = Trainer(TaskModel(dict(cfg), device="cpu"), overrides={
        **TRAIN_KEYS, "data": os.path.join(tmp, "ds", "data.yaml"), "project": tmp,
        "name": name, **keys})
    tr.train()
    out = {"mesh": dict(tr.mesh.shape), "shards": sorted(getattr(tr.step.model, "_shards", {})),
           "pairs": any(".pairs." in n for n, _ in tr.step.model.named_parameters())}
    if dist.get_rank() == 0:
        with open(tr.csv) as f:
            out["rows"] = list(csv.DictReader(f))
        from xlstm_yolo_torch.utils.checkpoint import load_checkpoint

        out["reloaded"] = load_checkpoint(tr.save_dir / "last.pt", device="cpu")[0].num_params()
    out["final_params"] = tr.model.num_params()
    out["metrics"] = tr.metrics
    return out


def _train_shrunk(tmp):
    """``mesh_dp`` -1 over 4 ranks with a batch of 6: dp shrinks to 3 and
    the fourth rank sits idle."""
    from xlstm_yolo_torch.engine.trainer import Trainer
    from xlstm_yolo_torch.nn.tasks import TaskModel

    tr = Trainer(TaskModel(dict(VIL_PP_CFG), device="cpu"), overrides={
        **TRAIN_KEYS, "data": os.path.join(tmp, "ds", "data.yaml"), "project": tmp,
        "name": "shrunk", "batch": 6, "epochs": 1, "save": False})
    metrics = tr.train()
    return {"mesh": dict(tr.mesh.shape), "member": tr.mesh.member, "metrics": metrics,
            "loader_batch": None if tr.step is None else tr.loader.bs}


def case_trainer(tmp):
    return {"pp": _train(tmp, "pp", VIL_PP_CFG, mesh_dp=2, mesh_pp=2, val=True, epochs=3),
            "ep": _train(tmp, "ep", MOE_CFG, mesh_dp=2, mesh_ep=2, epochs=3),
            "shrunk": _train_shrunk(tmp)}


CASES = {"sp": case_sp, "pipeline": case_pipeline, "moe": case_moe, "dp": case_dp,
         "pipelined_vil": case_pipelined_vil, "trainer": case_trainer}


def worker(rank: int, world: int, tmp: str, names: list) -> None:
    """One rank: join the gloo world through a FileStore in ``tmp``, run
    the named cases, write {case: result or traceback} to rank{rank}.pt."""
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    out = {}
    try:
        for name in names:
            out[name] = CASES[name](tmp)
    except Exception:  # noqa: BLE001 - the parent reads the traceback
        out["error"] = traceback.format_exc()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        raise
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()

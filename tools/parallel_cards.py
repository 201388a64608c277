"""The parallel stack across the four cards of one host under NCCL.

    torchrun --nproc_per_node 4 tools/parallel_cards.py

Every rank runs each case on a mesh of the four ranks and, beside it, the
same function in one process on the global batch (on its own card), on the
same weights; the one process's discrete choices (TAL, max-pool argmax:
``chip_smoke.SharedChoices``) are replayed in each rank's rows. The cases
(the CPU's small versions of them run in ``tests/test_torch_parallel.py``):

* ``dp_tp``: dp 2 x tp 2, three fp32 SGD steps of ViL-YOLO-n at 640 px,
  global batch 4: the losses at rtol 2e-3 (the JAX multistep test's), the
  first at 1e-4;
* ``dp_pp``: dp 2 x pp 2, ViL-YOLO-l's pairs pipelined over pp, one step:
  the loss at 1e-4, every gradient within 1e-3 of its tensor's max (a
  stage's against its slice of the stacked model's);
* ``dp_ep``: dp 2 x ep 2, the MoEFFN graph, one step, as ``dp_pp``;
* ``sp``: sp 4, ``mlstm_chunkwise_sp`` at ViL-YOLO-n's P3 (B 2, NH 2, S
  6400, DH 64; chunk 64, since a quarter of 6400 is not a whole number of
  the YAML's 128-long chunks) and its gradients against the unsplit run
  (rtol = atol = 3e-4, scaled by each gradient's max).

Rank 0 prints one JSON line a case (the worst over the ranks), the card's
name and power limit, and last {"ok": ...}; the exit code is 1 when a case
fails. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import copy
import faulthandler
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from xlstm_yolo_torch.engine.trainer import TrainStep  # noqa: E402
from xlstm_yolo_torch.kernels.mlstm_native import mlstm_chunkwise  # noqa: E402
from xlstm_yolo_torch.kernels.mlstm_sp import mlstm_chunkwise_sp  # noqa: E402
from xlstm_yolo_torch.parallel.distributed import ensure_initialized  # noqa: E402
from xlstm_yolo_torch.parallel.mesh import build_mesh, shard_batch, shard_params  # noqa: E402
from xlstm_yolo_torch.utils import resolve_device  # noqa: E402

MODELS = {"tp": "vil_yolon.yaml", "pp": "vil_yolol.yaml", "ep": cs.MOE_GRAPH}
SP_SHAPE = (2, 2, 6400, 64, 64)  # B, NH, S, DH, chunk
GLOBAL_BATCH = 4
STEP = dict(optimizer="SGD", lr=0.01, momentum=0.9, amp=False)


def replay_rows(rec, mesh, b: int):
    lo = mesh.index("dp") * b
    return cs.SharedChoices(replay=cs.sliced_choices(
        {"assigned": rec.assigned, "pooled": rec.pooled}, lo, lo + b))


def grad_worst(model, ref: dict, mesh) -> tuple:
    """The worst gradient of ``model`` (sharded by ``shard_params``)
    against the one process's ``ref``, each of its own max (a vanishing
    one of the largest)."""
    shards = getattr(model, "_shards", {})
    gmax = max(g.abs().max().item() for g in ref.values())
    worst, name = 0.0, None
    for n, p in model.named_parameters():
        want = ref[n]
        if n in shards:
            axis, dim = shards[n]
            k = p.shape[dim]
            want = want.narrow(dim, mesh.index(axis) * k, k)
        scale = want.abs().max().item()
        scale = scale if scale >= 1e-6 * gmax else gmax
        err = (p.grad - want).abs().max().item() / scale
        if err > worst:
            worst, name = err, n
    return worst, name


def case_dp_tp(dev) -> dict:
    mesh = build_mesh(dp=2, tp=2)
    model = cs.build_main_model(dev, train=True, cfg=MODELS["tp"])
    one = TrainStep(copy.deepcopy(model), **STEP)
    mine_model = copy.deepcopy(model)
    shards = shard_params(mesh, mine_model)
    mine = TrainStep(mine_model, mesh=mesh, **STEP)
    batch = cs.train_batch(dev, GLOBAL_BATCH)
    local = shard_batch(mesh, batch)
    ref, got = [], []
    for _ in range(3):
        rec = cs.SharedChoices()
        with rec.active():
            ref.append(float(one(batch)[0]))
        with replay_rows(rec, mesh, GLOBAL_BATCH // 2).active():
            got.append(float(mine(local)[0]))
    rel = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    local_n = sum(p.numel() for p in mine_model.parameters())
    return {"losses": got, "one_process": ref, "relerr": rel, "tp_sharded": len(shards),
            "params_local_over_full": local_n / sum(p.numel() for p in model.parameters()),
            "ok": rel[0] <= 1e-4 and max(rel) <= 2e-3 and len(shards) > 0}


def one_step(st, batch, choices):
    with choices.active():
        total, _ = st.forward_loss(batch)
        st.backward(total)
    return total.detach()


def case_dp_split(dev, axis: str) -> dict:
    """One step at dp 2 x (pp or ep) 2 against one process."""
    mesh = build_mesh(dp=2, **{axis: 2})
    model = cs.build_main_model(dev, train=True, cfg=MODELS[axis])
    ref_model, mine_model = copy.deepcopy(model), copy.deepcopy(model)
    if axis == "pp":
        ref_model.enable_pipeline(stages=2)
        mine_model.enable_pipeline(mesh)
    shards = shard_params(mesh, mine_model)
    batch = cs.train_batch(dev, GLOBAL_BATCH)
    rec = cs.SharedChoices()
    total = one_step(TrainStep(ref_model, **STEP), batch, rec)
    part = one_step(TrainStep(mine_model, mesh=mesh, **STEP), shard_batch(mesh, batch),
                    replay_rows(rec, mesh, GLOBAL_BATCH // 2))
    loss = part.clone()
    dist.all_reduce(loss, group=mesh.group_of("dp"))
    ref = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in ref_model.named_parameters()}
    worst, name = grad_worst(mine_model, ref, mesh)
    rel = abs(float(loss) - float(total)) / abs(float(total))
    return {"loss": float(loss), "one_process": float(total), "relerr": rel,
            "grad_maxrelerr": worst, "grad_worst": name, f"{axis}_sharded": len(shards),
            "ok": rel <= 1e-4 and worst <= 1e-3 and len(shards) > 0}


def case_sp(dev) -> dict:
    mesh = build_mesh(dp=1, sp=4)
    B, NH, S, DH, CS = SP_SHAPE
    g = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g)
    full = [mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S, DH), mk(B, NH, S), mk(B, NH, S) + 2]
    w = mk(B, NH, S, DH).to(dev)
    ts = [t.to(dev).requires_grad_() for t in full]
    want = mlstm_chunkwise(*ts, chunk_size=CS)
    (want * w).sum().backward()
    n, r = S // 4, mesh.index("sp")
    seg = slice(r * n, (r + 1) * n)
    loc = [t.detach()[:, :, seg].contiguous().requires_grad_() for t in ts]
    got = mlstm_chunkwise_sp(*loc, mesh, chunk_size=CS)
    (got * w[:, :, seg]).sum().backward()
    pairs = [(got.detach(), want.detach()[:, :, seg])] + [(a.grad, t.grad[:, :, seg])
                                                          for a, t in zip(loc, ts)]
    # rtol = atol = 3e-4, the atol of a gradient scaled by its max (the CPU test's)
    within = all(bool(((x - y).abs() <= 3e-4 * (y.abs() + max(1.0 if i == 0 else 0.0,
                                                              y.abs().max().item()))).all())
                 for i, (x, y) in enumerate(pairs))
    return {"out_max_abs_err": (pairs[0][0] - pairs[0][1]).abs().max().item(),
            "grad_max_abs_err": max((x - y).abs().max().item() for x, y in pairs[1:]),
            "ok": within}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stall", type=float, default=300.0,
                    help="seconds after which each rank prints its stack and exits")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = ensure_initialized(dev)
    if world != 4:
        raise SystemExit(f"needs a world of 4 ranks (torchrun --nproc_per_node 4), got {world}")
    faulthandler.dump_traceback_later(args.stall, exit=True)  # a stalled rank shows where
    ok = True
    for name, fn in (("dp_tp", lambda: case_dp_tp(dev)),
                     ("dp_pp", lambda: case_dp_split(dev, "pp")),
                     ("dp_ep", lambda: case_dp_split(dev, "ep")),
                     ("sp", lambda: case_sp(dev))):
        print(f"rank {rank}: {name}", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        res = {**fn(), "seconds": time.perf_counter() - t0}
        every = [None] * world
        dist.all_gather_object(every, res)
        ok = ok and all(r["ok"] for r in every)
        if rank == 0:
            print(json.dumps({"case": name, "backend": dist.get_backend(), "device": str(dev),
                              "ranks": every}), flush=True)
    if rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
        print(json.dumps({"ok": ok}), flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

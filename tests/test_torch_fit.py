"""Port parity: ``Trainer.train``, the epoch loop, against the JAX trainer on
the CPU.

* vil_yolon with the dataset's 3 classes at 64 px, fp32 (``dtype:
  float32``), 2 epochs of 2 batches of 4 (the JAX synthetic set's 8 train
  images), augmentation off (mosaic, HSV, flip, translate and scale at 0;
  the loader still shuffles by the seed), ``nbs`` 4 so that every step
  updates (``optimizer: auto`` is AdamW here), the same initial weights
  (``load_jax_variables``): the CSV's columns are the JAX trainer's, its
  per-epoch losses within 1e-4 (relative) of the JAX trainer's and its
  validation metrics (of the EMA parameters, after each epoch) within
  1e-3; the learning rates within 1e-9; ``best.pt`` and ``last.pt`` are
  written, and ``last.pt`` holds the final EMA weights.
* ``resume``: a 3-epoch run stopped before its third epoch and resumed from
  ``last.pt`` ends as the uninterrupted run does: the third epoch's row
  (losses, metrics, learning rate) and the final weights equal.
* The rebuild to the dataset's class count (vil_yolon's 80 -> 3) carries
  over as many tensors, of as many, as the JAX trainer's ``n_hit``.
"""
import csv
from pathlib import Path

import pytest
import torch

import jax

from xlstm_yolo_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from xlstm_yolo_tpu.engine.trainer import Trainer as JaxTrainer
from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_torch.engine.trainer import Trainer
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils.checkpoint import load_checkpoint
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables

IMGSZ = 64
NO_AUGMENT = {"mosaic": 0.0, "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "fliplr": 0.0,
              "translate": 0.0, "scale": 0.0}


def _overrides(data, save_dir: Path, epochs: int) -> dict:
    return {"data": data, "epochs": epochs, "imgsz": IMGSZ, "batch": 4, "nbs": 4,
            "dtype": "float32", "workers": 0, "plots": False, "project": str(save_dir.parent),
            "name": save_dir.name, **NO_AUGMENT}


def _rows(path: Path) -> list:
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return jax_synthetic(tmp_path_factory.mktemp("fitds"), n_train=8, n_val=4, imgsz=IMGSZ)


def _port_model(variables):
    return load_jax_variables(TaskModel("vil_yolon.yaml", nc=3, device="cpu"),
                              flatten_variables(variables))


def _fresh():
    return TaskModel("vil_yolon.yaml", nc=3, device="cpu", seed=0)


def test_trainer_epochs_match_jax(data, tmp_path):
    jm = JaxTaskModel("vil_yolon.yaml", nc=3, verbose=False)
    v = jax.jit(lambda: jm.init(0, imgsz=IMGSZ))()
    tt = Trainer(_port_model(v), overrides={**_overrides(data, tmp_path / "port", 2),
                                            "device": "cpu"})
    jt = JaxTrainer(jm, overrides=_overrides(data, tmp_path / "jax", 2))
    jt.variables = v  # the JAX step donates these buffers: the port's copy is made above
    jt.train()
    tt.train()
    want, got = _rows(tmp_path / "jax" / "results.csv"), _rows(tmp_path / "port" / "results.csv")
    assert len(got) == len(want) == 2 and list(got[0]) == list(want[0])
    for g, w in zip(got, want):
        for k in w:
            if k.startswith("train/"):
                assert abs(float(g[k]) - float(w[k])) <= 1e-4 * abs(float(w[k])), (k, g[k], w[k])
            elif k.startswith("metrics/") and not k.endswith("img_s"):
                assert abs(float(g[k]) - float(w[k])) <= 1e-3, (k, g[k], w[k])
        assert abs(float(g["lr"]) - float(w["lr"])) <= 1e-9 and g["epoch"] == w["epoch"]
    assert (tmp_path / "port" / "best.pt").exists()
    last, meta = load_checkpoint(tmp_path / "port" / "last.pt", use_ema=True, device="cpu")
    assert meta["epoch"] == 1 and last.names == {0: "rect", 1: "circle", 2: "triangle"}
    for a, b in zip(last.state_dict().values(), tt.model.state_dict().values()):
        assert torch.equal(a, b)


def test_resume_continues_as_the_uninterrupted_run(data, tmp_path):
    full = Trainer(_fresh(), overrides={**_overrides(data, tmp_path / "full", 3), "device": "cpu"})
    full.train()

    class Stop(Exception):
        pass

    def stop_at_third(trainer):
        if trainer.epoch == 2:
            raise Stop

    cut = Trainer(_fresh(), overrides={**_overrides(data, tmp_path / "cut", 3), "device": "cpu"})
    cut.add_callback("on_train_epoch_start", stop_at_third)
    with pytest.raises(Stop):
        cut.train()
    resumed = Trainer(_fresh(), overrides={**_overrides(data, tmp_path / "cut", 3),
                                           "device": "cpu", "resume": True})
    resumed.train()
    want, got = _rows(tmp_path / "full" / "results.csv"), _rows(tmp_path / "cut" / "results.csv")
    assert len(got) == len(want) == 3
    for k in want[2]:
        if k != "img_s" and not k.endswith("img_s"):
            assert float(got[2][k]) == pytest.approx(float(want[2][k]), rel=1e-6, abs=1e-9), k
    for a, b in zip(resumed.model.state_dict().values(), full.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_rebuild_to_dataset_classes_transfers_as_jax(data, tmp_path):
    # the shapes of both JAX variable trees (no init is run), and the JAX
    # trainer's count over them (engine/trainer.py, Trainer.train)
    old = jax.eval_shape(lambda: JaxTaskModel("vil_yolon.yaml", verbose=False).init(
        0, imgsz=IMGSZ))
    new = jax.eval_shape(lambda: JaxTaskModel("vil_yolon.yaml", nc=3, verbose=False).init(
        0, imgsz=IMGSZ))
    old_flat = dict(jax.tree_util.tree_flatten_with_path(old)[0])
    new_flat, _ = jax.tree_util.tree_flatten_with_path(new)
    n_hit = sum(1 for p, x in new_flat if p in old_flat and old_flat[p].shape == x.shape)
    tr = Trainer(TaskModel("vil_yolon.yaml", device="cpu"),
                 overrides={**_overrides(data, tmp_path / "r", 1), "device": "cpu"})
    model = tr.rebuild(3)
    assert tr.transferred == (n_hit, len(new_flat))
    assert model.nc == 3 and n_hit < len(new_flat)
    kept = tr.model.state_dict()
    for k, t in model.state_dict().items():
        if k in kept and kept[k].shape == t.shape:
            assert torch.equal(t, kept[k]), k

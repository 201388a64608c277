"""Genetic hyperparameter tuning.

Port of ``Tuner``, ``SPACE`` and ``run_ray_tune`` in
``xlstm_yolo_tpu/engine/tuner.py``: each iteration mutates the best row of
the results CSV (sigma-scaled, bounded; the same draws as JAX for the same
seed and CSV) and trains a fresh model with ``engine.trainer.Trainer``;
fitness is the last validation's. The CSV has the JAX columns: ``iter``,
``fitness``, then the keys of ``SPACE``. ``run_ray_tune`` needs ``ray``
and raises an ImportError without it.
"""
from __future__ import annotations

import csv
import shutil
from pathlib import Path

import numpy as np

# key: (mutation gain, min, max)
SPACE = {
    "lr0": (1.0, 1e-5, 1e-1),
    "lrf": (1.0, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1.0, 0.0, 0.001),
    "warmup_epochs": (1.0, 0.0, 5.0),
    "box": (1.0, 0.02, 0.2 * 100),
    "cls": (1.0, 0.2, 4.0),
    "dfl": (1.0, 0.4, 6.0),
    "hsv_h": (1.0, 0.0, 0.1),
    "hsv_s": (1.0, 0.0, 0.9),
    "hsv_v": (1.0, 0.0, 0.9),
    "translate": (1.0, 0.0, 0.9),
    "scale": (1.0, 0.0, 0.9),
    "fliplr": (1.0, 0.0, 1.0),
    "mosaic": (1.0, 0.0, 1.0),
}


class Tuner:
    def __init__(self, model_fn, base_overrides: dict, save_dir: str = "runs/tune",
                 space: dict | None = None, seed: int = 0):
        """``model_fn``: () -> a fresh ``TaskModel`` (one per iteration);
        ``base_overrides`` the trainer's keys every iteration shares."""
        self.model_fn = model_fn
        self.base = dict(base_overrides)
        self.space = space or SPACE
        self.save_dir = Path(save_dir)
        self.csv = self.save_dir / "tune_results.csv"
        self.rng = np.random.default_rng(seed)

    def _mutate(self, parent: dict | None, mutation: float = 0.8, sigma: float = 0.2) -> dict:
        hyp = {}
        for k, (gain, lo, hi) in self.space.items():
            base = parent.get(k) if parent else None
            if base is None:
                base = self.base.get(k, (lo + hi) / 2)
            v = float(base)
            if parent is not None and self.rng.random() < mutation:
                v *= float(1 + self.rng.normal(0, sigma) * gain)
            hyp[k] = float(np.clip(v, lo, hi))
        return hyp

    def _best_parent(self) -> dict | None:
        if not self.csv.exists():
            return None
        with open(self.csv) as f:
            rows = list(csv.DictReader(f))
        if not rows:
            return None
        best = max(rows, key=lambda r: float(r["fitness"]))
        return {k: float(v) for k, v in best.items() if k in self.space}

    def __call__(self, iterations: int = 10) -> dict:
        from .trainer import Trainer

        self.save_dir.mkdir(parents=True, exist_ok=True)
        best_fit, best_hyp = -1.0, None
        for it in range(iterations):
            hyp = self._mutate(self._best_parent())
            tr = Trainer(self.model_fn(), overrides={
                **self.base, **hyp, "project": str(self.save_dir), "name": f"iter{it}",
                "val": True})
            metrics = tr.train()
            fit = float(metrics.get("fitness", 0.0))
            row = {"iter": it, "fitness": fit, **hyp}
            new = not self.csv.exists()
            with open(self.csv, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(row.keys()))
                if new:
                    w.writeheader()
                w.writerow(row)
            if fit > best_fit:
                best_fit, best_hyp = fit, hyp
                if (tr.save_dir / "best.pt").exists():
                    shutil.copy2(tr.save_dir / "best.pt", self.save_dir / "best.pt")
            print(f"tune iter {it}: fitness {fit:.4f} (best {best_fit:.4f})")
        return {"best_fitness": best_fit, "best_hyp": best_hyp}


def run_ray_tune(model_yaml: str, data: str, space: dict | None = None,
                 max_samples: int = 10, train_args: dict | None = None):
    """Ray Tune search over the trainer's keys; needs ``ray`` (an
    ImportError without it: ``Tuner`` is the search that needs nothing)."""
    try:
        from ray import tune
        from ray.tune.schedulers import ASHAScheduler
    except ImportError as e:
        raise ImportError("ray is not installed; use Tuner (genetic evolution) instead") from e

    space = space or {
        "lr0": tune.uniform(1e-5, 1e-1),
        "lrf": tune.uniform(0.01, 1.0),
        "momentum": tune.uniform(0.6, 0.98),
        "weight_decay": tune.uniform(0.0, 0.001),
        "box": tune.uniform(0.02, 0.2),
        "cls": tune.uniform(0.2, 4.0),
        "hsv_h": tune.uniform(0.0, 0.1),
        "fliplr": tune.uniform(0.0, 1.0),
        "mosaic": tune.uniform(0.0, 1.0),
    }

    def _trainable(config):
        from .model import Model

        res = Model(model_yaml).train(data=data, **{**(train_args or {}), **config})
        tune.report({"fitness": float(res.get("fitness", 0.0))})

    tuner = tune.Tuner(_trainable, param_space=space,
                       tune_config=tune.TuneConfig(
                           scheduler=ASHAScheduler(metric="fitness", mode="max"),
                           num_samples=max_samples))
    return tuner.fit()

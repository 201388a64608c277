"""Port parity: the model server (``utils/remote.py``), ``benchmark`` and the
profilers (``utils/benchmarks.py``), ``autobatch`` and the tuner against
the JAX package on the CPU.

* ``serve_model`` on 127.0.0.1 answers the port's ``RemoteModel`` (also
  through ``AutoBackend``) and the JAX ``RemoteModel`` with the local
  ``AutoBackend``'s output exactly, and reports a malformed request as the
  JAX server does (HTTP 500, still serving);
* ``benchmark`` rows have the JAX rows' keys; the gated formats give error
  rows that name the package; ``profile_layers``' rows are the JAX rows'
  (i, name) for yolov8n, and the ViL layers' GFLOPs are not 0;
* the autobatch fit gives the JAX batch on the same readings (degenerate
  ones 16), halves a batch whose measured peak passes the budget, and
  raises on the CPU;
* ``Tuner._mutate`` draws what the JAX one draws for the same seed and CSV;
  a two-iteration ``Model.tune`` on synthetic PNGs writes the JAX columns.

Torch on one thread.
"""
import csv
import urllib.error
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_export import IMGSZ, images
from xlstm_yolo_tpu.engine import tuner as JTUNE
from xlstm_yolo_tpu.utils import autobatch as JAB
from xlstm_yolo_tpu.utils.remote import RemoteModel as JaxRemoteModel
from xlstm_yolo_torch import YOLO
from xlstm_yolo_torch.data.synthetic import make_synthetic_dataset
from xlstm_yolo_torch.engine import tuner as TUNE
from xlstm_yolo_torch.engine.exporter import FORMATS
from xlstm_yolo_torch.nn.autobackend import AutoBackend
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils import autobatch as AB
from xlstm_yolo_torch.utils.benchmarks import (Profile, benchmark, forward_flops,
                                               loader_throughput, profile_layers, profile_model)
from xlstm_yolo_torch.utils.remote import RemoteModel, serve_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def server():
    s = serve_model("yolov8n.yaml", imgsz=IMGSZ, device="cpu")
    yield s
    s.shutdown()
    s.server_close()


def test_remote_matches_local_for_both_clients(server):
    host, port = server.server_address
    url = f"http://{host}:{port}/infer"
    local = AutoBackend("yolov8n.yaml", imgsz=IMGSZ, device="cpu")
    remote = AutoBackend(url, imgsz=IMGSZ, device="cpu")
    assert remote.kind == "remote"
    assert remote.meta.get("nc") == 80 and remote.meta.get("task") == "detect"
    assert remote.meta["imgsz"] == IMGSZ and remote.meta["names"][0] == "0"
    x = images(2)
    want = local.forward(x)
    np.testing.assert_array_equal(remote.forward(x), want)
    theirs = JaxRemoteModel(f"http://{host}:{port}")
    assert theirs.meta == remote.meta
    np.testing.assert_array_equal(theirs(x), want)


def test_remote_error_reporting_matches_jax(server):
    """A malformed payload: HTTP 500 with a JSON error, and the server goes
    on answering (the JAX ``test_remote_backend_error_reporting``)."""
    host, port = server.server_address
    rm = RemoteModel(f"http://{host}:{port}")
    req = urllib.request.Request(rm.url, data=b"not-an-npz")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 500 and "error" in ei.value.read().decode()
    assert rm(np.zeros((1, IMGSZ, IMGSZ, 3), np.float32)).shape[0] == 1
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"http://{host}:{port}/nothing", timeout=30)
    assert ei.value.code == 404


def test_benchmark_rows_have_jax_keys(tmp_path):
    """Every format is tried: ``pt2`` and ``torch`` reload and match, the
    gated ones give error rows naming their package; the rows' keys are the
    JAX rows' (``format``, ``ok``, ``max_abs_diff``, ``ms_per_image``, and
    ``error`` where the format failed)."""
    from xlstm_yolo_tpu.utils.benchmarks import benchmark as jax_benchmark
    import inspect

    tm = TaskModel("yolov8n.yaml", nc=2, device="cpu")
    rows = benchmark(tm, imgsz=IMGSZ, formats=FORMATS, output_dir=str(tmp_path),
                     verbose=False, device="cpu")
    assert [r["format"] for r in rows] == list(FORMATS)
    jax_keys = {"format", "ok", "max_abs_diff", "ms_per_image"}
    assert "floor" in inspect.signature(jax_benchmark).parameters
    by = {r["format"]: r for r in rows}
    for fmt in ("pt2", "torch"):
        assert set(by[fmt]) == jax_keys and by[fmt]["ok"] and by[fmt]["max_abs_diff"] == 0.0
    for fmt in ("onnx", "savedmodel", "tflite"):
        assert set(by[fmt]) == jax_keys | {"error"} and not by[fmt]["ok"]
        assert "ImportError" in by[fmt]["error"] and "'onnx'" in by[fmt]["error"]


def test_profile_layers_rows_match_jax():
    """(i, name) as the JAX rows (one per parsed layer of the JAX graph), the
    GFLOPs summing to ``FlopCounterMode``'s whole forward; vil_yolon's three
    ViL rows count their op."""
    from xlstm_yolo_tpu.cfg import load_model_yaml as jax_load
    from xlstm_yolo_tpu.nn.graph import parse_model as jax_parse

    for cfg in ("yolov8n.yaml", "vil_yolon.yaml"):
        tm = TaskModel(cfg, nc=3, device="cpu")
        rows = profile_layers(tm, imgsz=IMGSZ, n=1)
        yaml, scale = jax_load(cfg)
        jspecs = jax_parse(dict(yaml, nc=3), ch=3, scale=scale).specs
        assert [(r["i"], r["name"]) for r in rows] == [(s.i, s.name) for s in jspecs]
        assert all(r["gflops"] >= 0 and r["ms"] >= 0 for r in rows)
        total = forward_flops(tm, torch.zeros(1, 3, IMGSZ, IMGSZ))
        assert sum(r["gflops"] for r in rows) * 1e9 == pytest.approx(total, rel=1e-9)
        vil = [r["gflops"] for r in rows if r["name"] == "ViLBlockPairBlock"]
        assert len(vil) == (3 if cfg == "vil_yolon.yaml" else 0) and all(g > 0 for g in vil)


def test_profile_model_timer_and_loader_throughput(tmp_path):
    tm = TaskModel("yolov8n.yaml", nc=3, device="cpu")
    out = profile_model(tm, imgsz=IMGSZ, batch=1, n=3, warmup=1)
    assert out["ms_mean"] > 0 and out["img_s"] > 0
    p = Profile()
    with p:
        torch.zeros(4).sum()
    with p:
        pass
    assert p.t >= p.dt >= 0 and str(p).startswith("Elapsed time")
    rates = loader_throughput([{"img": np.zeros((4, 8, 8, 3))}] * 3, epochs=2)
    assert len(rates["img_s_per_epoch"]) == 2 and rates["best"] > 0


READINGS = [((1, 700e6), (4, 1270e6)), ((1, 2e9), (4, 5e9)), ((2, 3e9), (8, 12e9)),
            ((1, 5e8), (4, 5e8)), ((1, 0), (4, 1e9))]


@pytest.mark.parametrize("readings", READINGS, ids=["vil", "steep", "wide", "flat", "zero"])
def test_autobatch_fit_matches_jax(readings):
    """The JAX ``autobatch`` with its XLA readings replaced by these and
    80 GiB of memory, against the port's ``fit_batch`` on the same."""
    total = 80 * 1024**3
    by_batch = dict(readings)
    with mock.patch.object(JAB, "_peak_bytes", lambda fn, b, imgsz, ch: int(by_batch[b])), \
            mock.patch.object(JAB, "device_memory_bytes", lambda: total):
        want = JAB.autobatch(None, probe=tuple(by_batch), fraction=0.6)
    got = AB.fit_batch([(b, int(y)) for b, y in readings], total, fraction=0.6)
    assert got["batch"] == want


def test_autobatch_halves_past_the_budget_and_needs_the_card():
    """Readings that grow faster above the probes: the fit's batch peaks past
    60%, its halves are measured until one fits. On the CPU autobatch
    raises instead of guessing."""
    total = 80 * 1024**3
    seen = []

    def peak(fn, b, imgsz, ch=3, device="cuda"):
        seen.append(b)
        return int(5e8 + 2e8 * b + (4e6 * b * b if b > 4 else 0))

    with mock.patch.object(AB, "peak_bytes", peak), \
            mock.patch.object(AB, "device_memory_bytes", lambda device="cuda": total):
        fit = AB.autobatch_fit(None, fraction=0.6)
    assert fit["fit_batch"] == 128 and fit["batch"] == 64 and seen == [1, 4, 128, 64]
    assert fit["measured_peak_bytes"] <= 0.6 * total < peak(None, 128, 0)
    with pytest.raises(ValueError, match="CUDA memory"):
        AB.autobatch(lambda x: None, imgsz=IMGSZ, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AB.device_memory_bytes()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_model("yolov8n.yaml", imgsz=IMGSZ)


def _write_rows(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


@pytest.mark.parametrize("seed", [0, 7])
def test_tuner_mutations_match_jax(tmp_path, seed):
    """A fresh run, then parents read from a CSV: the same hyperparameters
    as the JAX tuner, draw for draw."""
    base = {"lr0": 0.01, "mosaic": 0.0}
    theirs = JTUNE.Tuner(lambda: None, base, save_dir=str(tmp_path / "j"), seed=seed)
    ours = TUNE.Tuner(lambda: None, base, save_dir=str(tmp_path / "p"), seed=seed)
    assert ours.space == theirs.space == JTUNE.SPACE
    h0 = theirs._mutate(None)
    assert ours._mutate(None) == h0
    h1 = theirs._mutate(h0)
    assert ours._mutate(h0) == h1
    for t in (theirs, ours):
        t.save_dir.mkdir(parents=True)
        _write_rows(t.csv, [{"iter": 0, "fitness": 0.1, **h0}, {"iter": 1, "fitness": 0.3, **h1}])
    for _ in range(3):
        assert ours._best_parent() == theirs._best_parent()
        assert ours._mutate(ours._best_parent()) == theirs._mutate(theirs._best_parent())


def test_model_tune_writes_the_jax_columns(tmp_path):
    data = make_synthetic_dataset(str(tmp_path / "ds"), n_train=8, n_val=4, imgsz=IMGSZ,
                                  width=80, height=60, seed=0)
    res = YOLO("yolov8n.yaml", device="cpu").tune(
        data=data, iterations=2, epochs=1, batch=4, imgsz=IMGSZ, project=str(tmp_path / "tune"),
        plots=False, dtype="float32", workers=0)
    with open(tmp_path / "tune" / "tune_results.csv") as f:
        rows = list(csv.DictReader(f))
    assert [list(r) for r in rows] == [["iter", "fitness", *JTUNE.SPACE]] * 2
    assert [int(r["iter"]) for r in rows] == [0, 1] and res["best_hyp"] is not None
    assert set(res["best_hyp"]) == set(JTUNE.SPACE)
    with pytest.raises(ImportError, match="ray"):
        TUNE.run_ray_tune("yolov8n.yaml", data)

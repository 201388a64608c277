"""Port parity: the command line (``python -m xlstm_yolo_torch``), the
predictor's result writing, ``utils/files.py``, ``utils/checks.py`` and
``data/annotator.py`` against the JAX package on the CPU.

* ``parse_kv`` against JAX's on a table of argv.
* ``entrypoint(["detect", "predict", ..., "save=True", "save_txt=True",
  "save_conf=True", "save_crop=True", "device=cpu"])`` on a vil_yolon
  detector of 3 classes at 96 px (seeded JAX tree, head shaped as in
  ``test_torch_val``, written as a port checkpoint) over the JAX synthetic
  set's JPEGs, against the JAX ``Predictor`` with the same flags on the same
  weights (compiled at XLA's lowest optimization level): the same file
  tree, the label files line for line (the class as text, the 6-decimal
  figures within one unit of the last place: the two fp32 forwards differ
  in the last bits; ``save_txt`` on equal arrays is text-equal in
  ``test_torch_annotator``), the crops byte for byte; the annotated frames
  are the port's encoder on ``Results.plot()``.
* ``utils.files`` and ``utils.checks`` against JAX's.
* ``auto_annotate`` with a small SAM (img 128, dim 64, depth 3) and a
  detector that proposes fixed boxes: the label files equal JAX's as text
  when both read the same masks (the port's ``SAMPredictor``, itself held
  to JAX's in ``test_torch_sam``).
* A CUDA device turns TF32 off for matmul and cuDNN (``resolve_device``,
  which every model and entry point passes through): the precision the
  card checks hold the port to; a CPU device leaves both flags alone.
* A fresh process runs ``python -m xlstm_yolo_torch detect predict`` with
  the save flags (through ``runpy``), reads and writes JPEGs and traces
  mask contours, and never tries to import ``cv2`` or ``PIL`` (a finder
  records and refuses each attempt).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_detect_zoo import compiled
from test_torch_val import NC, shape_head
from test_torch_yolo11 import one_thread, seeded_variables  # noqa: F401
from xlstm_yolo_tpu.__main__ import parse_kv as jax_parse_kv
from xlstm_yolo_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from xlstm_yolo_tpu.engine.predictor import Predictor as JaxPredictor
from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_torch import YOLO, native
from xlstm_yolo_torch.__main__ import entrypoint, parse_kv
from xlstm_yolo_torch.engine.results import Results
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils.checkpoint import save_checkpoint
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables

IMGSZ = 96
NAMES = {0: "rect", 1: "circle", 2: "triangle"}
CONF, MAX_DET = 0.02, 6
REPO = Path(__file__).resolve().parents[1]

ARGV = [
    ["model=a.pt", "source=img.jpg", "conf=0.5"],
    ["imgsz=640", "half=True", "device=cpu", "name=", "project=runs"],
    ["model=", "b.yaml", "epochs=", "3", "lr0=", "=0.01", "a=", "=", "1"],
    ["save_txt=false", "classes=0", "iou=0.45", "exist_ok=TRUE", "tracker=null"],
    ["data=coco8.yaml", "batch=-1", "scale=1e-3", "x=a=b"],
]


@pytest.mark.parametrize("argv", ARGV, ids=range(len(ARGV)))
def test_parse_kv_matches_jax(argv):
    assert parse_kv(argv) == jax_parse_kv(argv)


def test_parse_kv_refuses_bare_word():
    for f in (parse_kv, jax_parse_kv):
        with pytest.raises(SystemExit):
            f(["model=a.pt", "oops"])


def test_help_and_unknown_key(capsys):
    assert entrypoint(["help"]) == 0
    assert "device=cpu" in capsys.readouterr().out
    with pytest.raises(KeyError, match="did you mean"):
        entrypoint(["detect", "predict", "confx=0.3", "device=cpu"])


def test_cuda_device_pins_fp32(monkeypatch):
    from xlstm_yolo_torch.utils import resolve_device

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device("cuda").type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.fixture(scope="module")
def detector(tmp_path_factory):
    """(JAX TaskModel, its variables, the port checkpoint, the JPEG dir)."""
    root = tmp_path_factory.mktemp("cli")
    jax_synthetic(root, n_train=1, n_val=3, imgsz=IMGSZ)
    jm = JaxTaskModel("vil_yolon.yaml", nc=NC, verbose=False)
    v = shape_head(seeded_variables(lambda: jm.init(0, imgsz=IMGSZ), 1), seed=5)
    tm = load_jax_variables(TaskModel("vil_yolon.yaml", nc=NC, device="cpu"), flatten_variables(v))
    tm.names = jm.names = dict(NAMES)
    return jm, v, save_checkpoint(root / "w.pt", tm), root / "images" / "val"


def _tree(d: Path) -> list:
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def test_cli_predict_writes_the_jax_tree(detector, tmp_path, capsys):
    jm, v, ckpt, val_dir = detector
    assert sorted(p.suffix for p in val_dir.iterdir()) == [".jpg"] * 3
    flags = ["save=True", "save_txt=True", "save_conf=True", "save_crop=True"]
    assert entrypoint(["detect", "predict", f"model={ckpt}", f"source={val_dir}", *flags,
                       f"project={tmp_path}", "name=port", f"imgsz={IMGSZ}",
                       f"conf={CONF}", f"max_det={MAX_DET}", "device=cpu"]) == 0
    assert "(no detections)" not in capsys.readouterr().out
    jp = JaxPredictor(jm, v, imgsz=IMGSZ, conf=CONF, max_det=MAX_DET, verbose=False,
                      save=True, save_txt=True,
                      save_conf=True, save_crop=True, project=str(tmp_path), name="jax")
    cache = {}

    def low_opt(variables, x):
        if "f" not in cache:
            cache["f"] = compiled(jp._device_fn, variables, x)
        return cache["f"](variables, x)

    jp._jit = low_opt
    jp(str(val_dir))
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    assert _tree(ours) == _tree(theirs)
    assert any(p.startswith("crops/") for p in _tree(ours))
    plots = {Path(r.path).name: r.plot()
             for r in YOLO(ckpt, device="cpu").predict(val_dir, imgsz=IMGSZ, conf=CONF,
                                                       max_det=MAX_DET, verbose=False)}
    for rel in _tree(ours):
        a, b = ours / rel, theirs / rel
        if rel.startswith("labels/"):
            # the same lines and classes; the fp32 forwards differ in the
            # last bit, so a 6-decimal figure may differ by one unit
            la, lb = a.read_text().splitlines(), b.read_text().splitlines()
            assert len(la) == len(lb) > 0, rel
            for x, y in zip(la, lb):
                xs, ys = x.split(), y.split()
                assert xs[0] == ys[0] and len(xs) == len(ys) == 6
                np.testing.assert_allclose(np.float64(xs[1:]), np.float64(ys[1:]), rtol=0,
                                           atol=1.5e-6)
        elif rel.startswith("crops/"):
            assert a.read_bytes() == b.read_bytes(), rel
        else:  # the annotated frame: the port's drawing, in cv2's bytes
            assert a.read_bytes() == native.jpeg_encode(plots[rel]), rel


def test_files_match_jax(tmp_path):
    from xlstm_yolo_tpu.utils import files as JF
    from xlstm_yolo_torch.utils import files as TF

    (tmp_path / "a b").mkdir()
    (tmp_path / "a b" / "x.txt").write_text("hello" * 1000)
    for f in ("file_size", "file_age", "file_date"):
        for p in (tmp_path / "a b", tmp_path / "a b" / "x.txt"):
            assert getattr(TF, f)(p) == getattr(JF, f)(p)
    with TF.spaces_in_path(tmp_path / "a b") as p, JF.spaces_in_path(tmp_path / "a b") as q:
        assert " " not in str(p) and Path(p).name == Path(q).name
        (Path(p) / "y.txt").write_text("new")
    assert (tmp_path / "a b" / "y.txt").read_text() == "new"
    cwd = Path.cwd()
    with TF.WorkingDirectory(tmp_path):
        assert Path.cwd() == tmp_path.resolve()
    assert Path.cwd() == cwd
    for exist_ok in (False, True):
        assert TF.increment_path(tmp_path / "a b", exist_ok=exist_ok) == \
            JF.increment_path(tmp_path / "a b", exist_ok=exist_ok)
    assert TF.increment_path(tmp_path / "a b" / "x.txt") == tmp_path / "a b" / "x2.txt"
    (tmp_path / "run" / "w").mkdir(parents=True)
    (tmp_path / "run" / "w" / "last.pt").write_bytes(b"0")
    assert TF.get_latest_run(str(tmp_path)) == str(tmp_path / "run" / "w" / "last.pt")


def test_utils_match_jax(tmp_path, monkeypatch):
    """colorstr, emojis, increment_path and the settings file against JAX's;
    ``SETTINGS`` is read on its first use, from XLSTM_YOLO_CONFIG_DIR."""
    from xlstm_yolo_tpu import utils as JU
    from xlstm_yolo_torch import utils as TU

    for args in (("hello",), ("red", "bold", "x"), ("blue", "underline", "a b")):
        assert TU.colorstr(*args) == JU.colorstr(*args)
    assert TU.emojis("ok \u2705") == JU.emojis("ok \u2705")
    (tmp_path / "exp").mkdir()
    assert TU.increment_path(tmp_path / "exp") == JU.increment_path(tmp_path / "exp")
    monkeypatch.setenv("XLSTM_YOLO_CONFIG_DIR", str(tmp_path / "cfg"))
    monkeypatch.delitem(vars(TU), "SETTINGS", raising=False)
    ts, js = TU.SettingsManager(), JU.SettingsManager()
    assert dict(ts) == dict(js) and ts.file == js.file == tmp_path / "cfg" / "settings.json"
    js.update(runs_dir="elsewhere")
    js.save()
    assert TU.SETTINGS["runs_dir"] == "elsewhere" and TU.SETTINGS is TU.SETTINGS
    TU.SETTINGS.reset()
    assert dict(JU.SettingsManager()) == TU.SettingsManager.DEFAULTS
    vars(TU).pop("SETTINGS")  # read anew by the next user


def test_checks_match_jax(tmp_path):
    from xlstm_yolo_tpu.utils import checks as JC
    from xlstm_yolo_torch.utils import checks as TC

    for cur, req in (("2.0.1+cpu", ">=2.0,<3"), ("1.9", ">=2.0"), ("3.1.4", "==3.1.4"),
                     ("0.0.1", "!=0.0.1"), ("", ">=1")):
        assert TC.check_version(cur, req) == JC.check_version(cur, req)
        assert TC.parse_version(cur or "0") == JC.parse_version(cur or "0")
    for sz in (640, 641, [320, 333], [100]):
        assert TC.check_imgsz(sz) == JC.check_imgsz(sz)
        assert TC.check_imgsz(sz, min_dim=2) == JC.check_imgsz(sz, min_dim=2)
    with pytest.raises(ModuleNotFoundError):
        TC.check_version("1.0", ">=2.0", hard=True)
    assert TC.check_yaml("vil_yolo.yaml").endswith("vil_yolo.yaml")
    with pytest.raises(ValueError):
        TC.check_suffix("a.txt", (".yaml",))
    with pytest.raises(FileNotFoundError):
        TC.check_file("nothing_by_this_name.yaml")
    for p in (tmp_path / "a" / "b", tmp_path / ".." / "x"):
        assert TC.check_is_path_safe(tmp_path, p) == JC.check_is_path_safe(tmp_path, p)
    assert TC.check_bf16(TaskModel("yolov8n.yaml", device="cpu"), imgsz=32, device="cpu")


class _Boxes:
    """A detector that proposes the same boxes whatever the image."""

    def __init__(self, boxes):
        self.boxes = np.asarray(boxes, np.float32)

    def predict(self, img, conf=0.25, verbose=False):
        return [Results(img, boxes=self.boxes)]


def test_auto_annotate_matches_jax(tmp_path):
    from test_torch_sam import S
    from xlstm_yolo_tpu.data.annotator import auto_annotate as jax_auto_annotate
    from xlstm_yolo_torch import models_sam as TS
    from xlstm_yolo_torch.data.annotator import auto_annotate
    from xlstm_yolo_torch.data.imgproc import imwrite

    import jax
    import jax.numpy as jnp
    from xlstm_yolo_tpu import models_sam as JS

    jm = JS.SAM(img_size=S, encoder_dim=64, encoder_depth=3)
    v = seeded_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3))), 0)
    tm = load_jax_variables(TS.SAM(img_size=S, encoder_dim=64, encoder_depth=3, device="cpu"),
                            flatten_variables(v))
    sam = TS.SAMPredictor(tm, img_size=S)
    rng = np.random.default_rng(4)
    (tmp_path / "src").mkdir()
    for i in range(2):
        imwrite(tmp_path / "src" / f"im{i}.jpg", rng.integers(0, 256, (100, 160, 3), np.uint8))
    det = _Boxes([[10, 12, 90, 80, 0.9, 1], [60, 30, 150, 95, 0.8, 2], [0, 0, 40, 40, 0.7, 0]])
    ours = auto_annotate(tmp_path / "src", det, sam, output_dir=tmp_path / "port")
    theirs = jax_auto_annotate(str(tmp_path / "src"), det, sam, output_dir=tmp_path / "jax")
    assert [p.name for p in ours] == [p.name for p in theirs] == ["im0.txt", "im1.txt"]
    assert any(p.read_text() for p in ours)
    for a, b in zip(ours, theirs):
        assert a.read_text() == b.read_text()


FRESH = r"""
import runpy
import sys
attempts = []


class Refuse:
    # a finder that records and refuses every import of cv2 or PIL
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("cv2", "PIL"):
            attempts.append(name)
            raise ImportError(name)


sys.meta_path.insert(0, Refuse())
import numpy as np
from pathlib import Path
from xlstm_yolo_torch.data.imgproc import imread, imwrite
from xlstm_yolo_torch.engine.results import Results
ckpt, src, out = sys.argv[1], Path(sys.argv[2]), Path(sys.argv[3])
sys.argv = ["xlstm_yolo_torch", "detect", "predict", f"model={ckpt}", f"source={src}",
            "save=True", "save_txt=True", "save_crop=True", f"project={out}", "name=m",
            "imgsz=96", "conf=0.02", "max_det=6", "device=cpu"]
try:
    runpy.run_module("xlstm_yolo_torch", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
assert (out / "m" / "labels" / f"{src.stem}.txt").is_file()
assert imread(out / "m" / f"{src.stem}.jpg").shape == imread(src).shape
mask = np.zeros((2, 48, 64), bool); mask[0, 5:20, 8:30] = True; mask[1, 30:40, 40:60] = True
img = np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)
r = Results(imread(imwrite(out / "f.jpg", img)), masks=mask,
            boxes=np.array([[8, 5, 30, 20, 0.9, 0], [40, 30, 60, 40, 0.8, 1]]))
assert len(r.masks.xy) == 2 and len(r.masks.xy[0]) == 4
r.save_txt(out / "seg.txt")
r.save(out / "seg.jpg")
assert not attempts, attempts
assert "cv2" not in sys.modules and "PIL" not in sys.modules
print("OK")
"""


def test_module_entry_in_a_process_without_cv2_or_pil(detector, tmp_path):
    """``python -m xlstm_yolo_torch detect predict`` (through ``runpy``) with
    the save flags on a JPEG, then JPEG I/O and traced masks, in a fresh
    process that never imports cv2 or PIL."""
    _, _, ckpt, val_dir = detector
    src = sorted(val_dir.iterdir())[0]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}  # one torch thread
    out = subprocess.run([sys.executable, "-c", FRESH, str(ckpt), str(src), str(tmp_path)],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stderr[-3000:]

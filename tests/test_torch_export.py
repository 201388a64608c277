"""Port parity: ``engine/exporter.py`` and ``nn/autobackend.py`` against the
JAX package's ``Exporter`` and ``AutoBackend`` on the CPU.

The same weights on both sides (the port's seeded init with seeded noise,
class biases 0, carried to the JAX tree through ``torch_name``'s layouts
run backwards, as ``test_torch_detect_zoo._pair`` does) and the same
seeded images. The port's ``pt2`` (``torch.export``) reloaded through its
``AutoBackend`` against the JAX ``stablehlo`` through the JAX
``AutoBackend`` (compiled at XLA's lowest optimization level): yolov8n
within 1e-4 (the JAX round trip's own tolerance), vil_yolon boxes within
1e-3 px and scores within 1e-4 (``test_torch_detect_keys``'s tolerances
for that model), where the port's registered ViL op runs the plain K3 on
the CPU; with ``nms``, dets (1, 300, 6) and valid. The exported ViL graph
holds one ``xlstm_yolo::vil_layer_fwd`` node a ViL layer, and
``torch.library.opcheck`` passes on the four registered ops. Torch on one
thread.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_detect_zoo import compiled
from xlstm_yolo_tpu.cfg import load_model_yaml as jax_load_model_yaml
from xlstm_yolo_tpu.engine.exporter import Exporter as JaxExporter
from xlstm_yolo_tpu.engine.exporter import load_stablehlo
from xlstm_yolo_tpu.nn.autobackend import AutoBackend as JaxAutoBackend
from xlstm_yolo_tpu.nn.graph import GraphModel as JaxGraphModel
from xlstm_yolo_tpu.nn.graph import parse_model as jax_parse_model
from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_torch.engine.exporter import FORMATS, Exporter, load_pt2
from xlstm_yolo_torch.kernels.vil_cell import OPS, Cfg, cfg_args
from xlstm_yolo_torch.kernels.vil_layer import vil_layer_fwd
from xlstm_yolo_torch.nn.autobackend import AutoBackend
from xlstm_yolo_torch.nn.fuse import cast_params
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils.callbacks import default_callbacks
from xlstm_yolo_torch.utils.jax_weights import torch_name, transposed_convs

NC, IMGSZ = 3, 64
K3 = "vil_layer_fwd"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tree_of(tm, jm):
    """The JAX variable tree of ``jm`` holding ``tm``'s state (structure from
    ``jax.eval_shape`` of the JAX init, values through ``torch_name``)."""
    state, transposed = tm.state_dict(), transposed_convs(tm)

    def leaf(path, sds):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        idx = np.arange(int(np.prod(sds.shape))).reshape(sds.shape)
        port, where = torch_name(key, idx, transposed)
        out = np.empty(idx.size, np.float32)
        out[where.reshape(-1)] = state[port].numpy().reshape(-1)
        return jnp.asarray(out.reshape(sds.shape))

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(lambda: jm.init(0, imgsz=IMGSZ)))


def pair(cfg: str, nc=NC, seed=0):
    """(JAX model, JAX variables, port model) on the same seeded weights."""
    tm = TaskModel(cfg, nc=nc, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for key, t in tm.state_dict().items():
            if key.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            elif t.is_floating_point():
                t.add_(torch.from_numpy(0.05 * rng.normal(size=tuple(t.shape)).astype(np.float32)))
        for name, m in getattr(tm, f"l{tm.parsed.head_index}").named_children():
            if "cv3_" in name and name.endswith("_2"):
                m.bias.zero_()
    yaml, scale = jax_load_model_yaml(cfg)
    jm = JaxTaskModel.__new__(JaxTaskModel)
    jm.cfg_name, jm.yaml, jm.scale, jm.ch, jm.reg_max = cfg, dict(yaml), scale, 3, 16
    jm.yaml["nc"] = nc
    jm.parsed = jax_parse_model(jm.yaml, ch=3, scale=scale)
    jm.module = JaxGraphModel(jm.parsed)
    jm.nc, jm.task, jm.txt_feats, jm.e2e = jm.parsed.nc, jm.parsed.task, None, False
    jm.strides, jm.names = tm.strides, dict(tm.names)
    return jm, jax_tree_of(tm, jm), tm


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(cfg):
        if cfg not in cache:
            cache[cfg] = pair(cfg)
        return cache[cfg]

    return get


def images(b, seed=0):
    return np.random.default_rng(seed).random((b, IMGSZ, IMGSZ, 3)).astype(np.float32)


def jax_stablehlo(jm, v, tmp, x, **kw):
    """The JAX ``stablehlo`` export of ``jm`` through the JAX ``AutoBackend``,
    compiled at the lowest optimization level, on ``x`` -> (output, meta)."""
    path = JaxExporter(jm, v, format="stablehlo", imgsz=IMGSZ, batch=len(x),
                       output_dir=str(tmp / "jax"), **kw)()
    backend = JaxAutoBackend(path, imgsz=IMGSZ)
    backend._fn = compiled(backend._fn, jnp.asarray(x))
    return backend, backend.meta


@pytest.mark.parametrize("cfg,batch", [("yolov8n.yaml", 2), ("vil_yolon.yaml", 2)],
                         ids=["yolov8n", "vil_yolon"])
def test_pt2_round_trip_matches_jax_stablehlo(pairs, tmp_path, cfg, batch):
    jm, v, tm = pairs(cfg)
    x = images(batch)
    path = Exporter(tm, imgsz=IMGSZ, batch=batch, device="cpu", output_dir=str(tmp_path))()
    backend = AutoBackend(path, imgsz=IMGSZ, device="cpu")
    assert backend.kind == "pt2"
    got = backend.forward(x)
    jb, jmeta = jax_stablehlo(jm, v, tmp_path, x)
    want = jb.forward(x)
    for k, val in jmeta.items():
        assert backend.meta[k] == (val if k != "format" else "pt2"), k
    if cfg == "yolov8n.yaml":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=0, atol=1e-4)


def test_pt2_with_nms_matches_jax(pairs, tmp_path):
    jm, v, tm = pairs("yolov8n.yaml")
    x = images(1, seed=3)
    path = Exporter(tm, imgsz=IMGSZ, batch=1, nms=True, device="cpu",
                    output_dir=str(tmp_path))()
    fn, meta = load_pt2(path)
    with torch.no_grad():
        dets, valid = fn(torch.from_numpy(x))
    jpath = JaxExporter(jm, v, format="stablehlo", imgsz=IMGSZ, batch=1, nms=True,
                        output_dir=str(tmp_path / "jax"))()
    call, jmeta = load_stablehlo(jpath)
    want_dets, want_valid = compiled(call, jnp.asarray(x))(jnp.asarray(x))
    assert meta["nms"] is True and jmeta["nms"] is True
    assert dets.shape == (1, 300, 6) and want_dets.shape == (1, 300, 6)
    assert 0 < int(valid.sum()) < 300
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(dets.numpy(), np.asarray(want_dets), rtol=0, atol=1e-3)


def k3_nodes(path) -> int:
    program = torch.export.load(str(path))
    target = getattr(torch.ops.xlstm_yolo, K3).default
    return sum(1 for n in program.graph.nodes if n.target is target)


def test_exported_vil_graph_holds_the_registered_op(pairs, tmp_path):
    """Three ViL layers, three ``xlstm_yolo::vil_layer_fwd`` nodes; the
    program's call runs the op's CPU implementation (the plain K3, no
    launch)."""
    _, _, tm = pairs("vil_yolon.yaml")
    path = Exporter(tm, imgsz=IMGSZ, batch=1, device="cpu", output_dir=str(tmp_path))()
    assert k3_nodes(path) == 3
    before = vil_layer_fwd.launches
    fn, _ = load_pt2(path)
    with torch.no_grad():
        got = fn(torch.from_numpy(images(1)))
        want = tm.predictions(torch.from_numpy(images(1)))
    assert vil_layer_fwd.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_half_export_is_bf16_serving(pairs, tmp_path):
    """``half``: the parameters cast as ``cast_params`` casts them, the images
    in bf16, the ViL layers in the bf16 arithmetic (the op on bf16
    activations); the program equals the bf16-cast model's predictions."""
    import copy

    _, _, tm = pairs("vil_yolon.yaml")
    path = Exporter(tm, imgsz=IMGSZ, batch=1, half=True, device="cpu",
                    output_dir=str(tmp_path))()
    meta = json.loads(Path(path).with_suffix(".json").read_text())
    assert k3_nodes(path) == 3 and meta["half"] is True
    fn, _ = load_pt2(path)
    x = torch.from_numpy(images(1))
    model16 = cast_params(copy.deepcopy(tm), torch.bfloat16)
    with torch.no_grad():
        got = fn(x)
        want = model16.predictions(x.bfloat16()).float()
    assert got.dtype == torch.float32 and next(tm.parameters()).dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def layer_case(kind: str, dtype=torch.float32, outnorm: bool = True):
    """Seeded arguments of one registered ViL op and its ``cfg``."""
    B, S, DIM, INNER, NH = 2, 12, 16, 32, 2
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g) * 0.3
    dh = INNER // NH
    cell = [r(B, S, INNER), r(B, S, INNER), r(NH, dh, dh), r(INNER), r(NH, dh, dh), r(INNER),
            r(NH, dh, dh), r(INNER), r(3 * INNER, NH), r(NH), r(3 * INNER, NH), r(NH)]
    tail = [1 + r(INNER) if outnorm else None, r(INNER) if outnorm else None, 1 + r(INNER),
            r(INNER, DIM), r(DIM)]
    cfg = Cfg(NH, 4, outnorm=outnorm)
    args = {"vil_cell_fwd": cell,
            "vil_block_fwd": [cell[0], cell[1], r(B, S, INNER), r(B, S, DIM), *cell[2:], *tail],
            "vil_layer_fwd": [r(B, S, DIM), cell[0], 1 + r(DIM), r(DIM, 2 * INNER),
                              r(2 * INNER), *cell[2:], *tail],
            "vil_layer_conv_fwd": [r(B, S, DIM), 1 + r(DIM), r(DIM, 2 * INNER), r(2 * INNER),
                                   r(INNER, 1, 3, 3), r(INNER), *cell[2:], *tail]}[kind]
    if kind == "vil_layer_conv_fwd":
        cfg = cfg._replace(seqlens=(3, 4))
    if dtype != torch.float32:
        args[:2] = [a.to(dtype) for a in args[:2]]
    return args, cfg


@pytest.mark.parametrize("kind,dtype,outnorm", [
    ("vil_layer_fwd", torch.float32, True), ("vil_layer_fwd", torch.bfloat16, True),
    ("vil_layer_fwd", torch.float32, False), ("vil_cell_fwd", torch.float32, True),
    ("vil_block_fwd", torch.float32, True), ("vil_layer_conv_fwd", torch.float32, True),
], ids=["layer", "layer_bf16", "layer_no_outnorm", "cell", "block", "conv"])
def test_registered_ops_pass_opcheck(kind, dtype, outnorm):
    """Schema, fake tensor, autograd registration and AOT dispatch of each
    registered member on CPU tensors (its plain forward), and the op equals
    the member's wrapper."""
    args, cfg = layer_case(kind, dtype, outnorm)
    torch.library.opcheck(OPS[kind], (*args, *cfg_args(cfg)))
    from xlstm_yolo_torch.kernels import vil_block, vil_cell, vil_conv, vil_layer

    member = {"vil_cell_fwd": vil_cell._CELL, "vil_block_fwd": vil_block._BLOCK,
              "vil_layer_fwd": vil_layer._LAYER, "vil_layer_conv_fwd": vil_conv._CONV}[kind]
    torch.testing.assert_close(OPS[kind](*args, *cfg_args(cfg)),
                               member.plain(args, cfg)[0], rtol=0, atol=0)


def test_flop_counter_counts_the_vil_op():
    """``FlopCounterMode`` counts the layer op by its formula: twice the
    products' multiply-adds a token (``vil_macs``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from xlstm_yolo_torch.kernels.mlstm_bwd import KERNEL_CS
    from xlstm_yolo_torch.kernels.vil_cell import vil_macs

    args, cfg = layer_case("vil_layer_fwd")
    with FlopCounterMode(display=False) as fc:
        OPS[K3](*args, *cfg_args(cfg))
    B, S, DIM, INNER, NH, dh = 2, 12, 16, 32, 2, 16
    macs = (3 * INNER * dh + 6 * INNER * NH + NH * ((KERNEL_CS + 1) * dh + 2 * dh * dh)
            + 3 * INNER * DIM)
    assert fc.get_total_flops() == 2 * B * S * macs == 2 * B * S * vil_macs(
        DIM, INNER, NH, True, True, False)


@pytest.mark.parametrize("fmt", ["onnx", "savedmodel", "tflite"])
def test_gated_formats_raise_naming_the_package(pairs, tmp_path, fmt):
    _, _, tm = pairs("yolov8n.yaml")
    with pytest.raises(ImportError, match="'onnx'"):
        Exporter(tm, format=fmt, imgsz=IMGSZ, device="cpu", output_dir=str(tmp_path))()


def test_exporter_callbacks_formats_and_card_default(pairs, tmp_path):
    """``on_export_start`` / ``on_export_end`` run around the export; an
    unknown format raises; the default device is the card, which raises
    here; the model given is left as it was (fp32, on the CPU)."""
    _, _, tm = pairs("yolov8n.yaml")
    assert FORMATS[0] == "pt2"
    seen = []
    cb = default_callbacks()
    cb.add("on_export_start", lambda e: seen.append(("start", e.format)))
    cb.add("on_export_end", lambda e: seen.append(("end", e.format)))
    Exporter(tm, imgsz=IMGSZ, half=True, device="cpu", output_dir=str(tmp_path),
             callbacks=cb)()
    assert seen == [("start", "pt2"), ("end", "pt2")]
    assert next(tm.parameters()).dtype == torch.float32
    with pytest.raises(ValueError, match="unknown export format"):
        Exporter(tm, format="stablehlo", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Exporter(tm)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AutoBackend("yolov8n.yaml")

"""Detection inference: batched on the device, and per source image with
``Results``.

Port of ``Predictor`` and ``load_source`` (files, directories and arrays) in
``xlstm_yolo_tpu/engine/predictor.py``. Two entries, told apart by what
``__call__`` is given:

* a batch of frames (a uint8 (B, H, W, 3) tensor or 4-D ndarray) takes the
  device path at the boundary the JAX ``bench.py`` times: uint8 NHWC frames
  -> ``letterbox_device`` -> forward -> DFL decode -> fixed-shape NMS
  (pre_topk 512, bfloat16 score selection) -> (dets, valid, cands, meta).
  The stages are also callable one by one, for timing;
* any other source (an image file, a directory of images, an RGB (H, W, 3)
  ndarray or PIL image, or a list of these) is read one image at a time,
  letterboxed on the host (``data.augment.letterbox``), run through the
  same forward, decode and NMS (``agnostic_nms``: across classes), its
  detections kept to ``classes`` when given (after NMS, as JAX does), and
  its boxes mapped back to the image with the letterbox's gain and padding
  (``ops.boxes.scale_boxes``) -> ``list[Results]``, or with ``stream`` a
  generator of them, as the JAX ``Predictor`` does.

fp32 by default, as the JAX ``Predictor`` (the reference's ``half: False``).
``dtype="bfloat16"`` (or ``half=True``) serves in bf16 as the JAX bench
does: the model's parameters cast to bf16 in place (``nn.fuse.cast_params``;
BatchNorm statistics stay fp32), the letterbox computed in bf16, the forward
in bf16 (the ViL layers through their bf16 kernel on the card); decode and
NMS stay fp32.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..data.augment import letterbox
from ..data.imgproc import IMG_FORMATS
from ..data.loaders import LoadImagesAndVideos, LoadPilAndNumpy
from ..nn.fuse import cast_params
from ..ops.boxes import scale_boxes
from ..ops.letterbox import letterbox_device
from ..ops.nms import non_max_suppression
from ..utils.callbacks import default_callbacks
from .results import Results


def load_source(source):
    """A source -> an iterable of (path, RGB uint8 (H, W, 3)), one image
    decoded at a time: an ndarray or PIL image (or a list of them), an image
    file, a directory of images (sorted), or a list of files."""
    if isinstance(source, np.ndarray) or hasattr(source, "convert"):
        return LoadPilAndNumpy(source)
    if isinstance(source, (list, tuple)):
        if all(isinstance(s, np.ndarray) or hasattr(s, "convert") for s in source):
            return LoadPilAndNumpy(list(source))
        return (item for s in source for item in load_source(s))
    p = Path(str(source))
    if p.is_dir():
        return LoadImagesAndVideos(sorted(f for f in p.iterdir()
                                          if f.suffix.lower() in IMG_FORMATS))
    if p.is_file() and p.suffix.lower() in IMG_FORMATS:
        return LoadImagesAndVideos([p])
    if p.is_file():
        raise ValueError(f"source {source}: the port predicts on images ({sorted(IMG_FORMATS)}); "
                         f"video, stream and screen sources are not ported")
    raise FileNotFoundError(f"source not found: {source}")


class Predictor:
    def __init__(self, model, imgsz: int = 640, conf: float = 0.25, iou: float = 0.7,
                 max_det: int = 300, classes=None, agnostic_nms: bool = False,
                 verbose: bool = True, pre_topk: int = 512, dtype: str = "float32",
                 half: bool = False, callbacks=None, **unported):
        if unported:
            raise ValueError(f"Predictor does not take {sorted(unported)}: writing results "
                             f"(save, save_txt, save_crop) and video or stream options are not "
                             f"ported")
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', got {dtype!r}")
        self.classes = None if classes is None else [int(c) for c in np.atleast_1d(classes)]
        self.agnostic, self.verbose = bool(agnostic_nms), verbose
        self.half = half or dtype == "bfloat16"
        self.dtype = torch.bfloat16 if self.half else torch.float32
        self.model = cast_params(model, torch.bfloat16) if self.half else model
        self.imgsz = imgsz
        self.conf, self.iou, self.max_det, self.pre_topk = conf, iou, max_det, pre_topk
        self.callbacks = callbacks if callbacks is not None else default_callbacks()
        self.device = next(model.parameters()).device

    def preprocess(self, frames) -> tuple[torch.Tensor, tuple]:
        """uint8 (B, H, W, 3) frames (numpy or tensor) -> letterboxed
        (B, imgsz, imgsz, 3) batch in the predictor's dtype on the model's
        device, and its meta."""
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(frames)
        if frames.dtype != torch.uint8 or frames.ndim != 4:
            raise ValueError(f"expected uint8 (B, H, W, 3) frames, got {frames.dtype} "
                             f"{tuple(frames.shape)}")
        return letterbox_device(frames.to(self.device), imgsz=self.imgsz, dtype=self.dtype)

    def postprocess(self, cands: torch.Tensor):
        """(B, N, 4 + nc) candidates -> (dets (B, max_det, 6), valid)."""
        return non_max_suppression(cands, conf_thres=self.conf, iou_thres=self.iou,
                                   max_det=self.max_det, pre_topk=self.pre_topk,
                                   fast_sel=True, class_agnostic=self.agnostic)

    def __call__(self, source, stream: bool = False):
        """A batch of frames -> (dets, valid, cands, meta), dets boxes xyxy
        in the letterboxed frame; any other source -> ``list[Results]``, or
        with ``stream`` a generator that reads, predicts and yields one
        image at a time (module docstring)."""
        if isinstance(source, torch.Tensor) or (isinstance(source, np.ndarray)
                                                and source.ndim == 4):
            with torch.inference_mode():
                x, meta = self.preprocess(source)
                cands = self.model.predictions(x)
                dets, valid = self.postprocess(cands)
            return dets, valid, cands, meta
        gen = self._results(source)
        return gen if stream else list(gen)

    def _results(self, source):
        self.callbacks.run("on_predict_start", self)
        names = getattr(self.model, "names", {}) or {}
        for path, orig in load_source(source):
            self.callbacks.run("on_predict_batch_start", self)
            t0 = time.perf_counter()
            img, _, (r, px, py) = letterbox(orig, self.imgsz)
            with torch.inference_mode():
                x = torch.from_numpy(img).to(self.device)[None].float() / 255.0
                t1 = time.perf_counter()
                dets, valid = self.postprocess(self.model.predictions(x.to(self.dtype)).float())
                d = dets[0][valid[0]]
                if self.classes is not None:
                    d = d[torch.isin(d[:, 5].long(), torch.tensor(self.classes, device=d.device))]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t2 = time.perf_counter()
            d = torch.cat([scale_boxes(d[:, :4], (self.imgsz, self.imgsz), orig.shape[:2],
                                       ratio_pad=(r, (px, py))), d[:, 4:]], 1)
            res = Results(orig, path=path, names=names, boxes=d.cpu().numpy(),
                          speed={"preprocess": (t1 - t0) * 1e3, "inference": (t2 - t1) * 1e3,
                                 "postprocess": (time.perf_counter() - t2) * 1e3})
            self.results = [res]
            self.callbacks.run("on_predict_postprocess_end", self)
            if self.verbose:
                print(f"{path}: {res.verbose()} ({res.speed['inference']:.1f}ms inference)")
            self.callbacks.run("on_predict_batch_end", self)
            yield res
        self.callbacks.run("on_predict_end", self)

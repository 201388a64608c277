"""Inference of the detect, segment, pose, OBB and classify tasks: batched
on the device, and per source image with ``Results``.

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

The other tasks, as the JAX ``Predictor``: the decode of
``predictions_full``; OBB through ``nms_rotated`` (conf, iou, max_det; its
rows un-letterboxed into ``Results.obb``, ``Results.boxes`` the axis-aligned
(cx, cy, w, h) boxes of the same rows); segment and pose re-associate each
kept box with a candidate by the L1 distance of the centres
(``_match_candidates``): the masks are sigmoid(coefficients x prototypes),
cropped to the box at mask resolution, the letterbox padding cut, resized
bilinearly to the image (``imgproc.resize_linear_f32``) and thresholded at
0.5; the keypoints are mapped back by the letterbox's gain and padding.
The batch entry returns the task's decoded dict in place of ``cands``
(``predictions_full``), dets of OBB's 7 columns. A classify model, as in
JAX, letterboxes (it does not centre-crop) and takes the forward's
softmax: no decode and no NMS; its ``Results`` carry ``probs`` and no
boxes, and the batch entry returns (None, None, {"probs"}, meta). An
RT-DETR model takes no NMS either: its dets are ``predictions_full``'s
top 300 (query, class) pairs, kept where the score passes ``conf``
(``max_det``, ``iou`` and ``agnostic_nms`` are not read, as in JAX); the
batch entry's valid is that test.

With ``save``, ``save_txt`` or ``save_crop`` the image entry writes each
result under ``project/name`` (``runs/predict/exp``, incremented unless
``exist_ok``) as the JAX predictor does for image sources: the annotated
``{stem}.jpg``, ``labels/{stem}.txt`` (with the confidence under
``save_conf``) and ``crops/{class}/{stem}_{i}.jpg``, the JPEGs through
``data.imgproc.imwrite`` (the bytes ``cv2.imwrite`` writes at quality 95).

fp32 by default, as the JAX ``Predictor`` (the reference's ``half: False``).
``dtype="bfloat16"`` (or ``half=True``) serves in bf16 as the JAX bench
does: the model's parameters cast to bf16 in place (``nn.fuse.cast_params``;
BatchNorm statistics stay fp32), the letterbox computed in bf16, the forward
in bf16 (the ViL layers through their bf16 kernel on the card); decode and
NMS stay fp32. A YOLO-World model takes the detect path against its
``txt_feats``, which the cast leaves fp32 (it is not a parameter, as the
JAX predictor casts ``params`` and not the guide): what the guide touches
promotes to fp32, as in JAX.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..data.augment import letterbox
from ..data.imgproc import IMG_FORMATS, imwrite, resize_linear_f32
from ..data.loaders import LoadImagesAndVideos, LoadPilAndNumpy
from ..nn.fuse import cast_params
from ..ops.boxes import scale_boxes
from ..ops.letterbox import letterbox_device
from ..ops.nms import nms_rotated, non_max_suppression
from ..utils import increment_path
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
                 half: bool = False, callbacks=None, save: bool = False,
                 save_txt: bool = False, save_conf: bool = False, save_crop: bool = False,
                 project: str | None = None, name: str | None = None, exist_ok: bool = False,
                 **unported):
        if unported:
            raise ValueError(f"Predictor does not take {sorted(unported)}: video, stream and "
                             f"screen options are not ported")
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
        self.save, self.save_txt, self.save_conf, self.save_crop = (save, save_txt, save_conf,
                                                                    save_crop)
        self.save_dir = None
        if save or save_txt or save_crop:
            self.save_dir = increment_path(Path(project or "runs/predict") / (name or "exp"),
                                           exist_ok=exist_ok, mkdir=True)

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

    def postprocess(self, cands):
        """(B, N, 4 + nc) candidates -> (dets (B, max_det, 6), valid); an
        OBB model's (B, N, 5 + nc) -> ``nms_rotated``'s (dets (B, max_det,
        7), valid); an RT-DETR model's {"dets"} -> (dets, score > conf)."""
        task = getattr(self.model, "task", "detect")
        if task == "rtdetr":
            dets = cands["dets"].float()
            return dets, dets[..., 4] > self.conf
        if task == "obb":
            return nms_rotated(cands, conf_thres=self.conf, iou_thres=self.iou,
                               max_det=self.max_det)
        return non_max_suppression(cands, conf_thres=self.conf, iou_thres=self.iou,
                                   max_det=self.max_det, pre_topk=self.pre_topk,
                                   fast_sel=True, class_agnostic=self.agnostic)

    def decode(self, x: torch.Tensor):
        """The forward and decode of a letterboxed batch: the candidates,
        or a task model's ``predictions_full`` dict."""
        if getattr(self.model, "task", "detect") in ("detect", "world"):
            return self.model.predictions(x)
        return self.model.predictions_full(x)

    def __call__(self, source, stream: bool = False):
        """A batch of frames -> (dets, valid, cands, meta), dets boxes xyxy
        in the letterboxed frame; any other source -> ``list[Results]``, or
        with ``stream`` a generator that reads, predicts and yields one
        image at a time (module docstring)."""
        if isinstance(source, torch.Tensor) or (isinstance(source, np.ndarray)
                                                and source.ndim == 4):
            with torch.inference_mode():
                x, meta = self.preprocess(source)
                out = self.decode(x)
                if getattr(self.model, "task", "detect") == "classify":
                    return None, None, out, meta
                dets, valid = self.postprocess(self._candidates(out))
            return dets, valid, out, meta
        gen = self._results(source)
        return gen if stream else list(gen)

    def _results(self, source):
        self.callbacks.run("on_predict_start", self)
        names = getattr(self.model, "names", {}) or {}
        task = getattr(self.model, "task", "detect")
        for path, orig in load_source(source):
            self.callbacks.run("on_predict_batch_start", self)
            t0 = time.perf_counter()
            img, _, (r, px, py) = letterbox(orig, self.imgsz)
            with torch.inference_mode():
                x = torch.from_numpy(img).to(self.device)[None].float() / 255.0
                t1 = time.perf_counter()
                out = self.decode(x.to(self.dtype))
                full = ({"cands": out} if isinstance(out, torch.Tensor)
                        else {k: v.float() for k, v in out.items()})
                if task != "classify":
                    dets, valid = self.postprocess(self._candidates(full))
                    d = dets[0][valid[0]]
                if self.classes is not None and task not in ("obb", "classify"):
                    keep = torch.isin(d[:, 5].long(), torch.tensor(self.classes, device=d.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t2 = time.perf_counter()
            kw = {}
            if task == "classify":
                kw["probs"], d = full["probs"][0].cpu().numpy(), None
            elif task == "obb":
                d7 = d.cpu().numpy().astype(np.float32)
                d7[:, 0], d7[:, 1] = (d7[:, 0] - px) / r, (d7[:, 1] - py) / r
                d7[:, 2:4] /= r
                kw["obb"] = d7
                d = np.stack([d7[:, 0] - d7[:, 2] / 2, d7[:, 1] - d7[:, 3] / 2,
                              d7[:, 0] + d7[:, 2] / 2, d7[:, 1] + d7[:, 3] / 2, d7[:, 5],
                              d7[:, 6]], 1)
            else:
                dn = d.cpu().numpy()
                if task == "segment" and len(dn):
                    kw["masks"] = self._assemble_masks(dn, full["cands"][0].cpu().numpy(),
                                                       full["coefs"][0].cpu().numpy(),
                                                       full["proto"][0].cpu().numpy(),
                                                       orig.shape[:2], r, px, py)
                elif task == "pose" and len(dn):
                    kw["keypoints"] = self._gather_kpts(dn, full["cands"][0].cpu().numpy(),
                                                        full["kpts"][0].cpu().numpy(), r, px, py)
                if self.classes is not None:  # after the masks and keypoints, as JAX
                    d = d[keep]
                d = torch.cat([scale_boxes(d[:, :4], (self.imgsz, self.imgsz), orig.shape[:2],
                                           ratio_pad=(r, (px, py))), d[:, 4:]], 1).cpu().numpy()
            res = Results(orig, path=path, names=names, boxes=d,
                          speed={"preprocess": (t1 - t0) * 1e3, "inference": (t2 - t1) * 1e3,
                                 "postprocess": (time.perf_counter() - t2) * 1e3}, **kw)
            self.results = [res]
            self.callbacks.run("on_predict_postprocess_end", self)
            if self.save_dir is not None:
                self._write_results(path, res)
            if self.verbose:
                print(f"{path}: {res.verbose()} ({res.speed['inference']:.1f}ms inference)")
            self.callbacks.run("on_predict_batch_end", self)
            yield res
        self.callbacks.run("on_predict_end", self)

    def _write_results(self, path: str, res: Results):
        """Under ``save_dir``: ``{stem}.jpg`` (``res.plot()``) with ``save``,
        ``labels/{stem}.txt`` (``res.save_txt``) with ``save_txt``, and
        ``crops/{class name}/{stem}_{i}.jpg`` (each box's pixels, its corners
        cut to ints) with ``save_crop``; the JAX predictor's file tree. An
        array source's stem is ``image_<hash>``, as there."""
        stem = Path(path).stem if Path(path).suffix else f"image_{abs(hash(path)) % 10**8}"
        if self.save:
            imwrite(self.save_dir / f"{stem}.jpg", res.plot())
        if self.save_txt:
            (self.save_dir / "labels").mkdir(exist_ok=True)
            res.save_txt(self.save_dir / "labels" / f"{stem}.txt", save_conf=self.save_conf)
        if self.save_crop and res.boxes is not None and len(res.boxes):
            for bi in range(len(res.boxes)):
                xyxy = np.asarray(res.boxes.xyxy[bi]).astype(int)
                c = int(res.boxes.cls[bi])
                crop = res.orig_img[max(0, xyxy[1]):xyxy[3], max(0, xyxy[0]):xyxy[2]]
                if crop.size:
                    d = self.save_dir / "crops" / str(res.names.get(c, str(c)))
                    d.mkdir(parents=True, exist_ok=True)
                    imwrite(d / f"{stem}_{bi}.jpg", crop)

    def _candidates(self, out):
        """What ``postprocess`` takes from ``decode``'s output."""
        if isinstance(out, torch.Tensor):
            return out
        return out if getattr(self.model, "task", "detect") == "rtdetr" else out["cands"].float()

    @staticmethod
    def _match_candidates(d: np.ndarray, cands: np.ndarray) -> np.ndarray:
        """Each kept box's candidate: the least L1 distance between its
        centre and the candidates' (x, y)."""
        dxy = (d[:, :2] + d[:, 2:4]) / 2
        return np.argmin(np.abs(cands[None, :, 0] - dxy[:, 0:1])
                         + np.abs(cands[None, :, 1] - dxy[:, 1:2]), axis=1)

    def _assemble_masks(self, d, cands, coefs, proto, orig_shape, r, px, py) -> np.ndarray:
        """(n, H0, W0) boolean masks of the kept boxes ``d`` (letterboxed
        xyxy); ``proto`` (nm, hm, wm)."""
        nm, hm, wm = proto.shape
        flat = proto.reshape(nm, -1).T
        sx, sy = wm / self.imgsz, hm / self.imgsz
        pxm, pym = int(px * sx), int(py * sy)
        masks = []
        for di, ci in enumerate(self._match_candidates(d, cands)):
            m = (1 / (1 + np.exp(-(flat @ coefs[ci])))).reshape(hm, wm)
            x1, y1, x2, y2 = d[di, :4]
            xs, ys = int(x1 * sx), int(y1 * sy)
            xe, ye = max(int(x2 * sx), xs + 1), max(int(y2 * sy), ys + 1)
            crop = np.zeros_like(m)
            crop[ys:ye, xs:xe] = m[ys:ye, xs:xe]
            crop = crop[pym:hm - pym or hm, pxm:wm - pxm or wm]
            masks.append(resize_linear_f32(crop, (orig_shape[1], orig_shape[0])) > 0.5)
        return np.stack(masks)

    def _gather_kpts(self, d, cands, kpts, r, px, py) -> np.ndarray:
        """(n, K, nd) keypoints of the kept boxes, in the image's pixels (nd
        3 where the row's width divides by 3, as JAX reads it)."""
        nd = 3 if kpts.shape[-1] % 3 == 0 else 2
        k = kpts[self._match_candidates(d, cands)].reshape(len(d), -1, nd).copy()
        k[..., 0] = (k[..., 0] - px) / r
        k[..., 1] = (k[..., 1] - py) / r
        return k

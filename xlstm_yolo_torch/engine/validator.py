"""Validator: mAP of a detect, segment, pose or OBB model over a dataset's
val split, or the top-1 / top-5 accuracy of a classify model.

Port of ``Validator`` in ``xlstm_yolo_tpu/engine/validator.py`` for those
tasks: on the device, the eval forward,
the DFL decode and the fixed-shape multi-label NMS (conf 0.001, IoU 0.7,
300 detections, a 1,024-candidate pool; ``exact_nms`` the greedy
suppression); on the host, the greedy IoU matching at ten thresholds and
the 101-point AP (``utils.metrics``). A square detect batch comes from the
native letterbox (float32 in [0, 1], the JAX validator's batch) where g++
is found; the other batches ship uint8 and are normalized on the device.
fp32 by default, as the reference's ``half: False``; ``half=True``
validates a bf16 copy of the model (``nn.fuse.cast_params``, as the port's
``Predictor``).

``rect`` letterboxes each batch to its aspect-ratio bucket (aligned to the
model's coarsest stride, padded half a stride) instead of the square
``imgsz``; ``save_json`` writes COCO-format records of the detections in
the images' own pixels to ``save_dir/predictions.json``; ``plots`` counts
the confusion matrix and writes it and the PR / F1 / P / R curves to
``save_dir`` (matplotlib; without it one warning names the files not
written).

The other tasks, as in JAX: OBB through ``nms_rotated`` and probiou
matching; segment adds the mask mAP (``mAP50(M)``, ``mAP50-95(M)``: each
kept detection's mask, coefficients at its NMS source index times the
prototypes, logit > 0 inside its box at mask resolution, against the
ground truth's overlap-encoded masks, by mask IoU); pose the keypoint mAP
(``mAP50(P)``, ``mAP50-95(P)``, by OKS with ``OKS_SIGMA`` at 17 points, 1
/ nk otherwise, and the 0.53 area factor); their fitness is the mean of the
box and the mask (or keypoint) fitness. Classify, as in JAX: the val split
of a folder-per-class set (``data`` its root, or the trainer's dict with
its ``path``), centre-cropped (``classify_eval_transform``), the softmax
on the device; ``accuracy_top1`` (also the fitness) and ``accuracy_top5``
on the host, and with ``plots`` the (nc, nc) confusion matrix of the top-1
classes. An RT-DETR model has no validation: the JAX ``Validator``
reads the Detect head's maps, which its decoder does not give, so the
JAX package cannot validate one; the port raises a ``ValueError``. A
YOLO-World model takes the detect path, scored against its own
``txt_feats``; its val loader is the JAX one's ``MultiModalDataset``
(unseeded ``RandomLoadText``, no embeddings), which remaps each image's
label classes to their sampled text slots, as in JAX.
"""
from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import numpy as np
import torch

from .. import native
from ..data.converter import coco80_to_coco91_class
from ..data.dataset import build_dataloader, check_det_dataset
from ..data.imgproc import resize_nearest
from ..nn.fuse import cast_params
from ..ops.nms import nms_rotated, non_max_suppression
from ..utils.loss import OKS_SIGMA
from ..utils import metrics as MET
from ..utils import plotting as PLT
from ..utils.callbacks import default_callbacks


RTDETR_NO_VAL = ("an RT-DETR model cannot be validated: the JAX package's Validator reads the "
                 "Detect head's maps, which RT-DETR's decoder does not give; train with "
                 "val=False and predict")


class Validator:
    """``Validator(model, data=...)()`` -> {precision, recall, mAP50,
    mAP50-95, fitness, images, img_s} (and ``save_json_path``); runs on the
    model's device."""

    def __init__(self, model, data=None, imgsz: int = 640, conf: float = 0.001,
                 iou: float = 0.7, max_det: int = 300, max_labels: int = 128,
                 batch: int = 16, verbose: bool = False, callbacks=None,
                 half: bool = False, save_json: bool = False, save_dir: str | Path | None = None,
                 exact_nms: bool = False, pre_topk: int = 1024, plots: bool = False,
                 rect: bool = False):
        if getattr(model, "task", "detect") == "rtdetr":
            raise ValueError(RTDETR_NO_VAL)
        self.callbacks = callbacks if callbacks is not None else default_callbacks()
        self.model = model
        self.half = half
        self.data = data
        self.imgsz, self.conf, self.iou, self.max_det = imgsz, conf, iou, max_det
        self.max_labels, self.batch, self.pre_topk = max_labels, batch, pre_topk
        self.verbose = verbose
        self.save_json, self.exact_nms, self.plots, self.rect = save_json, exact_nms, plots, rect
        self.save_dir = Path(save_dir) if save_dir else Path("runs/val")
        self.cm = None
        self.loader = None
        self._plotted = False

    @torch.inference_mode()
    def __call__(self, data: str | dict | None = None) -> dict:
        self.callbacks.run("on_val_start", self)
        self._plotted = False
        data = data or self.data
        if self.model.task == "classify":
            return self._call_classify(data)
        if isinstance(data, (str, Path)):
            data = check_det_dataset(data)
        # rect buckets align to the coarsest stride, or the FPN's shapes would not meet
        stride = max(32, int(max(self.model.strides)))
        task = self.model.task
        loader, _ = build_dataloader(data, "val", batch=self.batch, imgsz=self.imgsz,
                                     augment=False, max_labels=self.max_labels, rect=self.rect,
                                     stride=stride, task=task)
        self.loader = loader  # its native_batches and batch_seconds, for the callbacks
        # a square detect batch takes the native letterbox (float32, as the JAX
        # val loader's); the others ship uint8 and are normalized on the device
        loader.ds.uint8_images = not (loader.ds.task == "detect" and not loader.ds.rect
                                      and native.available())
        if self.plots:
            self.cm = MET.ConfusionMatrix(int(self.model.nc), conf=self.conf)
        jdict, files, class_map = [], loader.ds.files, self._class_map(data)
        model, device, dtype = self._eval_model()
        if task not in ("detect", "world"):
            return self._call_task(model, loader, device, dtype)
        stats = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
        n_img = 0
        t0 = time.time()
        for batch in loader:
            self.callbacks.run("on_val_batch_start", self)
            x = self._images(batch, device, dtype)
            dets, valid = non_max_suppression(
                model.predictions(x).float(), conf_thres=self.conf, iou_thres=self.iou,
                max_det=self.max_det, multi_label=True, exact=self.exact_nms,
                pre_topk=self.pre_topk)
            dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
            n_img += len(dets)
            for bi in range(len(dets)):
                d = dets[bi][valid[bi]]  # (n, 6) xyxy conf cls
                if self.save_json:
                    self._pred_to_json(jdict, d, files, int(batch["im_idx"][bi]),
                                       tuple(np.asarray(batch["ori_shape"][bi])),
                                       tuple(x.shape[1:3]), class_map, load_sz=self.imgsz)
                gt = batch["cls_boxes"][bi][batch["mask"][bi]]  # (m, 5) cls xyxy
                gt_cls = gt[:, 0]
                if self.cm is not None:
                    self.cm.process_batch(d if len(d) else None, gt[:, 1:5], gt_cls)
                if len(d) == 0:
                    if len(gt):
                        stats["target_cls"].append(gt_cls)
                    continue
                iou = MET.box_iou_np(gt[:, 1:5], d[:, :4]) if len(gt) else np.zeros((0, len(d)))
                stats["tp"].append(MET.match_predictions(d[:, 5], gt_cls, iou))
                stats["conf"].append(d[:, 4])
                stats["pred_cls"].append(d[:, 5])
                stats["target_cls"].append(gt_cls)
            self.callbacks.run("on_val_batch_end", self)
        dt = time.time() - t0
        json_path = None
        if self.save_json:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            json_path = self.save_dir / "predictions.json"
            with open(json_path, "w") as f:
                json.dump(jdict, f)
        out, r = self._finalize(stats, n_img, dt)
        if json_path is not None:
            out["save_json_path"] = str(json_path)
        if self.verbose and r is not None:
            names = getattr(self.model, "names", {}) or {}
            for ci, c in enumerate(r["unique_classes"]):
                print(f"  {names.get(int(c), c):>12}: n={r['nt'][ci]} P={r['p'][ci]:.3f} "
                      f"R={r['r'][ci]:.3f} AP50={r['ap50'][ci]:.3f} AP={r['ap'][ci].mean():.3f}")
        return out

    def _eval_model(self) -> tuple:
        """(the model in eval mode, a bf16 copy of it with ``half``; its
        device; the images' dtype)."""
        model = self.model.eval()
        if self.half:
            model = cast_params(copy.deepcopy(model), torch.bfloat16)
        dtype = torch.bfloat16 if self.half else torch.float32
        return model, next(model.parameters()).device, dtype

    def _call_classify(self, data) -> dict:
        """The classify path (module docstring) -> {accuracy_top1,
        accuracy_top5, fitness, images, img_s}."""
        root = data.get("path") if isinstance(data, dict) else data
        loader, _ = build_dataloader(root, "val", batch=self.batch, imgsz=self.imgsz,
                                     augment=False, task="classify")
        model, device, dtype = self._eval_model()
        if self.plots:
            self.cm = MET.ConfusionMatrix(int(model.nc), conf=self.conf, task="classify")
        correct1 = correct5 = total = 0
        t0 = time.time()
        for batch in loader:
            self.callbacks.run("on_val_batch_start", self)
            x = torch.from_numpy(batch["img"]).to(device, dtype)
            probs = model.predictions_full(x)["probs"].float().cpu().numpy()
            labels = batch["label"]
            top5 = np.argsort(-probs, axis=-1)[:, :5]
            if self.cm is not None:
                self.cm.process_cls_preds(top5, labels)
            correct1 += int((top5[:, 0] == labels).sum())
            correct5 += int((top5 == labels[:, None]).any(-1).sum())
            total += len(labels)
            self.callbacks.run("on_val_batch_end", self)
        dt = time.time() - t0
        self._plot_metrics()
        self.callbacks.run("on_val_end", self)
        top1 = correct1 / max(total, 1)
        return {"accuracy_top1": top1, "accuracy_top5": correct5 / max(total, 1),
                "fitness": top1, "images": total, "img_s": round(total / dt, 1)}

    def _images(self, batch, device, dtype) -> torch.Tensor:
        img = torch.from_numpy(batch["img"]).to(device)
        return (img.float() / 255.0 if img.dtype == torch.uint8 else img).to(dtype)

    def _call_task(self, model, loader, device, dtype) -> dict:
        """The OBB, segment and pose paths (module docstring)."""
        task = model.task
        box_stats = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
        extra_stats = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
        nk = model.kpt_shape[0]
        sigmas = np.asarray(OKS_SIGMA if nk == 17 else np.ones(nk) / nk)
        n_img = 0
        t0 = time.time()
        for batch in loader:
            self.callbacks.run("on_val_batch_start", self)
            x = self._images(batch, device, dtype)
            full = {k: v.float() for k, v in model.predictions_full(x).items()}
            if task == "obb":
                dets, valid = nms_rotated(full["cands"], conf_thres=self.conf,
                                          iou_thres=self.iou, max_det=self.max_det)
                src = None
            else:
                dets, valid, src = non_max_suppression(
                    full["cands"], conf_thres=self.conf, iou_thres=self.iou,
                    max_det=self.max_det, multi_label=True, exact=self.exact_nms,
                    pre_topk=self.pre_topk, return_idx=True)
                src = src.cpu().numpy()
            dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
            n_img += len(dets)
            if task == "segment":
                coefs, proto = full["coefs"].cpu().numpy(), full["proto"].cpu().numpy()
                hm, wm = proto.shape[2:4]
                sx, sy = wm / batch["img"].shape[2], hm / batch["img"].shape[1]
            elif task == "pose":
                kpts_all = full["kpts"].cpu().numpy()
            for bi in range(len(dets)):
                keep = valid[bi]
                d = dets[bi][keep]
                gt_mask = batch["mask"][bi]
                gt = batch["cls_boxes"][bi][gt_mask]
                gt_cls = gt[:, 0]
                if task == "obb":  # d: (n, 7) = cx, cy, w, h, angle, conf, cls
                    if self.cm is not None:
                        self.cm.process_batch(d[:, [0, 1, 2, 3, 5, 6, 4]] if len(d) else None,
                                              gt[:, 1:6], gt_cls)
                    if len(d) == 0:
                        if len(gt):
                            box_stats["target_cls"].append(gt_cls)
                        continue
                    iou = (MET.batch_probiou_np(gt[:, 1:6].astype(np.float32), d[:, :5])
                           if len(gt) else np.zeros((0, len(d))))
                    self._append(box_stats, d[:, 6], d[:, 5], gt_cls, iou)
                    continue
                if self.cm is not None:
                    self.cm.process_batch(d if len(d) else None, gt[:, 1:5], gt_cls)
                if len(d) == 0:
                    if len(gt):
                        box_stats["target_cls"].append(gt_cls)
                        extra_stats["target_cls"].append(gt_cls)
                    continue
                iou = MET.box_iou_np(gt[:, 1:5], d[:, :4]) if len(gt) else np.zeros((0, len(d)))
                self._append(box_stats, d[:, 5], d[:, 4], gt_cls, iou)
                if not len(gt):
                    continue
                if task == "segment":
                    pm = np.einsum("nc,chw->nhw", coefs[bi, src[bi][keep]], proto[bi])
                    db = d[:, :4] * [sx, sy, sx, sy]
                    ys = np.arange(hm)[None, :, None]
                    xs = np.arange(wm)[None, None, :]
                    inbox = ((xs >= db[:, 0, None, None]) & (xs < db[:, 2, None, None])
                             & (ys >= db[:, 1, None, None]) & (ys < db[:, 3, None, None]))
                    pmask = (pm > 0.0) & inbox
                    gtm = np.asarray(batch["masks"][bi])
                    if gtm.shape != (hm, wm):
                        gtm = resize_nearest(gtm.astype(np.float32), (wm, hm)).astype(np.int32)
                    gflat = (gtm[None] == (np.arange(len(gt)) + 1)[:, None, None]).reshape(
                        len(gt), -1).astype(np.float32)
                    pflat = pmask.reshape(len(d), -1).astype(np.float32)
                    inter = gflat @ pflat.T
                    union = gflat.sum(1)[:, None] + pflat.sum(1)[None] - inter
                    self._append(extra_stats, d[:, 5], d[:, 4], gt_cls,
                                 inter / np.maximum(union, 1e-7))
                else:
                    pk = kpts_all[bi, src[bi][keep]].reshape(len(d), nk, -1)
                    gk = np.asarray(batch["keypoints"][bi][gt_mask])
                    area = (gt[:, 3] - gt[:, 1]) * (gt[:, 4] - gt[:, 2]) * 0.53
                    self._append(extra_stats, d[:, 5], d[:, 4], gt_cls,
                                 kpt_iou_np(gk, pk, sigmas, area))
            self.callbacks.run("on_val_batch_end", self)
        dt = time.time() - t0
        out = self._finalize(box_stats, n_img, dt)[0]
        if task == "obb":
            return out
        other = self._finalize(extra_stats, n_img, dt)[0]
        tag = "M" if task == "segment" else "P"
        out.update({f"mAP50({tag})": other["mAP50"], f"mAP50-95({tag})": other["mAP50-95"]})
        out["fitness"] = 0.5 * out["fitness"] + 0.5 * other["fitness"]
        return out

    @staticmethod
    def _append(stats: dict, pred_cls, conf, gt_cls, iou) -> None:
        stats["tp"].append(MET.match_predictions(pred_cls, gt_cls, iou))
        stats["conf"].append(conf)
        stats["pred_cls"].append(pred_cls)
        stats["target_cls"].append(gt_cls)

    def _finalize(self, stats: dict, n_img: int, dt: float) -> tuple:
        """(metrics, ``ap_per_class``'s result or None) of one set of
        statistics; plots (once a call) and runs ``on_val_end``, as JAX's
        does at each."""
        if not stats["tp"]:
            self._plot_metrics()
            self.callbacks.run("on_val_end", self)
            return {"mAP50": 0.0, "mAP50-95": 0.0, "precision": 0.0, "recall": 0.0,
                    "fitness": 0.0, "images": n_img, "img_s": round(n_img / dt, 1)}, None
        r = MET.ap_per_class(np.concatenate(stats["tp"]), np.concatenate(stats["conf"]),
                             np.concatenate(stats["pred_cls"]),
                             np.concatenate(stats["target_cls"]))
        self._plot_metrics(r)
        self.callbacks.run("on_val_end", self)
        return {"precision": r["mp"], "recall": r["mr"], "mAP50": r["map50"],
                "mAP50-95": r["map"], "fitness": MET.fitness(r["map50"], r["map"]),
                "images": n_img, "img_s": round(n_img / dt, 1)}, r

    def _plot_metrics(self, r=None) -> None:
        """With ``plots``: the confusion matrix (counts and normalized) and,
        given ``ap_per_class``'s result, the PR / F1 / P / R curves, into
        ``save_dir``; without matplotlib one warning naming those files."""
        if not self.plots:
            return
        curves = r is not None and len(r.get("px", ()))
        fnames = ["confusion_matrix.png", "confusion_matrix_normalized.png"] * (
            self.cm is not None) + ["PR_curve.png", "F1_curve.png", "P_curve.png",
                                   "R_curve.png"] * bool(curves)
        if self._plotted:  # once a call: a segment or pose run finalizes twice
            return
        self._plotted = True
        if not PLT.have_matplotlib():
            print(f"WARNING: plots=True but matplotlib is not installed; not written to "
                  f"{self.save_dir}: {', '.join(fnames)}")
            return
        self.save_dir.mkdir(parents=True, exist_ok=True)
        names = dict(getattr(self.model, "names", {}) or {})
        if self.cm is not None:
            self.cm.plot(self.save_dir, names=names, normalize=False)
            self.cm.plot(self.save_dir, names=names, normalize=True)
        if curves:
            cnames = {i: names.get(int(c), str(int(c))) for i, c in enumerate(r["unique_classes"])}
            PLT.plot_pr_curve(r["px"], r["prec_values"], r["ap50"], names=cnames,
                              fname=self.save_dir / "PR_curve.png")
            for key, ylabel, fn in (("f1_curve", "F1", "F1_curve.png"),
                                    ("p_curve", "Precision", "P_curve.png"),
                                    ("r_curve", "Recall", "R_curve.png")):
                PLT.plot_mc_curve(r["px"], r[key], names=cnames, ylabel=ylabel,
                                  fname=self.save_dir / fn)

    def _class_map(self, data) -> list:
        """Class index -> COCO-format category id: the paper's 91 ids when
        validating COCO itself (``val2017.txt`` / ``test-dev2017.txt``),
        else 1-based ids."""
        val = str(data.get("val", "")) if isinstance(data, dict) else ""
        is_coco = "coco" in val and val.endswith(("val2017.txt", "test-dev2017.txt"))
        nc = int(getattr(self.model, "nc", 80) or 80)
        return coco80_to_coco91_class() if is_coco else list(range(1, nc + 1))

    @staticmethod
    def _pred_to_json(jdict: list, dets, files, img_idx: int, ori_shape, imgsz, class_map,
                      load_sz: float | None = None) -> None:
        """COCO-format records of one image's (n, 6) detections, appended
        to ``jdict``: boxes out of the letterboxed input (square ``imgsz``
        or a rect bucket's (h, w)) back to the image's own pixels, xywh from
        the top-left corner; ``image_id`` the file stem (as a number when it
        is one). The gain is clamped by the load's long-side resize to
        ``load_sz``: a rect bucket longer than that is padded, not filled."""
        stem = Path(files[img_idx]).stem if img_idx < len(files) else str(img_idx)
        image_id = int(stem) if stem.isnumeric() else stem
        d = np.asarray(dets, dtype=float)
        if len(d) and ori_shape is not None:
            h0, w0 = float(ori_shape[0]), float(ori_shape[1])
            in_h, in_w = ((imgsz, imgsz) if np.isscalar(imgsz) else
                          (float(imgsz[0]), float(imgsz[1])))
            r1 = (load_sz or max(in_h, in_w)) / max(h0, w0)
            gain = min(r1, in_h / h0, in_w / w0)
            padx, pady = (in_w - w0 * gain) / 2, (in_h - h0 * gain) / 2
            d = d.copy()
            d[:, [0, 2]] = np.clip((d[:, [0, 2]] - padx) / gain, 0, w0)
            d[:, [1, 3]] = np.clip((d[:, [1, 3]] - pady) / gain, 0, h0)
        for x1, y1, x2, y2, conf, cls in d:
            ci = int(cls)
            jdict.append({"image_id": image_id,
                          "category_id": class_map[ci] if ci < len(class_map) else ci,
                          "bbox": [round(x1, 3), round(y1, 3), round(x2 - x1, 3),
                                   round(y2 - y1, 3)],
                          "score": round(float(conf), 5)})


def kpt_iou_np(gt_kpts: np.ndarray, pred_kpts: np.ndarray, sigmas: np.ndarray, area: np.ndarray,
               eps: float = 1e-7) -> np.ndarray:
    """OKS (m_gt, n_pred): e = d^2 / ((2 sigma)^2 * area * 2), exp(-e)
    averaged over each ground truth's visible keypoints."""
    m, nk = gt_kpts.shape[:2]
    out = np.zeros((m, pred_kpts.shape[0]), np.float32)
    for gi in range(m):
        vis = gt_kpts[gi, :, 2] != 0 if gt_kpts.shape[-1] > 2 else np.ones(nk, bool)
        d2 = ((pred_kpts[:, :, 0] - gt_kpts[gi, :, 0]) ** 2
              + (pred_kpts[:, :, 1] - gt_kpts[gi, :, 1]) ** 2)
        e = d2 / ((2 * sigmas[None]) ** 2 * (area[gi] + eps) * 2)
        out[gi] = (np.exp(-e) * vis[None]).sum(-1) / (vis.sum() + eps)
    return out

"""Task model: a compiled YAML graph plus its task metadata.

Port of ``TaskModel`` in ``xlstm_yolo_tpu/nn/tasks.py`` for the detect,
segment, pose, obb, classify, rtdetr and world tasks.
The torch model owns its parameters (the JAX one keeps them outside as a
pytree): they are initialized from a ``torch.Generator`` seed with the JAX
package's init scheme, or loaded from a JAX variable tree with
``utils.jax_weights.load_jax_variables``. ``predictions`` keeps the JAX
boundary: NHWC images in, (B, N, 4 + nc) candidates out;
``predictions_full`` adds the task's outputs (``coefs`` and ``proto``,
``kpts``; an OBB model's candidates carry the angle last; a classify
model's ``probs``, the softmax of its logits); ``loss`` is the forward
plus the task's loss on a padded-label batch (the v8 detection loss, or
the segmentation, pose or OBB loss built on it), or a classify model's
cross-entropy against ``label``. A classify model has no strides. An
RT-DETR model (task ``rtdetr``) has the strides (8, 16, 32) without a
probe, its ``predictions_full`` is {"dets"} (NMS-free), and its loss adds
the denoising loss in train mode. A model whose
head is ``v10Detect`` is end to end (``e2e``): its inference decodes the
``one2one`` branch (then the usual NMS, as the JAX package serves it), and
its loss is the one2many loss (TAL top-10) plus the one2one loss (top-1).

A YOLO-World model (task ``world``, head ``WorldDetect``) scores its
classes against text embeddings, the guide: ``txt_feats`` (1, nc, embed),
raw normal draws from a generator seeded 0 by default, as the JAX model
draws them from ``PRNGKey(0)`` (a plain attribute that follows the model's
device and dtype moves, neither a parameter nor a buffer: the JAX
variables do not hold it, and a checkpoint does not either);
``set_classes`` swaps in other embeddings, L2-normalized, or class names
through a text encoder. ``predictions`` and ``predictions_full`` take the
model's guide, ``loss`` a batch's ``txt_feats`` (B, nt, embed) where the
batch has one; the class count of the maps, and so of the v8 detection
loss, is the guide's nt.
"""
from __future__ import annotations

import torch

from ..cfg import load_model_yaml
from ..utils import resolve_device
from ..utils.loss import (classification_loss, detection_loss, obb_loss, pose_loss,
                          segmentation_loss)
from ..utils.tal import TOPK
from . import heads as H
from . import rtdetr as R
from .graph import GraphModel, ParsedModel, parse_model
from .modules import init_tree

MOE_AUX = 0.01  # the weight of the MoE load-balance loss (the JAX hyp.moe_aux default)


class TaskModel(GraphModel):
    """``TaskModel("vil_yolon.yaml", device="cuda")``: the graph on
    ``device`` in eval mode, weights from ``seed``."""

    def __init__(self, cfg: str | dict, ch: int = 3, nc: int | None = None,
                 scale: str | None = None, device: str | torch.device = "cuda", seed: int = 0):
        dev = resolve_device(device)
        cfg_name = cfg if isinstance(cfg, str) else None
        if isinstance(cfg, str):
            yaml_dict, yscale = load_model_yaml(cfg)
            scale = scale or yscale
        else:
            yaml_dict = dict(cfg)
        if nc is not None:
            yaml_dict["nc"] = nc
        parsed: ParsedModel = parse_model(yaml_dict, ch=ch, scale=scale)
        super().__init__(parsed)
        self.yaml, self.scale, self.ch = yaml_dict, scale, ch
        self.cfg_name = cfg_name  # the YAML name it was built from, as the JAX model keeps it
        self.nc = parsed.nc
        self.names = {i: f"{i}" for i in range(self.nc)}
        self.task = parsed.task
        self.reg_max = 16
        self.e2e = parsed.head_index >= 0 and parsed.specs[parsed.head_index].name == "v10Detect"
        self.txt_feats = None
        if self.task == "world":
            embed = int(parsed.specs[parsed.head_index].args[0])
            self.txt_feats = torch.randn((1, self.nc, embed),
                                         generator=torch.Generator().manual_seed(0))
        self.init_weights(seed)
        self.eval()
        self.strides = self._probe_strides()
        self.to(dev)

    def _apply(self, fn, *args, **kwargs):
        """Module moves and casts (``to``, ``cuda``, ``double``) take the
        guide along."""
        super()._apply(fn, *args, **kwargs)
        if self.txt_feats is not None:
            self.txt_feats = fn(self.txt_feats)
        return self

    def forward(self, x, head_kwargs: dict | None = None, guide=None, upto: int | None = None):
        """The graph on NCHW ``x``; a world model's guide is ``guide`` where
        given, else ``txt_feats``; ``upto`` as ``GraphModel.forward``."""
        if guide is None:
            guide = self.txt_feats
        if guide is not None:
            guide = torch.as_tensor(guide).to(x.device)
        return super().forward(x, head_kwargs, guide, upto)

    @torch.no_grad()
    def set_classes(self, embeddings, encoder=None) -> None:
        """A world model's guide from ``embeddings`` ((nt, embed) or (1, nt,
        embed) vectors) or from a list of class names, which ``encoder``
        (``nn.clip_text.ClipTextEncoder``, or any ``list[str] -> (nt,
        embed)`` callable) embeds; L2-normalized (the norm clipped at 1e-6),
        fp32, on the model's device. ``nc`` becomes nt, ``names`` the class
        names (or their indices). Names without an encoder raise."""
        names = None
        if isinstance(embeddings, (list, tuple)) and embeddings and isinstance(embeddings[0], str):
            if encoder is None:
                raise ValueError("set_classes received strings but no text encoder; pass "
                                 "encoder=ClipTextEncoder(...) (nn/clip_text.py) or precomputed "
                                 "embeddings")
            names = dict(enumerate(embeddings))
            embeddings = encoder(list(embeddings))
        e = torch.as_tensor(embeddings, dtype=torch.float32)
        if e.ndim == 2:
            e = e[None]
        dev = next(self.parameters()).device
        self.txt_feats = (e / torch.linalg.vector_norm(e, dim=-1, keepdim=True).clamp_min(1e-6)
                          ).to(dev)
        self.nc = int(e.shape[1])
        self.names = names or {i: f"{i}" for i in range(self.nc)}

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Re-initialize every parameter with the JAX package's scheme,
        drawing from a generator seeded with ``seed``."""
        init_tree(self, seed)

    @torch.no_grad()
    def _probe_strides(self, imgsz: int = 64) -> tuple:
        """Detection strides from a zero forward on the CPU (the model is
        still there when this runs); none for a classify model, (8, 16, 32)
        for an RT-DETR one, as JAX sets them."""
        if self.task == "classify":
            return ()
        if self.task == "rtdetr":
            return (8, 16, 32)
        out = H.det_maps(self(torch.zeros(1, self.ch, imgsz, imgsz)))
        return tuple(imgsz // bm.shape[2] for bm, _ in out)

    def predictions(self, x: torch.Tensor) -> torch.Tensor:
        """Eval forward on NHWC images -> decoded (B, N, 4 + nc) candidates
        (pixel xywh + sigmoid scores). Not for an RT-DETR model, whose head
        gives no maps (as the JAX ``predictions`` fails on it): its decode is
        ``predictions_full``."""
        if self.task == "rtdetr":
            raise ValueError("an RT-DETR model decodes through predictions_full (NMS-free dets)")
        raw = H.det_maps(self(x.permute(0, 3, 1, 2)))
        return H.decode_detections(raw, self.strides, self.nc, self.reg_max)

    @property
    def kpt_shape(self) -> tuple:
        """The Pose head's (keypoints, dims); (17, 3) for the other heads."""
        return tuple(self._head_attr("kpt_shape", (17, 3)))

    def _head_attr(self, name: str, default):
        """An argument of the head row: a keyword, or Pose's positional
        ``kpt_shape`` (its second argument), else ``default``."""
        spec = self.parsed.specs[self.parsed.head_index]
        kwargs = dict(spec.kwargs)
        if name in kwargs:
            return kwargs[name]
        if name == "kpt_shape" and len(spec.args) >= 2 and isinstance(spec.args[1], tuple):
            return spec.args[1]
        return default

    def predictions_full(self, x: torch.Tensor) -> dict:
        """Eval forward on NHWC images -> the task's decoded outputs:
        ``cands`` (B, N, 4 + nc) (an OBB model's (B, N, 5 + nc): rotated
        cx, cy, w, h, scores, then the angle), plus ``coefs`` (B, N, nm) and
        ``proto`` (B, nm, Hm, Wm) for segment, ``kpts`` (B, N, nk * nd)
        pixel keypoints for pose; {"probs": (B, nc)} for classify; for
        rtdetr {"dets": (B, 300, 6)}, ``rtdetr_postprocess``'s pixel xyxy,
        score and class of the top (query, class) pairs."""
        out = self(x.permute(0, 3, 1, 2))
        if self.task == "rtdetr":
            return {"dets": R.rtdetr_postprocess(out, float(x.shape[1]))}
        if self.task == "classify":
            return {"probs": out.softmax(-1)}
        if self.task == "obb":
            return {"cands": H.decode_obb(out["det"], out["angle"], self.strides, self.nc,
                                          self.reg_max)}
        res = {"cands": H.decode_detections(H.det_maps(out), self.strides, self.nc,
                                            self.reg_max)}
        if self.task == "segment":
            res["coefs"] = H.flatten_maps(out["coefs"])
            res["proto"] = out["proto"]
        elif self.task == "pose":
            res["kpts"] = H.decode_keypoints(out["kpts"], self.strides, self.kpt_shape)
        return res

    def enable_pipeline(self, mesh=None, microbatches: int = 0, stages: int | None = None) -> int:
        """Switch every ViLBlockPairBlock to the stacked layout
        (``ViLBlockPairBlock.stack``, the weights carried over), pipelined
        over ``mesh``'s pp axis in ``microbatches`` (0: pp) microbatches;
        ``stages`` (default: the mesh's pp) without a mesh gives the
        stacked layout applied in sequence. Call it before the parameters
        are sharded or an optimizer reads them. Returns the number of
        blocks switched (0 when pp is 1); a block whose pair count does not
        divide by pp raises, and then none is switched."""
        pp = int(mesh.shape["pp"] if stages is None else stages)
        if pp <= 1:
            return 0
        blocks = [(s.i, getattr(self, f"l{s.i}")) for s in self.parsed.specs
                  if s.name == "ViLBlockPairBlock"]
        for i, blk in blocks:
            if blk.n % pp:
                raise ValueError(f"layer {i}: {blk.n} ViL pairs not divisible by pp={pp} "
                                 f"(pick a model scale with n % pp == 0)")
        for _, blk in blocks:
            blk.stack(pp, microbatches, mesh)
        return len(blocks)

    def disable_pipeline(self) -> None:
        """Every stacked ViLBlockPairBlock back to its pair modules (the
        layout of the YAML, which checkpoints hold)."""
        for s in self.parsed.specs:
            if s.name == "ViLBlockPairBlock":
                getattr(self, f"l{s.i}").unstack()

    def loss(self, batch: dict, gains=None, pose_gains=(12.0, 1.0)):
        """The task loss (``_task_loss``), plus, for a model with MoE FFN
        blocks (``MoEFFN``), their load-balance losses weighted by
        ``MOE_AUX``, reported as the term ``moe_aux``."""
        from ..parallel.moe import MoEFeedForward

        moes = [m for m in self.modules() if isinstance(m, MoEFeedForward)]
        for m in moes:
            m.aux = None
        total, aux = self._task_loss(batch, gains, pose_gains)
        if moes:
            moe = sum(m.aux for m in moes)
            total, aux = total + MOE_AUX * moe, {**aux, "moe_aux": moe}
            for m in moes:  # the graph stays with the loss, not the modules
                m.aux = None
        return total, aux

    def _task_loss(self, batch: dict, gains=None, pose_gains=(12.0, 1.0)):
        """Forward on ``batch["img"]`` (B, H, W, 3) float images plus the
        task's loss against ``batch["cls_boxes"]`` (B, n_max, 5) = (cls, x1,
        y1, x2, y2) pixels (OBB: (B, n_max, 6) = cls, cx, cy, w, h, angle)
        and ``batch["mask"]`` (B, n_max), plus ``batch["masks"]`` (segment)
        or ``batch["keypoints"]`` (pose); its terms weighted by ``gains``
        (box, cls, dfl; the defaults 7.5, 0.5, 1.5 when None) and, for pose,
        ``pose_gains`` (pose, kobj). The forward runs in the module's mode:
        in train mode (``model.train()``, as the trainer sets it) BatchNorm
        uses the batch statistics and updates its running ones. Returns
        (total, terms): {"box", "cls", "dfl"}, plus "seg", or "pose" and
        "kobj"; a classify model's is the cross-entropy of its logits against
        ``batch["label"]`` (B,) int64, (total, {"cls": total}). A world
        model's guide is ``batch["txt_feats"]`` where the batch has one,
        else its own ``txt_feats``. An
        end-to-end model (``e2e``) sums the one2many loss at TAL
        top-10 and the one2one loss at top-1, term by term; its head
        computes the one2many branch in train mode only, so its loss needs
        train mode. An RT-DETR model's loss is ``rtdetr_loss`` plus, in
        train mode, ``cdn_loss`` on 3 denoising groups (terms "box", "cls",
        "aux", "dn_box", "dn_cls"; ``gains`` are not read, as in JAX): the
        groups from ``batch["dn_queries"]`` (dn_cls, dn_box) where given,
        else drawn from a generator on the images' device seeded 0 on every
        call (the JAX loss's
        ``PRNGKey(0)`` without a ``dn_key``)."""
        if self.task == "rtdetr":
            return self._rtdetr_loss(batch)
        raw = self(batch["img"].permute(0, 3, 1, 2), guide=batch.get("txt_feats"))
        if self.task == "classify":
            total = classification_loss(raw, batch["label"])
            return total, {"cls": total}
        kw = {} if gains is None else {"gains": tuple(gains)}
        if self.task == "segment":
            lo = segmentation_loss(raw, batch, self.strides, self.reg_max, **kw)
            return lo.total, {"box": lo.box, "seg": lo.seg, "cls": lo.cls, "dfl": lo.dfl}
        if self.task == "pose":
            lo = pose_loss(raw, batch, self.strides, self.kpt_shape, self.reg_max, **kw,
                           pose_gain=pose_gains[0], kobj_gain=pose_gains[1])
            return lo.total, {"box": lo.box, "pose": lo.pose, "kobj": lo.kobj, "cls": lo.cls,
                              "dfl": lo.dfl}
        if self.task == "obb":
            lo = obb_loss(raw, batch, self.strides, self.reg_max, **kw)
            return lo.total, {"box": lo.box, "cls": lo.cls, "dfl": lo.dfl}
        if self.e2e:
            branches = [(raw["one2many"], 10), (raw["one2one"], 1)]
        else:
            branches = [(raw, TOPK)]
        los = [detection_loss(maps, batch["cls_boxes"], batch["mask"], self.strides,
                              self.reg_max, tal_topk=k, **kw) for maps, k in branches]
        return (sum(lo.total for lo in los),
                {t: sum(getattr(lo, t) for lo in los) for t in ("box", "cls", "dfl")})

    def _rtdetr_loss(self, batch: dict):
        img = batch["img"]
        imgsz = float(img.shape[1])
        head_kwargs, dn_meta = None, None
        if self.training and batch.get("cls_boxes") is not None:
            num_group = 3
            gt_cls, gt_box = R._gt_targets(batch, imgsz, torch.float32)
            mask = batch["mask"].float()
            if batch.get("dn_queries") is not None:
                dn_cls, dn_box = (t.to(img.device) for t in batch["dn_queries"])
                dn_pos, dn_valid, dn_gt_idx, _ = R.cdn_meta(mask, num_group)
            else:
                gen = torch.Generator(device=img.device).manual_seed(0)
                dn_cls, dn_box, dn_pos, dn_valid, dn_gt_idx = R.get_cdn_group(
                    gt_cls, gt_box, mask, self.nc, gen, num_group)
            head_kwargs = {"dn": (dn_cls, dn_box, num_group)}
            dn_meta = (dn_pos, dn_valid, dn_gt_idx)
        out = self(img.permute(0, 3, 1, 2), head_kwargs=head_kwargs)
        total, aux = R.rtdetr_loss(out, batch, self.nc, imgsz)
        if dn_meta is not None:
            dn_total, dn_aux = R.cdn_loss(out, dn_meta, batch, self.nc, imgsz)
            total, aux = total + dn_total, {**aux, **dn_aux}
        return total, aux

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def info(self) -> str:
        """One line, as the JAX ``TaskModel.info`` gives it: task, layers,
        strides, classes and parameters."""
        return (f"{self.task} model: {len(self.parsed.specs)} layers, strides {self.strides}, "
                f"nc={self.nc}, {self.num_params():,} params")

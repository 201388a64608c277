"""Open-vocabulary training data for YOLO-World.

Port of ``xlstm_yolo_tpu/data/multimodal.py``:

* ``RandomLoadText``: per image, the texts of the classes present plus
  random negatives, padded to ``max_samples`` slots, with the labels'
  class ids remapped to the sampled slots. It draws from numpy's
  ``default_rng(seed)`` in the JAX order, so a seeded one draws as the JAX
  one does, draw for draw. Without a seed (the default, and the trainer's)
  it draws differently on every run, as in JAX.
* ``names_to_texts``: the dataset's ``names`` -> synonym lists (``/``
  separates them).
* ``MultiModalDataset``: a ``YOLODataset`` whose batches carry ``texts``
  (B lists of ``max_samples`` strings, host-only) and, with an
  ``embed_fn`` (a ``list[str] -> (n, C)`` text tower), ``txt_feats`` (B,
  max_samples, C) float32: the guide of a world model's loss. The padded
  slots are the empty string, so they share one embedding. Without an
  ``embed_fn`` the class ids are remapped all the same, while the loss's
  guide is then the model's own ``txt_feats``, as in JAX.
* ``GroundingDataset``: detection labels from a grounding JSON (each
  image's ``caption``, each annotation's ``tokens_positive`` character
  spans naming its phrase; the phrases are the image's texts). Its labels
  are read from the JSON on every build: the YOLO label cache, keyed on
  label files, does not hold its texts.
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np

from .dataset import YOLODataset


class RandomLoadText:
    """Sample positive and negative class texts; remap class ids to their
    text slots. All positives are kept (up to ``max_samples``); one
    synonym is drawn per class."""

    def __init__(self, prompt_format: str = "{}", neg_samples: tuple = (80, 80),
                 max_samples: int = 80, padding: bool = True, padding_value: str = "",
                 seed: int | None = None):
        self.prompt_format = prompt_format
        self.neg_samples = neg_samples
        self.max_samples = max_samples
        self.padding = padding
        self.padding_value = padding_value
        self.rng = np.random.default_rng(seed)

    def __call__(self, cls: np.ndarray, texts: list) -> tuple:
        """``cls`` (n,) class ids, ``texts`` per-class synonym lists ->
        (new_cls (n,) float32 slot indices, -1 for a class left out; the
        sampled texts)."""
        cls = np.asarray(cls, np.int64).reshape(-1)
        pos = sorted(set(int(c) for c in cls))
        num_neg = int(self.rng.integers(self.neg_samples[0], self.neg_samples[1] + 1))
        neg_pool = [i for i in range(len(texts)) if i not in pos]
        self.rng.shuffle(neg_pool)
        keep = min(len(pos), self.max_samples)
        chosen = pos[:keep] + neg_pool[:min(len(neg_pool), num_neg, self.max_samples - keep)]
        remap = {c: i for i, c in enumerate(chosen)}
        out_texts = []
        for c in chosen:
            syn = texts[c]
            pick = syn[int(self.rng.integers(len(syn)))] if len(syn) > 1 else syn[0]
            out_texts.append(self.prompt_format.format(pick))
        if self.padding:
            out_texts += [self.padding_value] * (self.max_samples - len(out_texts))
        new_cls = np.asarray([remap.get(int(c), -1) for c in cls], np.float32)
        return new_cls, out_texts


def names_to_texts(names: dict) -> list:
    """Dataset ``names`` {index: "name/synonym"} -> per-class synonym lists."""
    return [str(names[k]).split("/") for k in sorted(names)]


class MultiModalDataset(YOLODataset):
    """A ``YOLODataset`` whose batches carry sampled class texts and, with
    ``embed_fn``, their embeddings (module docstring). ``text_cfg`` updates
    ``RandomLoadText``'s defaults: negatives and slots min(80, nc - 1) and
    min(80, nc)."""

    def __init__(self, img_path: str, names: dict, *, text_cfg: dict | None = None,
                 embed_fn=None, **kw):
        super().__init__(img_path, **kw)
        self.texts = names_to_texts(names)
        cfg = dict(neg_samples=(min(80, max(1, len(self.texts) - 1)),) * 2,
                   max_samples=min(80, len(self.texts)))
        cfg.update(text_cfg or {})
        self.loader_text = RandomLoadText(**cfg)
        self.embed_fn = embed_fn

    def collate(self, samples: list, idxs=None) -> dict:
        return self._attach_texts(super().collate(samples, idxs))

    def collate_native(self, idxs) -> dict | None:
        batch = super().collate_native(idxs)
        return None if batch is None else self._attach_texts(batch)

    def _attach_texts(self, batch: dict) -> dict:
        cb, mask = batch["cls_boxes"], batch["mask"]
        all_texts = []
        for bi in range(cb.shape[0]):
            new_cls, texts = self.loader_text(cb[bi, mask[bi], 0], self.texts)
            cb[bi, mask[bi], 0] = new_cls
            drop = np.zeros(mask.shape[1], bool)  # instances whose class was left out
            drop[np.flatnonzero(mask[bi])[new_cls < 0]] = True
            mask[bi] &= ~drop
            all_texts.append(texts)
        batch["texts"] = all_texts
        if self.embed_fn is not None:
            emb = np.asarray(self.embed_fn([t for ts in all_texts for t in ts]), np.float32)
            batch["txt_feats"] = emb.reshape(len(all_texts), -1, emb.shape[-1])
        return batch


class GroundingDataset(YOLODataset):
    """Detection over a grounding JSON: {"images": [{id, height, width,
    file_name, caption}], "annotations": [{image_id, bbox (COCO xywh),
    iscrowd, tokens_positive}]}. An image's labels: its non-crowd boxes of
    positive size, each the class of its phrase (the caption's
    ``tokens_positive`` spans joined by spaces) in order of first use; its
    ``texts`` those phrases."""

    def __init__(self, img_path: str, json_file: str, **kw):
        self.json_file = json_file
        super().__init__(img_path, **kw)

    def _scan(self, img_path) -> list:
        images, anns = self._read_json()
        files, self._grounding = [], {}
        for img_id, img in images.items():
            f = Path(img_path) / img["file_name"]
            if not f.exists() or img_id not in anns:
                continue
            files.append(str(f))
            self._grounding[str(f)] = (img, anns[img_id])
        return files

    def _read_json(self):
        with open(self.json_file) as fh:
            data = json.load(fh)
        images = {int(x["id"]): x for x in data["images"]}
        img_to_anns = defaultdict(list)
        for ann in data["annotations"]:
            img_to_anns[int(ann["image_id"])].append(ann)
        return images, img_to_anns

    def _load_labels_cached(self, img_path) -> list:
        return [self._load_label(f) for f in self.files]

    def _load_label(self, img_file: str) -> dict:
        img, anns = self._grounding[img_file]
        h, w = float(img["height"]), float(img["width"])
        caption = img["caption"]
        cat2id, texts, cls, boxes = {}, [], [], []
        for ann in anns:
            if ann.get("iscrowd"):
                continue
            x, y, bw, bh = map(float, ann["bbox"])
            if bw <= 0 or bh <= 0:
                continue
            phrase = " ".join(caption[t[0]:t[1]] for t in ann["tokens_positive"])
            if phrase not in cat2id:
                cat2id[phrase] = len(cat2id)
                texts.append([phrase])
            cls.append(cat2id[phrase])
            boxes.append([(x + bw / 2) / w, (y + bh / 2) / h, bw / w, bh / h])
        n = len(cls)
        return {"cls": np.asarray(cls, np.float32).reshape(n),
                "xywhn": np.asarray(boxes, np.float32).reshape(n, 4), "texts": texts}

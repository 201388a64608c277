"""CLIP text tower: class names -> text embeddings for YOLO-World.

Port of ``xlstm_yolo_tpu/nn/clip_text.py``, plain torch:

* ``SimpleTokenizer``: CLIP's byte-level BPE (html-unescaped, whitespace
  collapsed, lower-cased, ``<|startoftext|>`` / ``<|endoftext|>`` framing,
  merges from a merge list the caller supplies: the published
  ``bpe_simple_vocab_16e6.txt.gz`` or any file of its format). The JAX
  tokenizer splits words with the ``regex`` package's pattern
  ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
  [^\\s\\p{L}\\p{N}]+`` (IGNORECASE); this one scans with ``unicodedata``
  (``split_words``), and gives the same pieces: letter runs (category L*),
  one number (N*) at a time, runs of anything else that is not Unicode
  White_Space (which is not ``str.isspace``: U+001C-U+001F are pieces),
  the specials and contractions first, and U+017F (long s) matching ``s`` there, as
  IGNORECASE makes it. U+0345, which case-folds to a letter, belongs to no
  class under IGNORECASE, so both skip it. A character unassigned in
  Python's Unicode tables (15.0 for Python 3.12) counts as "anything
  else", where a newer ``regex`` may know it as a letter. ``ftfy``'s
  repair of mojibake is left out, as the JAX tokenizer leaves it out
  without the package.
* ``CLIPTextTower``: token and learned positional embeddings, pre-LN blocks
  of causal self-attention (an explicit softmax under JAX's ``finfo.min``
  mask) and QuickGELU MLPs (LayerNorm eps 1e-5), the final LayerNorm, and
  the projection of the features at the end-of-text token, the argmax of
  the ids; the raw parameters ``token_embedding``, ``positional_embedding``
  and ``text_projection`` under the JAX names.
* ``load_openai_clip_text`` / ``load_hf_clip_text``: an OpenAI ``clip`` or
  a ``transformers`` ``CLIPTextModelWithProjection`` state dict (plain
  dicts of arrays or tensors; neither package is imported) -> the tower's
  state dict.
* ``ClipTextEncoder``: ``list[str] -> (n, embed)`` L2-normalized float32
  features, for ``TaskModel.set_classes``, the trainer's ``text_encoder``
  and ``MultiModalDataset``'s ``embed_fn``.
"""
from __future__ import annotations

import functools
import gzip
import html
import unicodedata
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from .rtdetr import LayerNorm, _init_dense

# --- tokenizer ---

# Unicode's White_Space property: the regex package's \s
WHITE_SPACE = frozenset(chr(c) for c in (0x9, 0xA, 0xB, 0xC, 0xD, 0x20, 0x85, 0xA0, 0x1680,
                                         *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F,
                                         0x205F, 0x3000))
# characters in no class of the pattern under IGNORECASE
_UNMATCHED = frozenset("\u0345")
SPECIALS = ("<|startoftext|>", "<|endoftext|>")
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@functools.lru_cache()
def bytes_to_unicode() -> dict:
    """The reversible byte -> printable character map of byte-level BPE:
    printable ASCII and Latin-1 keep their code points, the other 68 bytes
    take 256 + n."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple) -> set:
    """The set of adjacent symbol pairs of ``word``."""
    return set(zip(word[:-1], word[1:]))


def collapse_white_space(text: str) -> str:
    """Every run of White_Space characters -> one space."""
    out, prev = [], False
    for c in text:
        ws = c in WHITE_SPACE
        if not (ws and prev):
            out.append(" " if ws else c)
        prev = ws
    return "".join(out)


def _clean(text: str) -> str:
    """CLIP's basic and whitespace cleaning without ftfy: html unescaped
    twice, White_Space runs collapsed, then ``str.strip``."""
    return collapse_white_space(html.unescape(html.unescape(text))).strip()


def _char_class(c: str) -> str:
    if c in WHITE_SPACE or c in _UNMATCHED:
        return " "
    cat = unicodedata.category(c)[0]
    return cat if cat in ("L", "N") else "O"


def _fold(c: str) -> str:
    """What IGNORECASE matches ``c`` to among the literals' characters: an
    ASCII letter's lower case, ``s`` for the long s."""
    return "s" if c == "\u017f" else c.lower() if c.isascii() else c


def _literal_at(text: str, i: int) -> int:
    """The length of the special or contraction that starts at ``i`` (the
    pattern's first alternatives, in its order), else 0."""
    if text[i] not in "<'":
        return 0
    for lit in SPECIALS + CONTRACTIONS:
        seg = text[i:i + len(lit)]
        if len(seg) == len(lit) and all(_fold(a) == b for a, b in zip(seg, lit)):
            return len(lit)
    return 0


def split_words(text: str) -> list:
    """``findall`` of the JAX tokenizer's pattern on ``text`` (module
    docstring)."""
    out, i, n = [], 0, len(text)
    while i < n:
        m = _literal_at(text, i)
        if m:
            out.append(text[i:i + m])
            i += m
            continue
        k = _char_class(text[i])
        if k == " ":
            i += 1
            continue
        j = i + 1
        if k != "N":
            while j < n and _char_class(text[j]) == k:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class SimpleTokenizer:
    """CLIP's byte-level BPE tokenizer. ``bpe_path``: the merge list (gzip
    when it ends in ``.gz``; a header line, then one ``a b`` merge a line),
    of which the first ``n_merges`` are read (all when None). The
    vocabulary: the 256 byte symbols, their ``</w>`` forms, one token a
    merge, then the two specials."""

    def __init__(self, bpe_path: str | Path, n_merges: int | None = 48_894):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        p = Path(bpe_path)
        raw = (gzip.open(p, "rt", encoding="utf-8").read() if p.suffix == ".gz"
               else p.read_text(encoding="utf-8"))
        merge_lines = raw.split("\n")[1:]  # line 0 is the version header
        if n_merges is not None:
            merge_lines = merge_lines[:n_merges]
        merges = [tuple(m.split()) for m in merge_lines if len(m.split()) == 2]
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += list(SPECIALS)
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {s: s for s in SPECIALS}
        self.sot, self.eot = self.encoder[SPECIALS[0]], self.encoder[SPECIALS[1]]
        self.vocab_size = len(self.encoder)

    def bpe(self, token: str) -> str:
        """``token``'s BPE symbols, space-separated, the last ending in ``</w>``."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list:
        """``text`` -> token ids, no framing."""
        ids = []
        for token in split_words(_clean(text).lower()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts, context_length: int = 77, truncate: bool = True) -> np.ndarray:
        """``clip.tokenize``: (n, context_length) int32 ids, each text framed
        by SOT and EOT and zero-padded; a longer one cut to the context with
        EOT last (``truncate``), else refused."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(f"text {i} too long for context {context_length}")
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[i, :len(ids)] = ids
        return out


# --- the text transformer ---


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class _ResBlock(nn.Module):
    """Pre-LN block: causal multi-head self-attention (one packed ``attn_in``
    projection, ``attn_out``), then the QuickGELU MLP (``mlp_fc``,
    ``mlp_proj``)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.width, self.heads = width, heads
        self.ln_1, self.ln_2 = LayerNorm(width, eps=1e-5), LayerNorm(width, eps=1e-5)
        self.attn_in = nn.Linear(width, 3 * width)
        self.attn_out = nn.Linear(width, width)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def init_params(self, g: torch.Generator) -> None:
        _init_dense(g, self.attn_in, self.attn_out, self.mlp_fc, self.mlp_proj)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        hd = self.width // self.heads
        q, k, v = (t.reshape(b, s, self.heads, hd).transpose(1, 2)
                   for t in self.attn_in(self.ln_1(x)).chunk(3, -1))
        att = q @ k.transpose(-1, -2) / torch.tensor(float(hd), dtype=x.dtype).sqrt()
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        att = att.masked_fill(~causal, torch.finfo(att.dtype).min).softmax(-1)
        o = (att @ v).transpose(1, 2).reshape(b, s, self.width)
        x = x + self.attn_out(o)
        return x + self.mlp_proj(quick_gelu(self.mlp_fc(self.ln_2(x))))


class CLIPTextTower(nn.Module):
    """CLIP's text encoder: ids (B, S) -> (B, embed_dim) features. The
    defaults are ViT-B/32's text widths."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 heads: int = 8, layers: int = 12, embed_dim: int = 512):
        super().__init__()
        self.layers = layers
        self.token_embedding = nn.Parameter(torch.zeros(vocab_size, width))
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        for i in range(layers):
            setattr(self, f"resblock_{i}", _ResBlock(width, heads))
        self.ln_final = LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))

    def init_params(self, g: torch.Generator) -> None:
        """The JAX tower's initializers: normal, std 0.02 (tokens), 0.01
        (positions), width ** -0.5 (projection)."""
        with torch.no_grad():
            self.token_embedding.normal_(0.0, 0.02, generator=g)
            self.positional_embedding.normal_(0.0, 0.01, generator=g)
            self.text_projection.normal_(0.0, self.text_projection.shape[0] ** -0.5,
                                         generator=g)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        x = self.token_embedding[tokens] + self.positional_embedding[None, :tokens.shape[1]]
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x)
        x = self.ln_final(x)
        # the end-of-text token has the largest id of its row
        feats = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
        return feats @ self.text_projection


# --- checkpoint import ---


def _np(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)


def load_openai_clip_text(state_dict: dict, layers: int | None = None) -> dict:
    """The text half of an OpenAI ``clip`` state dict (``token_embedding.weight``,
    ``positional_embedding``, ``transformer.resblocks.N.{ln_1, ln_2, attn.in_proj_*,
    attn.out_proj.*, mlp.c_fc.*, mlp.c_proj.*}``, ``ln_final.*``,
    ``text_projection``; arrays or tensors) -> the ``CLIPTextTower`` state
    dict (float32 tensors)."""
    def a(k):
        return torch.from_numpy(_np(state_dict[k]).copy())

    if layers is None:
        layers = 1 + max(int(k.split(".")[2]) for k in state_dict
                         if k.startswith("transformer.resblocks."))
    out = {"token_embedding": a("token_embedding.weight"),
           "positional_embedding": a("positional_embedding"),
           "text_projection": a("text_projection"),
           "ln_final.scale": a("ln_final.weight"), "ln_final.bias": a("ln_final.bias")}
    parts = {"ln_1": "ln_1", "ln_2": "ln_2", "attn_in": "attn.in_proj_",
             "attn_out": "attn.out_proj.", "mlp_fc": "mlp.c_fc.", "mlp_proj": "mlp.c_proj."}
    for i in range(layers):
        p, q = f"transformer.resblocks.{i}", f"resblock_{i}"
        for name, src in parts.items():
            if name.startswith("ln"):
                out[f"{q}.{name}.scale"] = a(f"{p}.{src}.weight")
                out[f"{q}.{name}.bias"] = a(f"{p}.{src}.bias")
            else:
                out[f"{q}.{name}.weight"] = a(f"{p}.{src}weight")
                out[f"{q}.{name}.bias"] = a(f"{p}.{src}bias")
    return out


def load_hf_clip_text(hf_state_dict: dict) -> dict:
    """A ``transformers`` ``CLIPTextModelWithProjection`` state dict -> the
    OpenAI naming (q, k and v packed into ``in_proj``) -> the tower's state
    dict."""
    sd = {k: _np(v) for k, v in hf_state_dict.items()}
    tm = "text_model."
    out = {"token_embedding.weight": sd[tm + "embeddings.token_embedding.weight"],
           "positional_embedding": sd[tm + "embeddings.position_embedding.weight"],
           "ln_final.weight": sd[tm + "final_layer_norm.weight"],
           "ln_final.bias": sd[tm + "final_layer_norm.bias"],
           "text_projection": sd["text_projection.weight"].T}
    i = 0
    while f"{tm}encoder.layers.{i}.layer_norm1.weight" in sd:
        p, q = f"{tm}encoder.layers.{i}", f"transformer.resblocks.{i}"
        for n in ("weight", "bias"):
            out[f"{q}.ln_1.{n}"] = sd[f"{p}.layer_norm1.{n}"]
            out[f"{q}.ln_2.{n}"] = sd[f"{p}.layer_norm2.{n}"]
            out[f"{q}.attn.in_proj_{n}"] = np.concatenate(
                [sd[f"{p}.self_attn.{c}_proj.{n}"] for c in ("q", "k", "v")], 0)
            out[f"{q}.attn.out_proj.{n}"] = sd[f"{p}.self_attn.out_proj.{n}"]
            out[f"{q}.mlp.c_fc.{n}"] = sd[f"{p}.mlp.fc1.{n}"]
            out[f"{q}.mlp.c_proj.{n}"] = sd[f"{p}.mlp.fc2.{n}"]
        i += 1
    return load_openai_clip_text(out, layers=i)


# --- the encoder ---


class ClipTextEncoder:
    """``ClipTextEncoder(bpe_path)(["person", "bus"])`` -> (2, embed)
    float32 numpy features, L2-normalized (the norm clipped at 1e-6).
    ``state_dict``: the tower's weights (``load_openai_clip_text``'s); None
    draws them from a generator seeded ``seed`` (for plumbing, as the JAX
    encoder's random init). The tower runs in fp32 on ``device`` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, bpe_path: str | Path, state_dict: dict | None = None,
                 tower: CLIPTextTower | None = None, context_length: int = 77,
                 n_merges: int | None = 48_894, device: str | torch.device = "cuda",
                 seed: int = 0):
        from ..utils import resolve_device
        from .modules import init_tree

        self.tokenizer = SimpleTokenizer(bpe_path, n_merges=n_merges)
        self.tower = tower or CLIPTextTower()
        self.context_length = context_length
        if state_dict is None:
            init_tree(self.tower, seed)
        else:
            self.tower.load_state_dict(state_dict)
        self.device = resolve_device(device)
        self.tower = self.tower.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_openai_checkpoint(cls, pt_path: str | Path, bpe_path: str | Path, **kw):
        """From a local ``.pt`` holding an OpenAI ``clip`` model's
        ``state_dict()``, read with ``torch.load(weights_only=True)``; the
        tower's widths from its shapes (heads: width / 64)."""
        sd = torch.load(Path(pt_path), map_location="cpu", weights_only=True)
        layers = 1 + max(int(k.split(".")[2]) for k in sd
                         if k.startswith("transformer.resblocks."))
        width = int(sd["ln_final.weight"].shape[0])
        vocab, ctx = (int(s) for s in (sd["token_embedding.weight"].shape[0],
                                       sd["positional_embedding"].shape[0]))
        tower = CLIPTextTower(vocab_size=vocab, context_length=ctx, width=width,
                              heads=width // 64, layers=layers,
                              embed_dim=int(sd["text_projection"].shape[1]))
        return cls(bpe_path, state_dict=load_openai_clip_text(sd, layers=layers), tower=tower,
                   context_length=ctx, **kw)

    def features(self, texts) -> torch.Tensor:
        """The tower's raw features of ``texts`` on its device."""
        tokens = torch.from_numpy(self.tokenizer(texts, self.context_length)).to(self.device)
        with torch.inference_mode():
            return self.tower(tokens)

    def __call__(self, texts) -> np.ndarray:
        feats = self.features(texts).float().cpu().numpy()
        return feats / np.clip(np.linalg.norm(feats, axis=-1, keepdims=True), 1e-6, None)

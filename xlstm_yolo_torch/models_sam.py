"""SAM: promptable segmentation. The ViT image encoder with decomposed
relative positions, the prompt encoder, the two-way mask decoder, the
``set_image`` / ``predict`` flow and automatic mask generation.

Port of ``xlstm_yolo_tpu/models_sam.py``, plain torch (the JAX module is
plain XLA: no kernel of its own), fp32, inference only. Activations are NHWC
as in JAX; the convolutions permute to NCHW and back. Module and parameter
names follow the JAX variable tree, so ``utils.jax_weights.load_jax_variables``
fills a model from a JAX tree with no missing or extra key. flax's defaults
are kept: LayerNorm eps 1e-6, the tanh GELU, attention projecting q, k and v
to the query's width.

The ViT's attention (``REAttention``) runs through
``F.scaled_dot_product_attention`` with the decomposed relative-position
terms as its additive bias, so that the (B, NH, S, S) softmax is never
materialized; the decoder's attention is ``nn.rtdetr.MultiHeadAttention``
(flax's form: the scores materialized, masked logits at ``finfo.min``).

Seeded init (``init_tree`` with a ``torch.Generator`` on the model's device,
the parameters drawn there; a seed gives other weights on the CPU and on the
card): flax's initializers, lecun-normal Dense and Conv kernels with zero
biases, normal(0.02) for ``pos_embed``, normal(1.0) for the prompt and
decoder tokens and ``pe_gaussian``, zeros for ``rel_pos_h`` / ``rel_pos_w``.

The predictors run the model on the device and the letterbox, the mask
resizes (``data.imgproc``'s uint8 and float cv2 ``INTER_LINEAR``) and the
automatic generator's NMS on the host, as the JAX ones do.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .nn.modules import init_tree
from .nn.rtdetr import LayerNorm, MultiHeadAttention
from .ops.letterbox import resize as jax_resize
from .utils import resolve_device


def lecun_normal_fan(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """flax's lecun-normal: a normal truncated at 2 sigma, variance 1 /
    ``fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncation correction
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


def init_layers(module: nn.Module, g: torch.Generator) -> None:
    """flax's default init of ``module``'s own Dense, Conv and ConvTranspose
    children: lecun-normal kernels (a transposed conv's fan-in is in x kh x
    kw, as of flax's (kh, kw, in, out) kernel), zero biases."""
    for child in module.children():
        if isinstance(child, nn.ConvTranspose2d):
            w = child.weight
            lecun_normal_fan(w, w.shape[0] * w.shape[2] * w.shape[3], g)
        elif isinstance(child, (nn.Linear, nn.Conv2d)):
            lecun_normal_fan(child.weight, child.weight[0].numel(), g)
        else:
            continue
        if child.bias is not None:
            nn.init.zeros_(child.bias)


def normal_(p: torch.Tensor, std: float, g: torch.Generator) -> None:
    with torch.no_grad():
        p.normal_(0.0, std, generator=g)


def conv_nhwc(conv: nn.Conv2d | nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on an NHWC tensor, as flax's ``nn.Conv`` takes it."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class Module(nn.Module):
    """A SAM module: ``init_params`` draws flax's default init of its own
    Dense, Conv and ConvTranspose children (``init_tree`` visits every
    module); subclasses add their own parameters' draws."""

    def init_params(self, g: torch.Generator) -> None:
        init_layers(self, g)


class MLPBlock(Module):
    """Two Dense layers with the tanh GELU between (``Dense_0``, ``Dense_1``)."""

    def __init__(self, c_in: int, dim: int, mlp_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(c_in, mlp_dim)
        self.Dense_1 = nn.Linear(mlp_dim, dim)

    def forward(self, x):
        return self.Dense_1(gelu(self.Dense_0(x)))


def get_rel_pos(rel_pos: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """The (q_size, k_size, hd) relative-position table: ``rel_pos``
    linearly resized (``jax.image.resize``) only where its length is not
    2 max(q, k) - 1, then gathered at the fp32 relative coordinates
    truncated to integers."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = jax_resize(rel_pos[None], (1, max_rel_dist, rel_pos.shape[-1]), "linear")[0]
    dev = rel_pos.device
    q = torch.arange(q_size, device=dev, dtype=torch.float32)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size, device=dev, dtype=torch.float32)[None, :] * max(q_size / k_size, 1.0)
    rel = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.to(torch.int32).long()]


class REAttention(Module):
    """The SAM ViT's attention: fused ``qkv``, the decomposed relative
    positions ``rel_pos_h`` / ``rel_pos_w`` added to the (h, w) x (h, w)
    logits, the softmax, ``proj``. NHWC in and out."""

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool = True,
                 input_size: tuple = (14, 14)):
        super().__init__()
        self.num_heads, self.use_rel_pos = num_heads, use_rel_pos
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def init_params(self, g):
        super().init_params(g)
        if self.use_rel_pos:
            nn.init.zeros_(self.rel_pos_h)
            nn.init.zeros_(self.rel_pos_w)

    def forward(self, x):
        b, h, w, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x.reshape(b, h * w, c)).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # (B, NH, S, hd)
        bias = None
        if self.use_rel_pos:
            r_q = q.reshape(b, nh, h, w, hd)
            rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, get_rel_pos(self.rel_pos_h, h, h))
            rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, get_rel_pos(self.rel_pos_w, w, w))
            bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(b, nh, h * w, h * w)
        y = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=hd ** -0.5)
        return self.proj(y.reshape(b, nh, h, w, hd).permute(0, 2, 3, 1, 4).reshape(b, h, w, c))


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) zero-padded to multiples of ``ws`` -> (B * nwin, ws, ws,
    C), and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(x: torch.Tensor, ws: int, hw_pad: tuple, hw: tuple) -> torch.Tensor:
    """The inverse of ``window_partition``, cropped back to ``hw``."""
    hp, wp = hw_pad
    h, w = hw
    b = x.shape[0] // (hp // ws * (wp // ws))
    c = x.shape[-1]
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, c)[:, :h, :w]


class ViTBlock(Module):
    """Pre-LN block: windowed attention (padded to a multiple of the window
    and cropped back) or global attention, then the MLP."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 0, mlp_ratio: float = 4.0,
                 use_rel_pos: bool = True, global_size: tuple = (64, 64)):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim)
        self.attn = REAttention(dim, num_heads, use_rel_pos,
                                (window_size, window_size) if window_size > 0 else global_size)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, dim, int(dim * mlp_ratio))

    def forward(self, x):
        b, h, w, c = x.shape
        shortcut = x
        x = self.norm1(x)
        ws = self.window_size
        if ws > 0:
            x, hw_pad = window_partition(x, ws)
        x = self.attn(x)
        if ws > 0:
            x = window_unpartition(x, ws, hw_pad, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax's ``padding="SAME"`` of one axis: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class ImageEncoderViT(Module):
    """16 x 16 patch conv, ``pos_embed`` (bicubic-resized as
    ``jax.image.resize`` where the grid differs), the blocks (global
    attention at ``global_attn_indexes``), the neck: 1 x 1 conv, LN, 3 x 3
    conv, LN. (B, H, W, 3) in [0, 1] -> (B, H/16, W/16, out_chans)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, dim: int = 768,
                 depth: int = 12, num_heads: int = 12, window_size: int = 14,
                 global_attn_indexes: tuple = (2, 5, 8, 11), out_chans: int = 256):
        super().__init__()
        self.patch_size, self.depth = patch_size, depth
        g = img_size // patch_size
        self.patch_embed = nn.Conv2d(3, dim, patch_size, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, dim))
        for i in range(depth):
            ws = 0 if i in global_attn_indexes else window_size
            setattr(self, f"block{i}", ViTBlock(dim, num_heads, window_size=ws,
                                                global_size=(g, g)))
        self.neck0 = nn.Conv2d(dim, out_chans, 1, bias=False)
        self.neck_ln0 = LayerNorm(out_chans)
        self.neck1 = nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False)
        self.neck_ln1 = LayerNorm(out_chans)

    def init_params(self, g):
        super().init_params(g)
        normal_(self.pos_embed, 0.02, g)

    def forward(self, x):
        p = self.patch_size
        ph, pw = same_pads(x.shape[1], p, p), same_pads(x.shape[2], p, p)
        if any(ph + pw):
            x = F.pad(x, (0, 0, *pw, *ph))
        x = conv_nhwc(self.patch_embed, x)
        b, h, w, dim = x.shape
        pos = self.pos_embed
        if pos.shape[1:3] != (h, w):
            pos = jax_resize(pos, (1, h, w, dim), "cubic")
        x = x + pos
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.neck_ln0(conv_nhwc(self.neck0, x))
        return self.neck_ln1(conv_nhwc(self.neck1, x))


class PromptEncoder(Module):
    """Point and box prompts -> sparse (B, T, C) embeddings; the dense
    random-Fourier positional map of the image grid; ``no_mask_embed``."""

    def __init__(self, embed_dim: int = 256):
        super().__init__()
        self.embed_dim = embed_dim
        self.pe_gaussian = nn.Parameter(torch.zeros(2, embed_dim // 2))
        # 0: negative point, 1: positive point, 2: box corner 1, 3: box corner 2
        self.point_embeddings = nn.Parameter(torch.zeros(4, embed_dim))
        self.not_a_point = nn.Parameter(torch.zeros(embed_dim))
        self.no_mask_embed = nn.Parameter(torch.zeros(embed_dim))

    def init_params(self, g):
        for p in (self.pe_gaussian, self.point_embeddings, self.not_a_point, self.no_mask_embed):
            normal_(p, 1.0, g)

    def pe_encode(self, coords_01: torch.Tensor) -> torch.Tensor:
        x = ((2.0 * coords_01 - 1.0) @ self.pe_gaussian) * (2 * math.pi)
        return torch.cat([torch.sin(x), torch.cos(x)], -1)

    def dense_pe(self, h: int, w: int) -> torch.Tensor:
        dev = self.pe_gaussian.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return self.pe_encode(torch.stack([gx, gy], -1))  # (H, W, C)

    def forward(self, points=None, labels=None, boxes=None, img_size: float = 1024.0):
        """points (B, P, 2) px and labels (B, P) (1 positive, 0 negative, -1
        padding: ``not_a_point``); boxes (B, 2, 2) px corners."""
        sparse = []
        if points is not None:
            pe = self.pe_encode(points / img_size)
            lab = labels[..., None]
            pe = torch.where(lab == 1, pe + self.point_embeddings[1], pe)
            pe = torch.where(lab == 0, pe + self.point_embeddings[0], pe)
            pe = torch.where(lab == -1, self.not_a_point.expand_as(pe), pe)
            sparse.append(pe)
        if boxes is not None:
            pe = self.pe_encode(boxes / img_size)
            sparse.append(pe + self.point_embeddings[2:4][None])
        if not sparse:
            return self.pe_gaussian.new_zeros(1, 0, self.embed_dim)
        return torch.cat(sparse, 1)


class TwoWayAttentionBlock(Module):
    """Token self-attention, token -> image and image -> token attention
    (``self_attn``, ``t2i``, ``i2t``), the MLP, four LayerNorms."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_dim: int = 2048):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, num_heads)
        self.n1 = LayerNorm(dim)
        self.t2i = MultiHeadAttention(dim, num_heads)
        self.n2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, dim, mlp_dim)
        self.n3 = LayerNorm(dim)
        self.i2t = MultiHeadAttention(dim, num_heads)
        self.n4 = LayerNorm(dim)

    def forward(self, queries, keys, query_pe, key_pe):
        q = queries + query_pe
        queries = self.n1(queries + self.self_attn(q, q, queries))
        queries = self.n2(queries + self.t2i(queries + query_pe, keys + key_pe, keys))
        queries = self.n3(queries + self.mlp(queries))
        keys = self.n4(keys + self.i2t(keys + key_pe, queries + query_pe, queries))
        return queries, keys


class MaskDecoder(Module):
    """The two-way transformer over the IoU and mask tokens and the prompt,
    ``final_t2i``, the 4x upscale (two 2 x 2 / 2 transposed convs, LN, tanh
    GELU), the hypernetwork MLPs and ``iou_head``."""

    def __init__(self, dim: int = 256, num_multimask: int = 3, depth: int = 2):
        super().__init__()
        self.depth, n = depth, num_multimask + 1
        self.n_tokens = n
        self.iou_token = nn.Parameter(torch.zeros(1, dim))
        self.mask_tokens = nn.Parameter(torch.zeros(n, dim))
        for i in range(depth):
            setattr(self, f"block{i}", TwoWayAttentionBlock(dim))
        self.final_t2i = MultiHeadAttention(dim, 8)
        self.final_norm = LayerNorm(dim)
        self.up1 = nn.ConvTranspose2d(dim, dim // 4, 2, 2)
        self.up_ln = LayerNorm(dim // 4)
        self.up2 = nn.ConvTranspose2d(dim // 4, dim // 8, 2, 2)
        for m in range(n):
            setattr(self, f"hyper{m}", MLPBlock(dim, dim // 8, dim))
        self.iou_head = nn.Linear(dim, n)

    def init_params(self, g):
        super().init_params(g)
        normal_(self.iou_token, 1.0, g)
        normal_(self.mask_tokens, 1.0, g)

    def forward(self, image_embed, image_pe, sparse_prompt, dense_prompt):
        """image_embed (B, H, W, C); image_pe (H, W, C); sparse (B, T, C);
        dense (B, H, W, C) -> (masks (B, M, 4H, 4W), iou (B, M))."""
        b, h, w, c = image_embed.shape
        tokens = torch.cat([self.iou_token, self.mask_tokens])[None].expand(b, -1, -1)
        tokens = torch.cat([tokens, sparse_prompt], 1)
        src = (image_embed + dense_prompt).reshape(b, h * w, c)
        pos = image_pe.reshape(1, h * w, c).expand(b, -1, -1)
        queries = qpe = tokens
        for i in range(self.depth):
            queries, src = getattr(self, f"block{i}")(queries, src, qpe, pos)
        queries = self.final_norm(queries + self.final_t2i(queries + qpe, src + pos, src))
        iou_out = queries[:, 0]
        mask_out = queries[:, 1:1 + self.n_tokens]
        up = gelu(self.up_ln(conv_nhwc(self.up1, src.reshape(b, h, w, c))))
        up = gelu(conv_nhwc(self.up2, up))
        hyper = torch.stack([getattr(self, f"hyper{m}")(mask_out[:, m])
                             for m in range(self.n_tokens)], 1)
        masks = torch.einsum("bmc,bhwc->bmhw", hyper, up)
        return masks, self.iou_head(iou_out)


class SAM(Module):
    """The whole SAM: ``image_encoder`` (heads = dim // 64), ``prompt_encoder``,
    ``mask_decoder``; built on ``device`` and seeded there from ``seed``."""

    def __init__(self, img_size: int = 1024, encoder_dim: int = 768, encoder_depth: int = 12,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.img_size = img_size
        with dev:
            self.image_encoder = ImageEncoderViT(img_size=img_size, dim=encoder_dim,
                                                 depth=encoder_depth,
                                                 num_heads=max(1, encoder_dim // 64))
            self.prompt_encoder = PromptEncoder()
            self.mask_decoder = MaskDecoder()
        init_tree(self, seed, dev)
        self.eval()

    def encode_image(self, x):
        return self.image_encoder(x)

    def decode(self, emb, points=None, labels=None, boxes=None):
        h, w = emb.shape[1:3]
        pe = self.prompt_encoder
        sparse = pe(points, labels, boxes, img_size=float(self.img_size))
        dense = pe.no_mask_embed[None, None, None].expand(emb.shape)
        return self.mask_decoder(emb, pe.dense_pe(h, w), sparse, dense)

    def forward(self, x, points=None, labels=None, boxes=None):
        return self.decode(self.encode_image(x), points, labels, boxes)


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def letterbox_meta_prompts(meta, points=None, point_labels=None, boxes=None):
    """Points (P, 2) and a box (4,) in original pixels -> the letterboxed
    prompts as JAX builds them in numpy (``p * r + [px, py]``, promoted to
    fp64 by the pad list, then fp32 at the device), batch 1."""
    r, px, py = meta
    p = lab = bx = None
    if points is not None:
        p = (np.asarray(points, np.float32) * r + [px, py])[None].astype(np.float32)
        lab = np.asarray(point_labels if point_labels is not None
                         else np.ones(len(points)))[None]
    if boxes is not None:
        bx = (np.asarray(boxes, np.float32).reshape(2, 2) * r + [px, py])[None].astype(np.float32)
    return p, lab, bx


def mask_to_image(m: np.ndarray, img_size: int, meta, orig_shape) -> np.ndarray:
    """A float (h, w) mask logit map -> float (H, W) at the original size:
    cv2-linear to ``img_size``, the letterbox padding cropped (JAX's ``S -
    int(p) or None`` slice), cv2-linear to the original."""
    from .data.imgproc import resize_linear_f32

    r, px, py = meta
    oh, ow = orig_shape
    S = img_size
    full = resize_linear_f32(m, (S, S)) if m.shape != (S, S) else m
    crop = full[int(py):S - int(py) or None, int(px):S - int(px) or None]
    return resize_linear_f32(crop, (ow, oh))


class SAMPredictor:
    """``set_image`` / ``predict``: ``SAMPredictor(device="cuda").set_image(img)
    .predict(points=[[x, y]])``; ``model`` a ``SAM`` (ViT-B at ``img_size``
    seeded from ``seed`` by default)."""

    def __init__(self, model: nn.Module | None = None, img_size: int = 1024,
                 device: str | torch.device = "cuda", seed: int = 0):
        self.model = model if model is not None else SAM(img_size=img_size, device=device,
                                                           seed=seed)
        self.device = model_device(self.model)
        self.img_size = img_size
        self._embed = None
        self._orig_shape = None
        self._meta = None

    def preprocess(self, img: np.ndarray) -> np.ndarray:
        """HWC uint8 RGB -> the letterboxed uint8 square (host); keeps the
        letterbox meta and the original shape."""
        from .data.augment import letterbox

        self._orig_shape = img.shape[:2]
        lb, _, meta = letterbox(img, self.img_size)
        self._meta = meta
        return lb

    @torch.inference_mode()
    def encode(self, lb: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(lb)).to(self.device)[None].float() / 255.0
        self._embed = self.model.encode_image(x)
        return self._embed

    def set_image(self, img: np.ndarray):
        """img: HWC uint8 RGB; letterboxed to the model size (no mean or
        std, as in JAX)."""
        self.encode(self.preprocess(img))
        return self

    @torch.inference_mode()
    def decode(self, points=None, point_labels=None, boxes=None):
        """The prompts in original pixels -> (masks (M, h, w), iou (M,)) on
        the device."""
        assert self._embed is not None, "call set_image first"
        p, lab, bx = (None if a is None else torch.as_tensor(a).to(self.device)
                      for a in letterbox_meta_prompts(self._meta, points, point_labels, boxes))
        masks, iou = self.model.decode(self._embed, p, lab, bx)
        return masks[0], iou[0]

    def postprocess(self, masks: torch.Tensor, iou: torch.Tensor, multimask_output: bool = True):
        """The decoded masks to bool masks at the original size (host)."""
        sel = slice(None) if multimask_output else slice(0, 1)
        out = np.stack([mask_to_image(m, self.img_size, self._meta, self._orig_shape) > 0
                        for m in masks[sel].float().cpu().numpy()])
        return out, iou[sel].cpu().numpy()

    def predict(self, points=None, point_labels=None, boxes=None, multimask_output: bool = True):
        """points (P, 2) / boxes (4,) in ORIGINAL image pixels -> (masks (M,
        H, W) bool at the original resolution, iou (M,))."""
        masks, iou = self.decode(points, point_labels, boxes)
        return self.postprocess(masks, iou, multimask_output)


# ---------------------------------------------------------------------------
# Automatic mask generation: the point grid in fixed-size batches through
# one decode that also filters and boxes on the device; NMS and the uncrop on
# the host.
# ---------------------------------------------------------------------------

def build_point_grid(n_per_side: int) -> np.ndarray:
    """Uniform (n^2, 2) grid in [0, 1]^2."""
    offset = 1 / (2 * n_per_side)
    side = np.linspace(offset, 1 - offset, n_per_side)
    px = np.tile(side[None, :], (n_per_side, 1))
    py = np.tile(side[:, None], (1, n_per_side))
    return np.stack([px, py], -1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side: int, n_layers: int, scale_per_layer: int) -> list:
    """The point grid of each crop layer."""
    return [build_point_grid(max(1, int(n_per_side / (scale_per_layer ** i))))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: tuple, n_layers: int, overlap_ratio: float) -> tuple:
    """Layered overlapping crop boxes, xyxy, and each one's layer."""
    crop_boxes, layer_idxs = [[0, 0, im_size[1], im_size[0]]], [0]
    im_h, im_w = im_size
    short_side = min(im_h, im_w)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_side))
        cw, chh = crop_len(im_w, n_side, overlap), crop_len(im_h, n_side, overlap)
        for x0 in (int((cw - overlap) * i) for i in range(n_side)):
            for y0 in (int((chh - overlap) * j) for j in range(n_side)):
                crop_boxes.append([x0, y0, min(x0 + cw, im_w), min(y0 + chh, im_h)])
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(N, h, w) bool -> (N, 4) fp32 xyxy in mask pixels; zeros for an
    empty mask."""
    n, h, w = masks.shape
    any_col = masks.any(1)  # (N, w)
    any_row = masks.any(2)  # (N, h)
    xs = torch.arange(w, device=masks.device)
    ys = torch.arange(h, device=masks.device)
    x1 = torch.where(any_col, xs, w).amin(1)
    x2 = torch.where(any_col, xs, -1).amax(1) + 1
    y1 = torch.where(any_row, ys, h).amin(1)
    y2 = torch.where(any_row, ys, -1).amax(1) + 1
    box = torch.stack([x1, y1, x2, y2], 1).float()
    return torch.where(any_col.any(1)[:, None], box, 0.0)


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, iou_thres: float) -> np.ndarray:
    """Host greedy NMS in ``np.argsort(-scores)`` order; the kept indices."""
    order = np.argsort(-scores)
    keep = []
    while len(order):
        i = order[0]
        keep.append(i)
        if len(order) == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        a = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        b = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(a + b - inter, 1e-9)
        order = rest[iou <= iou_thres]
    return np.asarray(keep, np.int64)


class SAMAutoMaskGenerator:
    """Grid-prompted "segment everything" on a ``SAMPredictor``: each crop's
    point grid in batches of ``points_batch_size`` through ``batch_fn`` on
    the device (decode, stability score, boxes, keep flags), then on the host
    the near-crop-edge filter, NMS per crop and across crops, and the uncrop
    to the original image."""

    def __init__(self, predictor: SAMPredictor, points_stride: int = 32,
                 points_batch_size: int = 64, conf_thres: float = 0.88,
                 stability_score_thresh: float = 0.95, stability_score_offset: float = 0.95,
                 iou_thres: float = 0.7, crop_nms_thresh: float = 0.7,
                 mask_threshold: float = 0.0):
        self.p = predictor
        self.points_stride = points_stride
        self.points_batch_size = points_batch_size
        self.conf_thres = conf_thres
        self.stab_thresh = stability_score_thresh
        self.stab_offset = stability_score_offset
        self.iou_thres = iou_thres
        self.crop_nms_thresh = crop_nms_thresh
        self.mask_threshold = mask_threshold

    @torch.inference_mode()
    def batch_fn(self, emb: torch.Tensor, pts: torch.Tensor, labels: torch.Tensor):
        """One fixed-size point batch (bs, 1, 2) on the device -> (binary
        masks (bs M, h, w), iou (bs M,), boxes (bs M, 4), keep (bs M,))."""
        embb = emb.expand(pts.shape[0], *emb.shape[1:])
        masks, iou = self.p.model.decode(embb, pts, labels, None)
        n, m, mh, mw = masks.shape
        masks = masks.reshape(n * m, mh, mw)
        iou = iou.reshape(n * m)
        t = self.mask_threshold
        pos = (masks > (t + self.stab_offset)).sum((1, 2))
        neg = (masks > (t - self.stab_offset)).sum((1, 2))
        stab = pos / torch.clamp(neg, min=1)
        binm = masks > t
        boxes = masks_to_boxes(binm)
        keep = (iou > self.conf_thres) & (stab > self.stab_thresh) & binm.any(2).any(1)
        return binm, iou, boxes, keep

    def crop_batches(self, lb: np.ndarray, crop_n_layers: int = 0,
                     crop_overlap_ratio: float = 512 / 1500, crop_downscale_factor: int = 1,
                     point_grids=None) -> list:
        """The device stage: for each crop region, its embedding and the
        kept (masks, scores, boxes) of its point batches, on the host.
        Returns [(region, layer, masks, scores, boxes)] (None where nothing
        was kept)."""
        p, S = self.p, self.p.img_size
        crop_regions, layer_idxs = generate_crop_boxes((S, S), crop_n_layers, crop_overlap_ratio)
        if point_grids is None:
            point_grids = build_all_layer_point_grids(self.points_stride, crop_n_layers,
                                                      crop_downscale_factor)
        from .data.imgproc import resize

        out = []
        for region, layer in zip(crop_regions, layer_idxs):
            x1, y1, x2, y2 = region
            crop = lb[y1:y2, x1:x2]
            if (y2 - y1, x2 - x1) != (S, S):
                crop = resize(crop, (S, S))
            with torch.inference_mode():
                x = torch.from_numpy(np.ascontiguousarray(crop)).to(p.device)[None].float() / 255.0
                emb = p.model.encode_image(x)
            pts = (point_grids[layer] * S).astype(np.float32)
            bs = self.points_batch_size
            n_pad = (-len(pts)) % bs
            pts_pad = np.concatenate([pts, np.zeros((n_pad, 2), np.float32)])
            valid_pt = np.concatenate([np.ones(len(pts), bool), np.zeros(n_pad, bool)])
            lab = torch.ones((bs, 1), dtype=torch.float32, device=p.device)
            kept = []
            for b0 in range(0, len(pts_pad), bs):
                pb = torch.from_numpy(pts_pad[b0:b0 + bs]).to(p.device)[:, None, :]
                kept.append(self.keep_batch(*self.batch_fn(emb, pb, lab), valid_pt[b0:b0 + bs]))
            kept = [k for k in kept if k is not None]
            if kept:
                masks, scores, boxes = (np.concatenate(z) for z in zip(*kept))
                out.append((region, layer, masks, scores, boxes))
            else:
                out.append((region, layer, None, None, None))
        return out

    @staticmethod
    def keep_batch(binm, iou, boxes, keep, valid_pt):
        """A batch's outputs -> its kept (masks, scores, boxes) on the host,
        or None: the keep flags and each point's validity over its M masks;
        only the kept masks leave the device."""
        k = keep.cpu().numpy() & np.repeat(valid_pt, binm.shape[0] // len(valid_pt))
        if not k.any():
            return None
        idx = torch.from_numpy(np.nonzero(k)[0]).to(binm.device)
        return (binm[idx].cpu().numpy(), iou.cpu().numpy()[k], boxes.cpu().numpy()[k])

    def host_stage(self, per_crop: list, orig_shape: tuple, meta: tuple):
        """The host stage on ``crop_batches``' output: the crop-edge filter,
        NMS per crop and across crops, the uncrop to the original image."""
        S = self.p.img_size
        oh, ow = orig_shape
        r, px, py = meta
        all_masks, all_scores, all_boxes, region_areas = [], [], [], []
        for region, _, masks, scores, boxes in per_crop:
            if masks is None:
                continue
            x1, y1, x2, y2 = region
            cw, chh = x2 - x1, y2 - y1
            mh, mw = masks.shape[1:]
            boxes = boxes * np.asarray([cw / mw, chh / mh, cw / mw, chh / mh], np.float32)
            boxes += np.asarray([x1, y1, x1, y1], np.float32)
            if (chh, cw) != (S, S):
                # drop boxes touching the crop edge but not the image edge
                near_crop = ((np.abs(boxes[:, 0] - x1) < 20) | (np.abs(boxes[:, 1] - y1) < 20)
                             | (np.abs(boxes[:, 2] - x2) < 20) | (np.abs(boxes[:, 3] - y2) < 20))
                near_img = ((boxes[:, 0] < 20) | (boxes[:, 1] < 20)
                            | (boxes[:, 2] > S - 20) | (boxes[:, 3] > S - 20))
                ok = ~(near_crop & ~near_img)
                masks, scores, boxes = masks[ok], scores[ok], boxes[ok]
                if not len(masks):
                    continue
            k = greedy_nms(boxes, scores, self.iou_thres)
            all_masks.append((masks[k], region))
            all_scores.append(scores[k])
            all_boxes.append(boxes[k])
            region_areas.append(np.full(len(k), cw * chh, np.float32))
        if not all_scores:
            return (np.zeros((0, oh, ow), bool), np.zeros(0, np.float32),
                    np.zeros((0, 4), np.float32))
        scores = np.concatenate(all_scores)
        boxes = np.concatenate(all_boxes)
        areas = np.concatenate(region_areas)
        flat = [(m, reg) for ms, reg in all_masks for m in ms]
        if len(per_crop) > 1:
            k = greedy_nms(boxes, 1.0 / areas, self.crop_nms_thresh)
            scores, boxes = scores[k], boxes[k]
            flat = [flat[i] for i in k]
        from .data.imgproc import resize_linear_f32

        out_masks = np.zeros((len(flat), oh, ow), bool)
        canvas = np.zeros((S, S), np.float32)
        for i, (m, (cx1, cy1, cx2, cy2)) in enumerate(flat):
            canvas[:] = 0
            canvas[cy1:cy2, cx1:cx2] = resize_linear_f32(m.astype(np.float32),
                                                         (cx2 - cx1, cy2 - cy1))
            crop = canvas[int(py):S - int(py) or None, int(px):S - int(px) or None]
            out_masks[i] = resize_linear_f32(crop, (ow, oh)) > 0.5
        boxes = boxes.copy()
        boxes[:, [0, 2]] = np.clip((boxes[:, [0, 2]] - px) / r, 0, ow)
        boxes[:, [1, 3]] = np.clip((boxes[:, [1, 3]] - py) / r, 0, oh)
        return out_masks, scores, boxes

    def generate(self, img: np.ndarray, crop_n_layers: int = 0,
                 crop_overlap_ratio: float = 512 / 1500, crop_downscale_factor: int = 1,
                 point_grids=None):
        """img: HWC uint8 RGB -> (masks (N, H, W) bool in the original image,
        scores (N,), boxes (N, 4) xyxy original pixels)."""
        from .data.augment import letterbox

        lb, _, meta = letterbox(img, self.p.img_size)
        per_crop = self.crop_batches(lb, crop_n_layers, crop_overlap_ratio,
                                     crop_downscale_factor, point_grids)
        return self.host_stage(per_crop, img.shape[:2], meta)

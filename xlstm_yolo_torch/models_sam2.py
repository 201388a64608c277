"""SAM2: the Hiera trunk, the FPN neck, memory attention, the memory encoder,
the ring-buffer video tracker; and MobileSAM's TinyViT encoder and
``build_sam``.

Port of ``xlstm_yolo_tpu/models_sam2.py``, plain torch (no kernel of its
own in JAX either), fp32, inference only, NHWC activations as in JAX. The
memory bank is a fixed ring of ``num_maskmem`` slots with a validity mask:
slot 0 holds the conditioning frame for good, slots 1 to M-1 cycle, and each
slot's age indexes the learned ``maskmem_tpos_enc``. Bank, ages and validity
live on the device.

Memory attention cross-attends every query of the frame into all M x h x w
memory tokens (4,096 x 28,672 at 1024 px) through
``F.scaled_dot_product_attention`` (``SDPAttention``): no logits are
materialized. An invalid slot's keys get flax's ``finfo.min`` as an additive
bias, so a row with no valid slot is finite (uniform weights) and
``SAM2._condition`` replaces it by ``x + no_mem_embed``, as JAX does.

Seeded init as ``models_sam`` (on the model's device): normal(0.02) for
``pos_embed``, ``pos_embed_window`` and ``no_mem_embed``, zeros for
``maskmem_tpos_enc``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .models_sam import (
    SAM, MaskDecoder, MLPBlock, Module, PromptEncoder, SAMPredictor, conv_nhwc, gelu, model_device,
    normal_, window_partition, window_unpartition,
)
from .nn.modules import init_tree
from .nn.rtdetr import LayerNorm, MultiHeadAttention
from .utils import resolve_device


def max_pool_nhwc(x: torch.Tensor, s: int) -> torch.Tensor:
    """flax's ``nn.max_pool`` (s x s, stride s, VALID) on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), s, s).permute(0, 2, 3, 1)


def bicubic_resize(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """(1, h, w, c) -> (1, oh, ow, c) by torch's bicubic (a = -0.75,
    half-pixel centres, border-replicated taps): the kernel of the JAX
    ``_bicubic_resize_torch`` matrices."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow), mode="bicubic",
                         align_corners=False).permute(0, 2, 3, 1)


class HieraMSA(Module):
    """Packed ``qkv``; on a q-pool block the query is max-pooled s x s after
    the projection; softmax attention; ``proj``."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, q_stride: int = 0):
        super().__init__()
        self.dim_out, self.num_heads, self.q_stride = dim_out, num_heads, q_stride
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x):  # (B, H, W, C)
        b, h, w, _ = x.shape
        nh = self.num_heads
        dh = self.dim_out // nh
        qkv = self.qkv(x.reshape(b, h * w, -1)).reshape(b, h * w, 3, nh, dh)
        q, k, v = qkv.unbind(2)  # (B, S, NH, dh)
        if self.q_stride:
            q = max_pool_nhwc(q.reshape(b, h, w, -1), self.q_stride)
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, nh, dh)
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2))
        return self.proj(o.transpose(1, 2).reshape(b, h * w, self.dim_out)).reshape(
            b, h, w, self.dim_out)


class HieraBlock(Module):
    """Pre-LN (eps 1e-6) windowed or global attention; on a dim change the
    shortcut is the (pooled) ``proj`` of the normalized input; the window
    shrinks by the stride on q-pool blocks; LN and an exact-GELU MLP
    (``mlp0``, ``mlp1``)."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, window_size: int = 0,
                 q_stride: int = 0):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.window_size, self.q_stride = window_size, q_stride
        self.norm1 = LayerNorm(dim)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)
        self.attn = HieraMSA(dim, dim_out, num_heads, q_stride)
        self.norm2 = LayerNorm(dim_out)
        self.mlp0 = nn.Linear(dim_out, 4 * dim_out)
        self.mlp1 = nn.Linear(4 * dim_out, dim_out)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(x)
            if self.q_stride:
                shortcut = max_pool_nhwc(shortcut, self.q_stride)
        ws = self.window_size
        H, W = x.shape[1:3]
        if ws > 0:
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if self.q_stride:
            ws = ws // self.q_stride
            H, W = shortcut.shape[1:3]
            pad_h = (ws - H % ws) % ws if ws else 0
            pad_w = (ws - W % ws) % ws if ws else 0
            pad_hw = (H + pad_h, W + pad_w)
        if self.window_size > 0:
            x = window_unpartition(x, ws, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp1(F.gelu(self.mlp0(self.norm2(x))))


class Hiera(Module):
    """The hierarchical ViT trunk: a 7 x 7 / 4 patch conv, ``pos_embed``
    (bicubic to the grid) plus the tiled ``pos_embed_window``, one flat
    block list with q-pool at the first block of stages 2-4, the window
    spec lagging one block behind the stage, global attention at
    ``global_att_blocks``. (B, H, W, 3) -> the four stage maps (strides 4,
    8, 16, 32)."""

    def __init__(self, embed_dim: int = 96, num_heads: int = 1, stages: tuple = (1, 2, 7, 2),
                 window_spec: tuple = (8, 4, 14, 7), global_att_blocks: tuple = (5, 7, 9),
                 q_pool: int = 3, q_stride: int = 2, bkg_pos_size: tuple = (14, 14)):
        super().__init__()
        self.patch_embed = nn.Conv2d(3, embed_dim, 7, 4, 3)
        self.pos_embed = nn.Parameter(torch.zeros(1, *bkg_pos_size, embed_dim))
        self.pos_embed_window = nn.Parameter(
            torch.zeros(1, window_spec[0], window_spec[0], embed_dim))
        stage_ends = [sum(stages[:i + 1]) - 1 for i in range(len(stages))]
        q_pool_blocks = [e + 1 for e in stage_ends[:-1]][:q_pool]
        self.stage_ends, self.n_blocks = stage_ends, sum(stages)
        dim, heads, cur_stage = embed_dim, num_heads, 1
        for i in range(self.n_blocks):
            window_size = window_spec[cur_stage - 1]  # lags by a block
            if global_att_blocks and i in global_att_blocks:
                window_size = 0
            dim_out = dim
            if i - 1 in stage_ends:
                dim_out, heads, cur_stage = dim * 2, heads * 2, cur_stage + 1
            setattr(self, f"b{i}", HieraBlock(dim, dim_out, heads, window_size,
                                              q_stride if i in q_pool_blocks else 0))
            dim = dim_out
        self.channels = [embed_dim * 2 ** i for i in range(len(stages))]

    def init_params(self, g):
        super().init_params(g)
        normal_(self.pos_embed, 0.02, g)
        normal_(self.pos_embed_window, 0.02, g)

    def forward(self, x):
        x = conv_nhwc(self.patch_embed, x)
        h, w = x.shape[1:3]
        win = self.pos_embed_window
        pe = bicubic_resize(self.pos_embed, h, w)
        x = x + (pe + win.repeat(1, h // win.shape[1], w // win.shape[2], 1))
        outs = []
        for i in range(self.n_blocks):
            x = getattr(self, f"b{i}")(x)
            if i in self.stage_ends:
                outs.append(x)
        return outs


class FpnNeck(Module):
    """1 x 1 laterals to ``d_model`` and the top-down path (nearest 2x, as
    ``jax.image.resize``'s ``nearest``: half-pixel source indices)."""

    def __init__(self, channels: list, d_model: int = 256):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            setattr(self, f"lateral{i}", nn.Conv2d(c, d_model, 1))

    def forward(self, feats):
        out = [None] * self.n
        prev = None
        for i in reversed(range(self.n)):
            top = conv_nhwc(getattr(self, f"lateral{i}"), feats[i])
            if prev is not None:
                top = top + F.interpolate(prev.permute(0, 3, 1, 2), size=top.shape[1:3],
                                          mode="nearest-exact").permute(0, 2, 3, 1)
            prev = out[i] = top
        return out


def sine_pe_2d(h: int, w: int, dim: int, device=None) -> torch.Tensor:
    """The (H, W, dim) sine positional embedding: y's sin and cos, then x's."""
    half = dim // 2
    ar = torch.arange(half // 2, device=device, dtype=torch.float32)
    freq = torch.exp(-math.log(10000.0) * (ar / (half // 2)))
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None] * freq[None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[:, None] * freq[None]
    pe_y = torch.cat([torch.sin(ys), torch.cos(ys)], -1)  # (H, half)
    pe_x = torch.cat([torch.sin(xs), torch.cos(xs)], -1)  # (W, half)
    return torch.cat([pe_y[:, None].expand(h, w, half), pe_x[None].expand(h, w, half)], -1)


class SDPAttention(MultiHeadAttention):
    """flax's ``MultiHeadDotProductAttention`` through
    ``F.scaled_dot_product_attention``: the same parameters, ``mask`` (B,
    Sk) True = attend, an additive ``finfo.min`` bias where False (flax's
    masked logit), so the (B, NH, Sq, Sk) scores are never stored."""

    def forward(self, q, k, v, mask=None):
        b, sq, d = q.shape
        nh = self.num_heads

        def heads(x, lin):
            return lin(x).reshape(b, x.shape[1], nh, -1).transpose(1, 2)

        bias = None
        if mask is not None:
            bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device).masked_fill(
                ~mask, torch.finfo(q.dtype).min)[:, None, None, :]
        y = F.scaled_dot_product_attention(heads(q, self.query), heads(k, self.key),
                                           heads(v, self.value), attn_mask=bias)
        return self.out(y.transpose(1, 2).reshape(b, sq, d))


class MemoryAttentionLayer(Module):
    """Self-attention on the frame's tokens, ``mem_proj`` of the memory,
    cross-attention into it under the validity mask, an 8x MLP; post-LNs."""

    def __init__(self, dim: int = 256, num_heads: int = 8, kv_dim: int = 64):
        super().__init__()
        self.self_attn = SDPAttention(dim, num_heads)
        self.n1 = LayerNorm(dim)
        self.mem_proj = nn.Linear(kv_dim, dim)
        self.cross_attn = SDPAttention(dim, num_heads)
        self.n2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, dim, dim * 8)
        self.n3 = LayerNorm(dim)

    def forward(self, x, x_pe, mem, mem_pe, mem_mask):
        q = x + x_pe
        x = self.n1(x + self.self_attn(q, q, x))
        memk = self.mem_proj(mem + mem_pe)
        x = self.n2(x + self.cross_attn(x + x_pe, memk, memk, mask=mem_mask))
        return self.n3(x + self.mlp(x))


class MemoryAttention(Module):
    def __init__(self, dim: int = 256, depth: int = 4, kv_dim: int = 64):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"layer{i}", MemoryAttentionLayer(dim, kv_dim=kv_dim))
        self.norm = LayerNorm(dim)

    def forward(self, x, x_pe, mem, mem_pe, mem_mask):
        for i in range(self.depth):
            x = getattr(self, f"layer{i}")(x, x_pe, mem, mem_pe, mem_mask)
        return self.norm(x)


class MemoryEncoder(Module):
    """The sigmoid mask through three stride-2 convs (LN, tanh GELU), nearest
    to the feature grid, ``feat_proj + mask_proj``, two depthwise/pointwise
    fuser steps, ``out_proj`` to ``mem_dim``."""

    def __init__(self, d_model: int = 256, mem_dim: int = 64):
        super().__init__()
        cin = 1
        for i, ch in enumerate((4, 16, 64)):
            setattr(self, f"ds{i}", nn.Conv2d(cin, ch, 3, 2, 1))
            setattr(self, f"ds_ln{i}", LayerNorm(ch))
            cin = ch
        self.feat_proj = nn.Conv2d(d_model, d_model, 1)
        self.mask_proj = nn.Conv2d(cin, d_model, 1)
        for i in range(2):
            setattr(self, f"fuse_dw{i}", nn.Conv2d(d_model, d_model, 3, padding=1,
                                                   groups=d_model))
            setattr(self, f"fuse_ln{i}", LayerNorm(d_model))
            setattr(self, f"fuse_pw{i}", nn.Conv2d(d_model, d_model, 1))
        self.out_proj = nn.Conv2d(d_model, mem_dim, 1)

    def forward(self, feat, mask):
        """feat (B, H, W, C) stride-16 features; mask (B, 4H, 4W) logits ->
        (B, H, W, mem_dim)."""
        m = torch.sigmoid(mask)[..., None]
        for i in range(3):
            m = gelu(getattr(self, f"ds_ln{i}")(conv_nhwc(getattr(self, f"ds{i}"), m)))
        m = F.interpolate(m.permute(0, 3, 1, 2), size=feat.shape[1:3],
                          mode="nearest-exact").permute(0, 2, 3, 1)
        x = conv_nhwc(self.feat_proj, feat) + conv_nhwc(self.mask_proj, m)
        for i in range(2):
            h = conv_nhwc(getattr(self, f"fuse_dw{i}"), x)
            x = x + conv_nhwc(getattr(self, f"fuse_pw{i}"), getattr(self, f"fuse_ln{i}")(h))
        return conv_nhwc(self.out_proj, x)


class SAM2(Module):
    """Hiera + FPN image encoder (decoding from the stride-16 map),
    memory-conditioned mask decoding and the memory encoder; a ring of
    ``num_maskmem`` memory slots (1 conditioning + M-1 recent)."""

    def __init__(self, img_size: int = 512, d_model: int = 256, mem_dim: int = 64,
                 num_maskmem: int = 7, embed_dim: int = 96,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.img_size, self.d_model, self.mem_dim = img_size, d_model, mem_dim
        self.num_maskmem = num_maskmem
        with dev:
            self.trunk = Hiera(embed_dim=embed_dim)
            self.neck = FpnNeck(self.trunk.channels, d_model)
            self.prompt_encoder = PromptEncoder(embed_dim=d_model)
            self.mask_decoder = MaskDecoder(dim=d_model)
            self.memory_attention = MemoryAttention(d_model, kv_dim=mem_dim)
            self.memory_encoder = MemoryEncoder(d_model, mem_dim)
            self.maskmem_tpos_enc = nn.Parameter(torch.zeros(num_maskmem, mem_dim))
            self.no_mem_embed = nn.Parameter(torch.zeros(d_model))
        init_tree(self, seed, dev)
        self.eval()

    def init_params(self, g):
        nn.init.zeros_(self.maskmem_tpos_enc)
        normal_(self.no_mem_embed, 0.02, g)

    def encode_image(self, x):
        """(B, H, W, 3) -> the stride-16 FPN map (B, H/16, W/16, d_model)."""
        return self.neck(self.trunk(x))[2]

    def _condition(self, feat, mem_bank, mem_age, mem_valid):
        """feat (B, h, w, C) cross-attended into the bank (B, M, h w,
        mem_dim) under its ages (B, M) and validity (B, M); a row with no
        valid slot gets ``feat + no_mem_embed``."""
        b, h, w, c = feat.shape
        m, dev = mem_bank.shape[1], feat.device
        x = feat.reshape(b, h * w, c)
        x_pe = sine_pe_2d(h, w, c, dev).reshape(1, h * w, c)
        tpos = self.maskmem_tpos_enc[mem_age.clamp(0, self.num_maskmem - 1).long()]
        mem = (mem_bank + tpos[:, :, None, :]).reshape(b, m * h * w, self.mem_dim)
        mem_pe = sine_pe_2d(h, w, self.mem_dim, dev).reshape(1, 1, h * w, self.mem_dim)
        mem_pe = mem_pe.expand(b, m, h * w, self.mem_dim).reshape(b, m * h * w, self.mem_dim)
        mask = mem_valid.repeat_interleave(h * w, 1)
        cond = self.memory_attention(x, x_pe, mem, mem_pe, mask)
        x = torch.where(mem_valid.any(1)[:, None, None], cond, x + self.no_mem_embed)
        return x.reshape(b, h, w, c)

    def decode(self, feat, points=None, labels=None, boxes=None):
        h, w = feat.shape[1:3]
        pe = self.prompt_encoder
        sparse = pe(points, labels, boxes, img_size=float(self.img_size))
        dense = pe.no_mask_embed[None, None, None].expand(feat.shape)
        return self.mask_decoder(feat, pe.dense_pe(h, w), sparse, dense)

    def forward(self, x, points=None, labels=None, boxes=None):
        return self.decode(self.encode_image(x), points, labels, boxes)

    def track_step(self, x, mem_bank, mem_age, mem_valid, points=None, labels=None):
        """One video frame: encode, condition on the memory, decode, encode
        the best mask (argmax IoU, the first on ties) into a new memory ->
        (masks, iou, new_memory (B, h w, mem_dim)). The best mask is already
        at 4h x 4w, where JAX's bilinear resize is the identity."""
        feat = self.encode_image(x)
        cond = self._condition(feat, mem_bank, mem_age, mem_valid)
        masks, iou = self.decode(cond, points, labels)
        best = iou.argmax(-1)
        sel = masks[torch.arange(masks.shape[0], device=masks.device), best]
        new_mem = self.memory_encoder(feat, sel)
        b, h, w, _ = new_mem.shape
        return masks, iou, new_mem.reshape(b, h * w, self.mem_dim)


class SAM2Predictor(SAMPredictor):
    """Static-image SAM2 prompting: ``SAMPredictor``'s ``set_image`` /
    ``predict`` over the Hiera encoder."""

    def __init__(self, model: SAM2 | None = None, img_size: int = 512,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__(model if model is not None else SAM2(img_size=img_size, device=device,
                                                              seed=seed),
                         img_size=img_size)


class SAM2VideoPredictor:
    """Streaming video predictor with one fixed-shape track step:
    ``p.init_state()``, then ``p.track(frame, points=...)`` on the prompt
    frame and ``p.track(frame)`` after; each returns the best mask's logits
    (h, w) at a quarter of the model size, on the host."""

    def __init__(self, model: SAM2 | None = None, img_size: int = 512,
                 device: str | torch.device = "cuda", seed: int = 0):
        self.model = model if model is not None else SAM2(img_size=img_size, device=device,
                                                          seed=seed)
        self.device = model_device(self.model)
        self.img_size = img_size
        self._state = None

    def init_state(self, batch: int = 1):
        m, dev = self.model.num_maskmem, self.device
        hw = (self.img_size // 16) ** 2
        self._state = dict(
            bank=torch.zeros((batch, m, hw, self.model.mem_dim), dtype=torch.float32, device=dev),
            age=torch.zeros((batch, m), dtype=torch.int32, device=dev),
            valid=torch.zeros((batch, m), dtype=torch.bool, device=dev),
            ptr=0)
        return self

    def _prep(self, frame: np.ndarray) -> torch.Tensor:
        """uint8 HWC -> (1, S, S, 3) in [0, 1] on the device: cv2-linear
        stretched to S x S (``imgproc.resize``)."""
        from .data.imgproc import resize

        f = resize(frame, (self.img_size, self.img_size))
        return torch.from_numpy(f).to(self.device)[None].float() / 255.0

    @torch.inference_mode()
    def step(self, x: torch.Tensor, points=None, point_labels=None, frame_shape=None):
        """The device part of ``track``: the track step on ``x`` and the
        ring update; returns (masks, iou) on the device."""
        s = self._state
        p = lab = None
        if points is not None:
            scale = self.img_size / max(frame_shape[:2])
            p = torch.from_numpy(np.asarray(points, np.float32) * scale).to(self.device)[None]
            lab = torch.as_tensor(np.asarray(
                point_labels if point_labels is not None else np.ones(len(points)))).to(
                self.device)[None]
        masks, iou, new_mem = self.model.track_step(x, s["bank"], s["age"], s["valid"], p, lab)
        # ring-buffer update (slot 0 = the conditioning frame, kept for good)
        m = self.model.num_maskmem
        ptr = 1 + (s["ptr"] % (m - 1)) if bool(s["valid"][0, 0]) else 0
        s["bank"][:, ptr] = new_mem
        s["age"] = torch.clamp(s["age"] + 1, max=m - 1)
        s["age"][:, ptr] = 0
        s["valid"][:, ptr] = True
        s["ptr"] = s["ptr"] + 1 if ptr != 0 else 0
        return masks, iou

    def track(self, frame: np.ndarray, points=None, point_labels=None) -> np.ndarray:
        """Track into the next frame; points only on prompt frames (scaled
        by S / max(h, w)). Returns the best mask (h, w) float logits."""
        assert self._state is not None, "call init_state first"
        masks, iou = self.step(self._prep(frame), points, point_labels, frame.shape)
        best = int(np.argmax(iou[0].cpu().numpy()))
        return masks[0, best].cpu().numpy()


# ---------------------------------------------------------------------------
# MobileSAM's tiny encoder
# ---------------------------------------------------------------------------


class TinyViTBlock(Module):
    """Windowed attention whose query is normalized (``ln``) and whose keys
    and values are not, a depthwise ``local_conv``, then LN and the MLP."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7):
        super().__init__()
        self.window_size = window_size
        self.attn = MultiHeadAttention(dim, num_heads)
        self.ln = LayerNorm(dim)
        self.local_conv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)
        self.mlp = MLPBlock(dim, dim, dim * 4)
        self.ln2 = LayerNorm(dim)

    def forward(self, x):
        b, h, w, c = x.shape
        ws = self.window_size
        xw, hw_pad = window_partition(x, ws)
        seq = xw.reshape(xw.shape[0], ws * ws, c)
        seq = self.attn(self.ln(seq), seq, seq)
        x = x + window_unpartition(seq.reshape(-1, ws, ws, c), ws, hw_pad, (h, w))
        x = x + conv_nhwc(self.local_conv, x)
        return x + self.mlp(self.ln2(x))


class TinyViT(Module):
    """MobileSAM's image encoder: a conv stem, three attention stages and
    the SAM neck. (B, H, W, 3) -> (B, H/16, W/16, out_chans)."""

    def __init__(self, dims: tuple = (64, 128, 160), depths: tuple = (2, 2, 4),
                 num_heads: tuple = (2, 4, 5), out_chans: int = 256,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.depths = depths
        with dev:
            self.stem0 = nn.Conv2d(3, dims[0] // 2, 3, 2, 1)
            self.stem1 = nn.Conv2d(dims[0] // 2, dims[0], 3, 2, 1)
            for si, (dim, depth, heads) in enumerate(zip(dims, depths, num_heads)):
                if si > 0:
                    setattr(self, f"down{si}", nn.Conv2d(dims[si - 1], dim, 3, 2, 1))
                for bi in range(depth):
                    setattr(self, f"s{si}b{bi}", TinyViTBlock(dim, heads))
            self.neck0 = nn.Conv2d(dims[-1], out_chans, 1, bias=False)
            self.neck_ln0 = LayerNorm(out_chans)
            self.neck1 = nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False)
            self.neck_ln1 = LayerNorm(out_chans)
        init_tree(self, seed, dev)
        self.eval()

    def forward(self, x):
        x = conv_nhwc(self.stem1, gelu(conv_nhwc(self.stem0, x)))
        for si, depth in enumerate(self.depths):
            if si > 0:
                x = conv_nhwc(getattr(self, f"down{si}"), x)
            for bi in range(depth):
                x = getattr(self, f"s{si}b{bi}")(x)
        x = self.neck_ln0(conv_nhwc(self.neck0, x))
        return self.neck_ln1(conv_nhwc(self.neck1, x))


def build_sam(variant: str = "vit_b", img_size: int = 1024,
              device: str | torch.device = "cuda", seed: int = 0):
    """``vit_b`` / ``vit_l`` / ``vit_h`` (global attention at (2, 5, 8, 11)
    and dim // 64 heads whatever the depth, as in JAX), ``mobile_sam`` (the
    JAX ``SAM(encoder_dim=256, encoder_depth=2)``), ``sam2*`` (``SAM2``);
    ``ValueError`` otherwise."""
    if variant in ("vit_b", "vit_l", "vit_h"):
        dim, depth = {"vit_b": (768, 12), "vit_l": (1024, 24), "vit_h": (1280, 32)}[variant]
        return SAM(img_size=img_size, encoder_dim=dim, encoder_depth=depth, device=device,
                   seed=seed)
    if variant == "mobile_sam":
        return SAM(img_size=img_size, encoder_dim=256, encoder_depth=2, device=device, seed=seed)
    if variant.startswith("sam2"):
        return SAM2(img_size=img_size, device=device, seed=seed)
    raise ValueError(f"unknown SAM variant {variant!r}")

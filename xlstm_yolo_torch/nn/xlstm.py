"""xLSTM block stack and language model in torch.

Port of ``xlstm_yolo_tpu/nn/xlstm.py``: CausalConv1d, sLSTMLayer,
mLSTMLayer1d, GatedFeedForward, xLSTMBlock, xLSTMBlockStack, xLSTMLMModel
and ``generate``. Sequences are (B, S, D). Submodule and parameter names
follow the JAX tree (``conv1d/conv``, ``igate``, ``fgate``, ``zgate``,
``ogate``, ``recurrent_kernel``, ``bias``, ``group_norm``, ``proj_up``,
``q_proj``, ``k_proj``, ``v_proj``, ``mlstm_cell``, ``learnable_skip``,
``proj_down``, ``norm_xlstm``, ``xlstm``, ``norm_ffn``, ``ffn``,
``block{i}``, ``post_norm``, ``stack``, ``embedding``, ``lm_head``), so
``utils.jax_weights.load_jax_variables`` fills a model from a JAX variable
tree.

The two recurrences run through the port's kernels: every mLSTM block calls
``kernels.mlstm_fwd.mlstm_chunkwise_fwd`` (inside ``MatrixLSTMCell``) and
every sLSTM block ``kernels.slstm.slstm_scan_fwd`` — hand-written CUDA on the
GPU, their plain versions on the CPU. The dense projections, the 4x4
headwise projections, the causal conv, the FFN and the LM head are torch
ops. The model serves (forward and ``generate``) and trains with either
kind of block, at every cell head dim the chunkwise kernels take (64, 128,
256) and every sLSTM head dim the sLSTM kernels take (32, 64, 128). Under
autograd on the GPU the chunkwise forward kernel has the chunkwise backward
kernel bound as its backward, and the sLSTM kernel the reverse-time sLSTM
kernel. One train step is forward -> ``utils.loss.lm_loss`` ->
``backward()`` -> ``utils.train_utils.StepUpdate``; the JAX package has no
trainer for the language model, and the port adds none.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.slstm import powerlaw_blockdependent_bias, slstm_scan_fwd
from ..utils import resolve_device
from .modules import init_tree, lecun_normal_, small_init_, wang_init_
from .vil import LayerNorm, LinearHeadwiseExpand, MatrixLSTMCell, MultiHeadLayerNorm


def _round_up_proj(dim: int, factor: float, multiple: int = 64) -> int:
    """Up-projection width: ``dim * factor`` rounded up to a multiple of 64."""
    return int(math.ceil(dim * factor / multiple) * multiple)


class CausalConv1d(nn.Module):
    """Depthwise causal conv over time on (B, S, D); kernel size 0 is the
    identity."""

    def __init__(self, feature_dim: int, kernel_size: int = 4):
        super().__init__()
        self.kernel_size = kernel_size
        if kernel_size > 0:
            self.conv = nn.Conv1d(feature_dim, feature_dim, kernel_size, groups=feature_dim)

    def init_params(self, g: torch.Generator) -> None:
        if self.kernel_size > 0:
            lecun_normal_(self.conv.weight, g)
            nn.init.zeros_(self.conv.bias)

    def forward(self, x):
        if self.kernel_size == 0:
            return x
        xp = F.pad(x.transpose(1, 2), (self.kernel_size - 1, 0))
        return self.conv(xp).transpose(1, 2)


class sLSTMLayer(nn.Module):
    """conv -> headwise i/f gates (from the conv branch) and z/o gates (from
    the raw input) -> sLSTM scan -> per-head group norm."""

    def __init__(self, embedding_dim: int, num_heads: int = 4, conv1d_kernel_size: int = 4,
                 block_idx: int = 0, num_blocks: int = 1):
        super().__init__()
        D, NH = embedding_dim, num_heads
        self.num_heads, self.head_dim = NH, D // NH
        self.block_idx, self.num_blocks = block_idx, num_blocks
        self.conv1d = CausalConv1d(D, conv1d_kernel_size) if conv1d_kernel_size > 0 else None
        self.igate = LinearHeadwiseExpand(D, NH, use_bias=False)
        self.fgate = LinearHeadwiseExpand(D, NH, use_bias=False)
        self.zgate = LinearHeadwiseExpand(D, NH, use_bias=False)
        self.ogate = LinearHeadwiseExpand(D, NH, use_bias=False)
        self.recurrent_kernel = nn.Parameter(torch.zeros(NH, self.head_dim, 4, self.head_dim))
        self.bias = nn.Parameter(torch.zeros(NH, 4, self.head_dim))
        self.group_norm = MultiHeadLayerNorm(NH, D, eps=1e-5, with_bias=False)

    def init_params(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.recurrent_kernel.zero_()
            self.bias.zero_()
            self.bias[:, 1] = powerlaw_blockdependent_bias(
                self.num_heads, self.head_dim, self.block_idx, self.num_blocks)

    def forward(self, x, initial_state=None, return_last_state: bool = False):
        B, S, D = x.shape
        NH, DH = self.num_heads, self.head_dim
        x_conv = F.silu(self.conv1d(x)) if self.conv1d is not None else x
        gates = (self.igate(x_conv), self.fgate(x_conv), self.zgate(x), self.ogate(x))
        wx = torch.stack([t.reshape(B, S, NH, DH) for t in gates], dim=3)  # (B, S, NH, 4, DH)
        out = slstm_scan_fwd(wx, self.recurrent_kernel, self.bias, initial_state=initial_state,
                             return_last_state=return_last_state)
        y, last = out if return_last_state else (out, None)
        y = self.group_norm(y.transpose(1, 2)).transpose(1, 2).reshape(B, S, D).to(x.dtype)
        return (y, last) if return_last_state else y


class mLSTMLayer1d(nn.Module):
    """Causal mLSTM mixing layer: proj_up -> split -> causal conv -> headwise
    q, k (from the conv branch) and v (from the raw branch) -> mLSTM cell ->
    learnable skip and SiLU(z) gate -> proj_down. The headwise projections
    have ``inner // qkv_proj_blocksize`` small heads; the cell runs its own
    ``num_heads`` wide ones."""

    def __init__(self, embedding_dim: int, num_heads: int = 4, expansion: float = 2.0,
                 qkv_proj_blocksize: int = 4, conv1d_kernel_size: int = 4, chunk_size: int = 64,
                 num_blocks: int = 1):
        super().__init__()
        D = embedding_dim
        inner = _round_up_proj(D, expansion)
        proj_heads = inner // qkv_proj_blocksize
        self.embedding_dim, self.inner, self.num_blocks = D, inner, num_blocks
        self.proj_up = nn.Linear(D, 2 * inner, bias=False)
        self.conv1d = CausalConv1d(inner, conv1d_kernel_size)
        self.q_proj = LinearHeadwiseExpand(inner, proj_heads, use_bias=False)
        self.k_proj = LinearHeadwiseExpand(inner, proj_heads, use_bias=False)
        self.v_proj = LinearHeadwiseExpand(inner, proj_heads, use_bias=False)
        self.mlstm_cell = MatrixLSTMCell(inner, num_heads, norm_eps=1e-5, chunk_size=chunk_size,
                                         norm_bias=False, igate_init="xlstm")
        self.learnable_skip = nn.Parameter(torch.ones(inner))
        self.proj_down = nn.Linear(inner, D, bias=False)

    def init_params(self, g: torch.Generator) -> None:
        small_init_(self.proj_up.weight, self.embedding_dim, g)
        wang_init_(self.proj_down.weight, self.embedding_dim, self.num_blocks, g)
        nn.init.ones_(self.learnable_skip)

    def forward(self, x):
        x_m, z = self.proj_up(x).split(self.inner, dim=-1)
        conv_act = F.silu(self.conv1d(x_m))
        h = self.mlstm_cell(self.q_proj(conv_act), self.k_proj(conv_act), self.v_proj(x_m))
        h = (h + self.learnable_skip * conv_act) * F.silu(z)
        return self.proj_down(h)


# the JAX GatedFeedForward's act_fn table; gelu is the tanh-approximated form
# (the default of flax's ``nn.gelu``; torch's ``F.gelu`` defaults to the exact one)
FFN_ACTS = {
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
    "relu": F.relu,
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "selu": F.selu,
    "relu^2": lambda v: F.relu(v).square(),
}


class GatedFeedForward(nn.Module):
    """Gated FFN: proj_up to (gate, up), act(gate) * up, proj_down, with
    ``act_fn`` one of ``FFN_ACTS`` (gelu by default; "swish" gives the
    SwiGLU form)."""

    def __init__(self, embedding_dim: int, proj_factor: float = 1.3, num_blocks: int = 1,
                 act_fn: str = "gelu"):
        super().__init__()
        if act_fn not in FFN_ACTS:
            raise ValueError(f"unknown act_fn {act_fn!r}; one of {sorted(FFN_ACTS)}")
        self.embedding_dim, self.num_blocks, self.act = embedding_dim, num_blocks, FFN_ACTS[act_fn]
        self.up = _round_up_proj(embedding_dim, proj_factor)
        self.proj_up = nn.Linear(embedding_dim, 2 * self.up, bias=False)
        self.proj_down = nn.Linear(self.up, embedding_dim, bias=False)

    def init_params(self, g: torch.Generator) -> None:
        small_init_(self.proj_up.weight, self.embedding_dim, g)
        wang_init_(self.proj_down.weight, self.embedding_dim, self.num_blocks, g)

    def forward(self, x):
        gate, up = self.proj_up(x).split(self.up, dim=-1)
        return self.proj_down(self.act(gate) * up)


class xLSTMBlock(nn.Module):
    """Pre-norm residual block: an mLSTM or sLSTM layer, plus a gated FFN
    when ``ffn_proj_factor`` > 0."""

    def __init__(self, embedding_dim: int, kind: str = "mlstm", num_heads: int = 4,
                 conv1d_kernel_size: int = 4, qkv_proj_blocksize: int = 4, chunk_size: int = 64,
                 ffn_proj_factor: float = 0.0, block_idx: int = 0, num_blocks: int = 1):
        super().__init__()
        if kind not in ("mlstm", "slstm"):
            raise ValueError(f"unknown block kind {kind!r}")
        self.norm_xlstm = LayerNorm(embedding_dim)
        if kind == "mlstm":
            self.xlstm = mLSTMLayer1d(embedding_dim, num_heads=num_heads,
                                      qkv_proj_blocksize=qkv_proj_blocksize,
                                      conv1d_kernel_size=conv1d_kernel_size,
                                      chunk_size=chunk_size, num_blocks=num_blocks)
        else:
            self.xlstm = sLSTMLayer(embedding_dim, num_heads=num_heads,
                                    conv1d_kernel_size=conv1d_kernel_size, block_idx=block_idx,
                                    num_blocks=num_blocks)
        self.ffn = None
        if ffn_proj_factor > 0:
            self.norm_ffn = LayerNorm(embedding_dim)
            self.ffn = GatedFeedForward(embedding_dim, ffn_proj_factor, num_blocks=num_blocks)

    def forward(self, x):
        x = x + self.xlstm(self.norm_xlstm(x))
        if self.ffn is not None:
            x = x + self.ffn(self.norm_ffn(x))
        return x


class xLSTMBlockStack(nn.Module):
    """``num_blocks`` blocks, sLSTM at the indices in ``slstm_at`` (those get
    the FFN) and mLSTM elsewhere (no FFN), then a LayerNorm."""

    def __init__(self, embedding_dim: int, num_blocks: int = 6, slstm_at: tuple = (),
                 num_heads: int = 4, qkv_proj_blocksize: int = 4, conv1d_kernel_size: int = 4,
                 chunk_size: int = 64, ffn_proj_factor: float = 1.3, add_post_norm: bool = True):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            kind = "slstm" if i in slstm_at else "mlstm"
            self.add_module(f"block{i}", xLSTMBlock(
                embedding_dim, kind=kind, num_heads=num_heads,
                conv1d_kernel_size=conv1d_kernel_size, qkv_proj_blocksize=qkv_proj_blocksize,
                chunk_size=chunk_size, ffn_proj_factor=ffn_proj_factor if kind == "slstm" else 0.0,
                block_idx=i, num_blocks=num_blocks))
        self.post_norm = LayerNorm(embedding_dim) if add_post_norm else None

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x if self.post_norm is None else self.post_norm(x)


class xLSTMLMModel(nn.Module):
    """Token embedding -> block stack -> tied or untied LM head.
    ``xLSTMLMModel(50304, slstm_at=(1,), num_blocks=7, device="cuda")``: the
    model on ``device`` in eval mode, weights drawn from ``seed`` with the
    JAX package's init scheme. ``forward`` takes (B, S) token ids and
    returns (B, S, vocab) logits."""

    def __init__(self, vocab_size: int, embedding_dim: int = 128, num_blocks: int = 6,
                 slstm_at: tuple = (), num_heads: int = 4, chunk_size: int = 64,
                 tie_weights: bool = False, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.vocab_size, self.embedding_dim = vocab_size, embedding_dim
        self.embedding = nn.Embedding(vocab_size, embedding_dim)
        self.stack = xLSTMBlockStack(embedding_dim, num_blocks=num_blocks,
                                     slstm_at=tuple(slstm_at), num_heads=num_heads,
                                     chunk_size=chunk_size)
        self.lm_head = None if tie_weights else nn.Linear(embedding_dim, vocab_size, bias=False)
        self.init_weights(seed)
        self.eval()
        self.to(dev)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Re-initialize every parameter, drawing from a generator seeded
        with ``seed``."""
        g = init_tree(self, seed)
        self.embedding.weight.normal_(0.0, 1.0 / math.sqrt(self.embedding_dim), generator=g)
        if self.lm_head is not None:
            lecun_normal_(self.lm_head.weight, g)

    def forward(self, tokens):
        x = self.stack(self.embedding(tokens))
        if self.lm_head is None:
            return x @ self.embedding.weight.t()
        return self.lm_head(x)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


@torch.no_grad()
def generate(model: xLSTMLMModel, prompt, max_new_tokens: int = 20, temperature: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """Greedy (``temperature`` 0) or sampled autoregressive generation.
    ``prompt`` holds token ids, (S,) or (B, S); returns the ids with
    ``max_new_tokens`` appended along the last dim, on the model's device.

    Every new token re-forwards the whole sequence (the model keeps no
    state cache on this path), so the cost grows with the square of the
    length; fine for short continuations. Sampling draws from ``generator``
    (one on the model's device, seeded 0, when none is given), never from
    the global random state."""
    dev = next(model.parameters()).device
    tokens = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    single = tokens.dim() == 1
    if single:
        tokens = tokens[None]
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    for _ in range(max_new_tokens):
        logits = model(tokens)[:, -1].float()
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)
        else:
            nxt = logits.argmax(dim=-1, keepdim=True)
        tokens = torch.cat([tokens, nxt], dim=1)
    return tokens[0] if single else tokens

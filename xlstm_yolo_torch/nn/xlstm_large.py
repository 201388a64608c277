"""xLSTM-7B ("xLSTM Large") text model in torch.

Port of ``xlstm_yolo_tpu/nn/xlstm_large.py``: ``FeedForwardLM``,
``mLSTMTextLayer``, ``mLSTMTextBlock``, ``xLSTMLarge``, the prefill-and-step
``generate``, the device-side decode ``generate_scan`` and a local-directory
``from_pretrained``. Sequences are (B, S, D). Submodule and parameter names
follow the JAX tree (``embedding``, ``blocks_{i}``, ``norm_mlstm``,
``mlstm_layer``, ``q``, ``k``, ``v``, ``ogate_preact``, ``igate_preact``,
``fgate_preact``, ``multihead_norm``, ``out_proj``, ``norm_ffn``, ``ffn``,
``proj_up_gate``, ``proj_up``, ``proj_down``, ``out_norm``, ``lm_head``), so
``utils.jax_weights.load_jax_variables`` fills a model from a JAX variable
tree.

Structure per block:
    x -> RMSNorm(norm_mlstm) -> mLSTM layer -> +residual
      -> RMSNorm(norm_ffn)   -> gated FFN   -> +residual
mLSTM layer: q, k (qk_dim_factor * D), v and the o-gate from x; soft-capped
scalar i/f gates per head; the mLSTM recurrence with a carried (C, n, m)
state per head (C is (DQK, DV), n (DQK,)); a per-head LayerNorm;
sigmoid(o) * h; out_proj.

The recurrence is plain torch, as the JAX model calls the native forms on
every backend: the chunkwise form when the call's S is above 1 and a multiple
of ``min(chunk_size, S)``, the exact step-by-step form otherwise (odd prompt
lengths and single-token decode). Nothing is padded.

``generate_scan`` runs the decode loop without a host round trip per token:
on a CUDA device the one-token step (token -> embedding -> every block's
recurrent step -> norm -> head -> next token) is captured once in a CUDA
graph on static token, logit and state buffers and replayed per token
(``DecodeGraph``); elsewhere the same step runs eagerly. It returns
``generate``'s tokens.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.mlstm_native import mlstm_chunkwise, mlstm_recurrent, soft_cap
from ..utils import resolve_device
from ..utils.safetensors_np import read_safetensors
from .modules import lecun_normal_
from .vil import MultiHeadLayerNorm, RMSNorm


def _round_up(x: float, multiple: int) -> int:
    """``x`` rounded up to an integer, then up to a multiple of ``multiple``."""
    return -(-math.ceil(x) // multiple) * multiple


class FeedForwardLM(nn.Module):
    """silu(proj_up_gate(x)) * proj_up(x) -> proj_down; the up width is
    ``dim * proj_factor`` rounded up to a multiple of ``round_up_to``."""

    def __init__(self, dim: int, proj_factor: float = 2.6667, round_up_to: int = 64,
                 use_bias: bool = False):
        super().__init__()
        up = _round_up(dim * proj_factor, round_up_to)
        self.proj_up_gate = nn.Linear(dim, up, bias=use_bias)
        self.proj_up = nn.Linear(dim, up, bias=use_bias)
        self.proj_down = nn.Linear(up, dim, bias=use_bias)

    def forward(self, x):
        return self.proj_down(F.silu(self.proj_up_gate(x)) * self.proj_up(x))


class mLSTMTextLayer(nn.Module):
    """The text-domain mLSTM mixing layer. The i/f gate projections keep
    their bias whatever ``use_bias`` says, as in the reference."""

    def __init__(self, dim: int, num_heads: int, qk_dim_factor: float = 0.5,
                 v_dim_factor: float = 1.0, gate_soft_cap: float = 15.0, chunk_size: int = 64,
                 use_bias: bool = False, norm_eps: float = 1e-6):
        super().__init__()
        self.num_heads, self.gate_soft_cap, self.chunk_size = num_heads, gate_soft_cap, chunk_size
        qk_dim, self.v_dim = int(dim * qk_dim_factor), int(dim * v_dim_factor)
        self.q = nn.Linear(dim, qk_dim, bias=use_bias)
        self.k = nn.Linear(dim, qk_dim, bias=use_bias)
        self.v = nn.Linear(dim, self.v_dim, bias=use_bias)
        self.ogate_preact = nn.Linear(dim, self.v_dim, bias=use_bias)
        self.igate_preact = nn.Linear(dim, num_heads)
        self.fgate_preact = nn.Linear(dim, num_heads)
        self.multihead_norm = MultiHeadLayerNorm(num_heads, self.v_dim, eps=norm_eps,
                                                 with_bias=use_bias, residual=False)
        self.out_proj = nn.Linear(self.v_dim, dim, bias=use_bias)

    def forward(self, x, state=None, return_last_state: bool = False):
        B, S, _ = x.shape
        NH = self.num_heads

        def heads(t):  # (B, S, NH * d) -> (B, NH, S, d)
            return t.reshape(B, S, NH, -1).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        i = soft_cap(self.igate_preact(x), self.gate_soft_cap).transpose(1, 2)
        f = soft_cap(self.fgate_preact(x), self.gate_soft_cap).transpose(1, 2)
        cs = min(self.chunk_size, S)
        if S > 1 and S % cs == 0:
            out = mlstm_chunkwise(q, k, v, i, f, chunk_size=cs, initial_state=state,
                                  return_last_state=return_last_state)
        else:
            out = mlstm_recurrent(q, k, v, i, f, initial_state=state,
                                  return_last_state=return_last_state)
        h, last = out if return_last_state else (out, None)
        h = self.multihead_norm(h.to(x.dtype)).transpose(1, 2).reshape(B, S, self.v_dim)
        y = self.out_proj(torch.sigmoid(self.ogate_preact(x)) * h)
        return (y, last) if return_last_state else y


class mLSTMTextBlock(nn.Module):
    """Pre-norm mLSTM layer and gated FFN, each with a residual."""

    def __init__(self, dim: int, num_heads: int, qk_dim_factor: float = 0.5,
                 v_dim_factor: float = 1.0, ffn_proj_factor: float = 2.6667,
                 ffn_round_up_to: int = 64, gate_soft_cap: float = 15.0, chunk_size: int = 64,
                 use_bias: bool = False, norm_eps: float = 1e-6):
        super().__init__()
        self.norm_mlstm = RMSNorm(dim, eps=norm_eps)
        self.mlstm_layer = mLSTMTextLayer(dim, num_heads, qk_dim_factor, v_dim_factor,
                                          gate_soft_cap, chunk_size, use_bias, norm_eps)
        self.norm_ffn = RMSNorm(dim, eps=norm_eps)
        self.ffn = FeedForwardLM(dim, ffn_proj_factor, ffn_round_up_to, use_bias)

    def forward(self, x, state=None, return_last_state: bool = False):
        out = self.mlstm_layer(self.norm_mlstm(x), state=state,
                               return_last_state=return_last_state)
        h, last = out if return_last_state else (out, None)
        x = x + h
        x = x + self.ffn(self.norm_ffn(x))
        return (x, last) if return_last_state else x


class xLSTMLarge(nn.Module):
    """Embedding -> ``num_blocks`` mLSTMTextBlocks -> RMSNorm -> lm_head,
    its logits soft-capped at ``output_logit_soft_cap``.

    ``xLSTMLarge(50304, 4096, 32, 8, device="cuda")`` builds the model on
    ``device`` in eval mode (the modules are made on the meta device and
    then allocated there, so no copy of the weights passes through the
    host) and draws its weights from a generator on that device seeded with
    ``seed``, with the JAX package's initializers: flax ``Dense`` kernels
    lecun-normal truncated, zero biases; ``Embed`` normal with variance
    1 / embedding_dim; norm scales one. ``seed=None`` leaves the weights
    unset, for a loader to fill (``from_pretrained``). The same seed gives
    other weights on another device type (the generators differ).

    ``forward(tokens, state=None, return_last_states=False)``: (B, S) token
    ids -> (B, S, vocab) logits; ``state`` is {block index: (C, n, m)}, as
    ``return_last_states=True`` returns it beside the logits."""

    def __init__(self, vocab_size: int, embedding_dim: int, num_blocks: int, num_heads: int,
                 qk_dim_factor: float = 0.5, v_dim_factor: float = 1.0,
                 ffn_proj_factor: float = 2.6667, ffn_round_up_to: int = 64,
                 gate_soft_cap: float = 15.0, output_logit_soft_cap: float = 30.0,
                 chunk_size: int = 64, use_bias: bool = False, norm_eps: float = 1e-6,
                 device: str | torch.device = "cuda", seed: int | None = 0):
        super().__init__()
        dev = resolve_device(device)
        self.vocab_size, self.embedding_dim, self.num_blocks = vocab_size, embedding_dim, num_blocks
        self.num_heads, self.output_logit_soft_cap = num_heads, output_logit_soft_cap
        self.qk_head_dim = int(embedding_dim * qk_dim_factor) // num_heads
        self.v_head_dim = int(embedding_dim * v_dim_factor) // num_heads
        with torch.device("meta"):
            self.embedding = nn.Embedding(vocab_size, embedding_dim)
            for i in range(num_blocks):
                self.add_module(f"blocks_{i}", mLSTMTextBlock(
                    embedding_dim, num_heads, qk_dim_factor, v_dim_factor, ffn_proj_factor,
                    ffn_round_up_to, gate_soft_cap, chunk_size, use_bias, norm_eps))
            self.out_norm = RMSNorm(embedding_dim, eps=norm_eps)
            self.lm_head = nn.Linear(embedding_dim, vocab_size, bias=False)
        self.to_empty(device=dev)
        if seed is not None:
            self.init_weights(seed)
        self.eval()

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Re-draw every parameter from a generator on the model's device
        seeded with ``seed`` (see the class docstring)."""
        g = torch.Generator(device=self.embedding.weight.device).manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (RMSNorm, MultiHeadLayerNorm)):
                m.scale.fill_(1.0)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
        self.embedding.weight.normal_(0.0, 1.0 / math.sqrt(self.embedding_dim), generator=g)

    def blocks(self):
        return [getattr(self, f"blocks_{i}") for i in range(self.num_blocks)]

    def forward(self, tokens, state=None, return_last_states: bool = False):
        x = self.embedding(tokens)
        new_state = {}
        for i, blk in enumerate(self.blocks()):
            si = None if state is None else state.get(i)
            if return_last_states:
                x, new_state[i] = blk(x, state=si, return_last_state=True)
            else:
                x = blk(x, state=si)
        logits = soft_cap(self.lm_head(self.out_norm(x)), self.output_logit_soft_cap)
        return (logits, new_state) if return_last_states else logits

    def zero_state(self, batch: int) -> dict:
        """{block index: (C, n, m)} of zeros for ``batch`` sequences: C (B,
        NH, DQK, DV), n (B, NH, DQK), m (B, NH), fp32."""
        dev = self.embedding.weight.device
        NH, dqk, dv = self.num_heads, self.qk_head_dim, self.v_head_dim
        return {i: (torch.zeros(batch, NH, dqk, dv, device=dev),
                    torch.zeros(batch, NH, dqk, device=dev), torch.zeros(batch, NH, device=dev))
                for i in range(self.num_blocks)}

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def _tokens(model: xLSTMLarge, prompt) -> torch.Tensor:
    """``prompt`` ((S,) or (B, S) ids) as a (B, S) long tensor on the
    model's device."""
    tokens = torch.as_tensor(prompt, dtype=torch.long, device=model.embedding.weight.device)
    return tokens[None] if tokens.dim() == 1 else tokens


def _pick(last: torch.Tensor, temperature: float, generator) -> torch.Tensor:
    """The next token of each row of ``last`` (B, vocab): the argmax
    (greedy, the first of equal maxima) for ``temperature`` 0, else a draw
    from softmax(last / temperature) by the Gumbel-max rule, as
    ``jax.random.categorical`` draws, with uniforms from ``generator``."""
    if temperature > 0:
        u = torch.rand(last.shape, generator=generator, device=last.device)
        return (last / temperature - torch.log(-torch.log(u))).argmax(dim=-1)
    return last.argmax(dim=-1)


def _generator(model: xLSTMLarge, temperature: float, generator):
    """``generator``, or for sampling without one a generator on the model's
    device seeded 0 (as the JAX functions take ``PRNGKey(0)``)."""
    if temperature > 0 and generator is None:
        return torch.Generator(device=model.embedding.weight.device).manual_seed(0)
    return generator


@torch.no_grad()
def prefill(model: xLSTMLarge, tokens: torch.Tensor):
    """One pass over (B, S) ``tokens``: (the last position's logits (B,
    vocab), the state after it)."""
    logits, state = model(tokens, return_last_states=True)
    return logits[:, -1], state


@torch.no_grad()
def generate(model: xLSTMLarge, prompt, max_new_tokens: int = 20, temperature: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """Prefill, then one recurrent step per new token (O(1) a token, no
    re-forward). Greedy for ``temperature`` 0, else sampled with uniforms
    from ``generator`` (one on the model's device). Returns (B, S +
    max_new_tokens) ids, the prompt first, as the JAX ``generate``."""
    tokens = _tokens(model, prompt)
    generator = _generator(model, temperature, generator)
    last, state = prefill(model, tokens)
    out = [tokens]
    for _ in range(max_new_tokens):
        nxt = _pick(last, temperature, generator)[:, None]
        out.append(nxt)
        logits, state = model(nxt, state=state, return_last_states=True)
        last = logits[:, -1]
    return torch.cat(out, dim=1)


class DecodeGraph:
    """``generate``'s per-token work on static buffers: ``last`` (B, vocab)
    logits, the state {block: (C, n, m)}, ``out`` (B, max_new_tokens) ids
    and the position ``pos``, a device scalar. One ``step`` picks the next
    token from ``last``, writes it to ``out[:, pos]``, runs the model's
    one-token step on it with the state, and copies the new logits and state
    into their buffers in place.

    With ``graph`` (the default on a CUDA device) the step is warmed up on a
    side stream and captured once in a CUDA graph; ``step`` replays it, with
    no host sync. Sampling in a graph takes its uniforms from ``generator``,
    registered with the graph (``CUDAGraph.register_generator_state``;
    a PyTorch without it refuses sampling in a graph). ``reset(last,
    state)`` loads a prefill's result and sets ``pos`` to 0."""

    def __init__(self, model: xLSTMLarge, batch: int, max_new_tokens: int,
                 temperature: float = 0.0, generator: torch.Generator | None = None,
                 graph: bool | None = None):
        dev = model.embedding.weight.device
        self.model, self.temperature = model, float(temperature)
        self.generator = _generator(model, temperature, generator)
        self.max_new_tokens = max_new_tokens
        self.last = torch.zeros(batch, model.vocab_size, device=dev)
        self.state = model.zero_state(batch)
        self.out = torch.zeros(batch, max(max_new_tokens, 1), dtype=torch.long, device=dev)
        self.pos = torch.zeros(1, dtype=torch.long, device=dev)
        self.graph = None
        if dev.type == "cuda" if graph is None else graph:
            self._capture()

    @torch.no_grad()
    def _step(self):
        nxt = _pick(self.last, self.temperature, self.generator)
        self.out.index_copy_(1, self.pos, nxt[:, None])
        logits, state = self.model(nxt[:, None], state=self.state, return_last_states=True)
        self.last.copy_(logits[:, -1])
        for i, buffers in self.state.items():
            for buf, new in zip(buffers, state[i]):
                buf.copy_(new)
        self.pos += 1

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        if self.temperature > 0:
            if not hasattr(graph, "register_generator_state"):
                raise ValueError("sampling inside a CUDA graph needs "
                                 "torch.cuda.CUDAGraph.register_generator_state, which this "
                                 "PyTorch lacks; decode with graph=False")
            graph.register_generator_state(self.generator)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                self.pos.zero_()
                self._step()
        torch.cuda.current_stream().wait_stream(side)
        self.pos.zero_()
        with torch.cuda.graph(graph):
            self._step()
        self.graph = graph

    @torch.no_grad()
    def reset(self, last: torch.Tensor, state: dict) -> None:
        self.last.copy_(last)
        for i, buffers in self.state.items():
            for buf, new in zip(buffers, state[i]):
                buf.copy_(new)
        self.pos.zero_()

    def step(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self._step()

    def run(self) -> torch.Tensor:
        """``max_new_tokens`` steps from the loaded state: (B,
        max_new_tokens) ids."""
        for _ in range(self.max_new_tokens):
            self.step()
        return self.out[:, :self.max_new_tokens]


@torch.no_grad()
def generate_scan(model: xLSTMLarge, prompt, max_new_tokens: int = 20,
                  temperature: float = 0.0,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """The serving decode: prefill, then ``max_new_tokens`` steps of a
    ``DecodeGraph`` (CUDA-graph replays on a CUDA device, eager steps
    elsewhere). The same math and tokens as ``generate``."""
    tokens = _tokens(model, prompt)
    last, state = prefill(model, tokens)
    dec = DecodeGraph(model, tokens.shape[0], max_new_tokens, temperature, generator)
    dec.reset(last, state)
    return torch.cat([tokens, dec.run()], dim=1)


# ---------------------------------------------------------------------------
# local checkpoint import
# ---------------------------------------------------------------------------

NORMS = ("norm_mlstm", "norm_ffn", "multihead_norm", "out_norm")


def _load_state_dict(path: Path) -> dict:
    """The tensors of ``model.safetensors``, else of ``model_{n}.safetensors``
    n = 0, 1, ..., else of the ``model-*-of-*.safetensors`` shards, under
    the directory ``path``."""
    if (path / "model.safetensors").exists():
        return read_safetensors(path / "model.safetensors")
    sd, n = {}, 0
    while (path / f"model_{n}.safetensors").exists():
        sd.update(read_safetensors(path / f"model_{n}.safetensors"))
        n += 1
    if not sd:
        for f in sorted(path.glob("model-*-of-*.safetensors")):
            sd.update(read_safetensors(f))
    if not sd:
        raise FileNotFoundError(f"no model*.safetensors found under {path}")
    return sd


def _load_config(path: Path) -> dict:
    if (path / "config.yaml").exists():
        import yaml

        return yaml.safe_load((path / "config.yaml").read_text())
    if (path / "config.json").exists():
        return json.loads((path / "config.json").read_text())
    raise FileNotFoundError(f"no config.yaml/config.json under {path}")


def port_key(key: str) -> str:
    """A checkpoint's torch key -> the port's parameter name:
    ``backbone.blocks.{i}.`` -> ``blocks_{i}.``, ``backbone.out_norm`` ->
    ``out_norm``, and a norm's ``weight`` -> ``scale``. ``nn.Linear`` weights
    keep their (out, in) layout."""
    if key.startswith("backbone.blocks."):
        i, rest = key[len("backbone.blocks."):].split(".", 1)
        key = f"blocks_{i}.{rest}"
    elif key.startswith("backbone."):
        key = key[len("backbone."):]
    module, _, leaf = key.rpartition(".")
    if leaf == "weight" and module.rpartition(".")[2] in NORMS:
        key = f"{module}.scale"
    return key


@torch.no_grad()
def from_pretrained(checkpoint_path: str | Path, chunk_size: int | None = None,
                    device: str | torch.device = "cuda") -> xLSTMLarge:
    """An ``xLSTMLarge`` on ``device`` holding a LOCAL xLSTM-7B-style
    checkpoint directory: ``config.yaml`` or ``config.json``, and the
    safetensors files ``_load_state_dict`` reads (``utils.safetensors_np``:
    BF16 tensors are widened to fp32 exactly, 8-bit floats refused, as the
    JAX package reads them). The keys are
    renamed by ``port_key``; a key the model lacks, a parameter the
    checkpoint lacks, or a shape that differs from the built model's raises
    a ValueError."""
    path = Path(checkpoint_path)
    cfg = _load_config(path)
    sd = {port_key(k): v for k, v in _load_state_dict(path).items()}
    model = xLSTMLarge(
        vocab_size=int(cfg["vocab_size"]),
        embedding_dim=int(cfg["embedding_dim"]),
        num_blocks=int(cfg["num_blocks"]),
        num_heads=int(cfg["num_heads"]),
        qk_dim_factor=float(cfg.get("qk_dim_factor", 0.5)),
        v_dim_factor=float(cfg.get("v_dim_factor", 1.0)),
        ffn_proj_factor=float(cfg.get("ffn_proj_factor", 2.6667)),
        ffn_round_up_to=int(cfg.get("ffn_round_up_to_multiple_of", 64)),
        gate_soft_cap=float(cfg.get("gate_soft_cap", 15.0)),
        output_logit_soft_cap=float(cfg.get("output_logit_soft_cap", 30.0)),
        chunk_size=int(chunk_size or cfg.get("chunk_size", 64)),
        use_bias=bool(cfg.get("use_bias", False)),
        norm_eps=float(cfg.get("norm_eps", 1e-6)),
        device=device, seed=None)
    params = dict(model.named_parameters())
    missing, extra = sorted(params.keys() - sd.keys()), sorted(sd.keys() - params.keys())
    wrong = [f"{k}: model {tuple(p.shape)}, checkpoint {tuple(sd[k].shape)}"
             for k, p in params.items() if k in sd and tuple(p.shape) != tuple(sd[k].shape)]
    if missing or extra or wrong:
        raise ValueError(f"checkpoint/model mismatch under {path}: missing {missing[:8]}, "
                         f"extra {extra[:8]}, shapes {wrong[:8]}")
    for k, p in params.items():
        p.copy_(torch.from_numpy(sd[k]))
    return model

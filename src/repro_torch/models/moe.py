"""Mixture-of-Experts transformer (qwen2-moe-a2.7b, qwen3-moe-30b-a3b).

The port of the reference's `models/moe.py`. Routing: softmax top-k with
optional shared experts (qwen2-moe: 4 shared + 60 routed top-4; qwen3-moe:
128 routed top-8). Dispatch is SORT-BASED with a fixed per-expert capacity:
token->expert pairs are ranked within their expert by a stable argsort,
gathered into an (E, C, D) buffer, pushed through per-expert batched
products and added back weighted by the router probability. Pairs past an
expert's capacity are dropped, so in decode (cap = 1 for 4 slots) a slot's
output depends on what the other slots, idle ones included, route: the
reference's semantics, kept as they are.

E is padded past the logical expert count where the config says so
(qwen2-moe: 60 -> 64); the router masks the padding experts with -1e30
before its f32 softmax, so they are never chosen.

Attention is the dense model's (`transformer._attend`), so a square prefill
with `use_flash` runs the ported `flash_attention` kernel; everything else
here is plain torch. Layer weights are stacked (L, ...) as in the reference
and the passes loop over the layers.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers, transformer
from .layers import activation, apply_norm, dense_init, init_norm
from .transformer import (TransformerConfig, _attend, _embed,
                          _full_f32_matmuls, _layer_params, _remat, lm_nll)


@dataclasses.dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    """The reference's `MoEConfig`, field for field."""
    n_experts: int = 8          # routed experts (logical, pre-padding)
    n_experts_padded: int = 8   # physical experts
    top_k: int = 2
    d_ff_expert: int = 512
    n_shared: int = 0           # shared experts, each of d_ff_expert width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    def _n_params(self, routed: int) -> int:
        qkv = self.d_model * self.head_dim * (self.n_heads
                                              + 2 * self.n_kv_heads)
        o = self.n_heads * self.head_dim * self.d_model
        moe = routed * 3 * self.d_model * self.d_ff_expert
        shared = self.n_shared * 3 * self.d_model * self.d_ff_expert
        router = self.d_model * self.n_experts
        per_layer = qkv + o + moe + shared + router
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb

    def n_params(self) -> int:
        """Logical parameters (the padding experts not counted)."""
        return self._n_params(self.n_experts)

    def n_active_params(self) -> int:
        """Parameters a token meets: top_k routed experts."""
        return self._n_params(self.top_k)


def param_shapes(cfg: MoEConfig) -> dict:
    """The shape of every parameter, in the reference's nested layout."""
    L, D, H, Hk, Dh = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim)
    E, Fe = cfg.n_experts_padded, cfg.d_ff_expert
    norm = {"scale": (D,)} if cfg.norm == "rms" else {"scale": (D,),
                                                      "bias": (D,)}
    lay = {"wq": (L, D, H * Dh), "wk": (L, D, Hk * Dh), "wv": (L, D, Hk * Dh),
           "wo": (L, H * Dh, D), "router": (L, D, E),
           "we_gate": (L, E, D, Fe), "we_up": (L, E, D, Fe),
           "we_down": (L, E, Fe, D),
           "ln1": {k: (L,) + s for k, s in norm.items()},
           "ln2": {k: (L,) + s for k, s in norm.items()}}
    if cfg.n_shared:
        Fs = cfg.n_shared * Fe
        lay.update(ws_gate=(L, D, Fs), ws_up=(L, D, Fs), ws_down=(L, Fs, D))
    shapes = {"embed": (cfg.vocab, D), "layers": lay, "final_norm": norm}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, cfg.vocab)
    return shapes


def init_params(cfg: MoEConfig, seed: int = 0,
                device: torch.device | str | None = None) -> dict:
    """Random parameters of `param_shapes` in the reference's distributions
    (normal / sqrt(fan_in), fan-in on the D axis, on F for `we_down`; the
    norms' identity init), drawn from a generator seeded with `seed` on
    `device` (CUDA unless given; the draws differ from jax.random's).

    Stacked weights are drawn a layer at a time into a tensor of the
    config's dtype: no f32 copy of a whole (L, E, D, F) stack is made
    (qwen3-moe's is 38.7 GB in f32)."""
    device = resolve_device(device, "init_params")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = cfg.torch_dtype

    def norm(stack: tuple = ()):
        return {k: v.expand(stack + v.shape).contiguous() for k, v in
                init_norm(cfg.norm, cfg.d_model, device=device).items()}

    def stacked(shape):
        out = torch.empty(shape, dtype=dt, device=device)
        for i in range(shape[0]):     # fan-in: the axis after (L, E)
            out[i] = dense_init(gen, shape[1:], in_axis=len(shape) - 3,
                                dtype=dt)
        return out

    shapes = param_shapes(cfg)
    params = {
        "embed": dense_init(gen, shapes["embed"], in_axis=1, dtype=dt),
        "layers": {k: norm((cfg.n_layers,)) if isinstance(s, dict)
                   else stacked(s) for k, s in shapes["layers"].items()},
        "final_norm": norm(),
    }
    if "lm_head" in shapes:
        params["lm_head"] = dense_init(gen, shapes["lm_head"], in_axis=0,
                                       dtype=dt)
    return params


# ------------------------------------------------------------- the FFN ---
def capacity(t: int, cfg: MoEConfig) -> int:
    """Slots an expert has for t tokens: the reference's expression in its
    order, over the logical expert count, rounded by Python's `round`
    (half to even), at least 1 and at most t."""
    cap = int(max(1, round(t * cfg.top_k / cfg.n_experts
                           * cfg.capacity_factor)))
    return min(cap, t)


def route(lp, x: torch.Tensor, cfg: MoEConfig):
    """Router over x (T, D): (probs (T, E) f32, top_p (T, k) renormalised,
    top_e (T, k)). Padding experts get logit -1e30, so probability 0.

    `jax.lax.top_k` breaks ties toward the lower expert index;
    `torch.topk(sorted=True)` does not promise an order among equal
    values. Only exactly equal probabilities tie: the padding experts'
    zeros, which are never among the top k while k <= n_experts, and
    real experts whose f32 probabilities are equal, which random weights
    do not give. Each expert appears once in a token's k, so the order
    within a token moves only the order of `top_p`'s sum."""
    e = cfg.n_experts_padded
    logits = (x @ lp["router"]).float()                      # (T, E)
    if e != cfg.n_experts:
        pad = torch.arange(e, device=x.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_e


def moe_ffn(lp, x: torch.Tensor, cfg: MoEConfig):
    """x (T, D) -> (y (T, D), aux_loss scalar)."""
    t, d = x.shape
    e, k = cfg.n_experts_padded, cfg.top_k
    cap = capacity(t, cfg)
    probs, top_p, top_e = route(lp, x, cfg)
    dev = x.device

    # --- sort-based dispatch -------------------------------------------
    flat_e = top_e.reshape(-1)                                # (T*k,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_w = top_p.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    # rank within expert segment = position - segment start
    seg_start = torch.searchsorted(se, torch.arange(e, device=dev))
    rank = torch.arange(t * k, device=dev) - seg_start[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)        # overflow: sink
    # every kept pair has a slot of its own; the dropped ones all write the
    # same values into the sink, which is cut off: the order in which the
    # writes land never matters
    token_of_slot = torch.full((e * cap + 1,), t, dtype=torch.long,
                               device=dev)                    # t: the pad row
    token_of_slot = token_of_slot.index_put(
        (slot,), torch.where(keep, st, t))[:-1]
    weight_of_slot = torch.zeros(e * cap + 1, dtype=torch.float32,
                                 device=dev).index_put(
        (slot,), torch.where(keep, sw, 0.0))[:-1]
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    xg = x_pad[token_of_slot].reshape(e, cap, d)
    # --- per-expert products --------------------------------------------
    h = activation(torch.bmm(xg, lp["we_gate"]), cfg.act) \
        * torch.bmm(xg, lp["we_up"])
    y_slots = torch.bmm(h, lp["we_down"]).reshape(e * cap, d)
    y_slots = y_slots * weight_of_slot[:, None].to(y_slots.dtype)
    # --- combine: add back to tokens, in the activations' dtype (on CUDA
    # the atomic adds land in any order) ----------------------------------
    y = torch.zeros(t + 1, d, dtype=y_slots.dtype, device=dev).index_add(
        0, token_of_slot, y_slots)[:t]

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add(
        0, flat_e, torch.ones(t * k, dtype=torch.float32, device=dev)) \
        / (t * k)
    aux = cfg.n_experts * torch.sum(me * ce)
    return y.to(x.dtype), aux


def _ffn(lp, h2, cfg: MoEConfig):
    """The routed experts plus the shared ones over h2 (B, S, D). Tokens
    are whole over "model" for routing (the reference's contract: experts
    split over "model", tokens replicated there)."""
    h2 = layers.replicated_over(h2, "model")
    b, s, d = h2.shape
    y, aux = moe_ffn(lp, h2.reshape(b * s, d), cfg)
    y = y.reshape(b, s, d)
    if cfg.n_shared:
        y = y + (activation(h2 @ lp["ws_gate"], cfg.act)
                 * (h2 @ lp["ws_up"])) @ lp["ws_down"]
    return y, aux


def _block(lp, x, cfg: MoEConfig, positions):
    """One layer over (B, S, D): (x, aux, k, v)."""
    x = layers.shard_activations(x, cfg.batch_axes, cfg.seq_axes)
    x, k, v = _attend(lp, x, cfg, positions)
    y, aux = _ffn(lp, apply_norm(x, lp["ln2"], cfg.norm), cfg)
    return x + y, aux, k, v


def forward(params, tokens: torch.Tensor, cfg: MoEConfig):
    """tokens (B, S) -> (hidden (B, S, D), mean aux loss)."""
    _full_f32_matmuls()
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1],
                             device=tokens.device).expand(tokens.shape)
    auxes = []
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        if _remat(cfg, lp, x):
            x, aux, _, _ = checkpoint(_block, lp, x, cfg, positions,
                                      use_reentrant=False)
        else:
            x, aux, _, _ = _block(lp, x, cfg, positions)
        auxes.append(aux)
    return (apply_norm(x, params["final_norm"], cfg.norm),
            torch.stack(auxes).mean())


def lm_loss(params, tokens: torch.Tensor, cfg: MoEConfig):
    """The dense model's chunked LM loss plus the weighted router aux."""
    hidden, aux = forward(params, tokens[:, :-1], cfg)
    return lm_nll(params, hidden, tokens[:, 1:], cfg) \
        + cfg.router_aux_weight * aux


def _cache_block(lp, x, cfg: MoEConfig, positions):
    x, _, k, v = _block(lp, x, cfg, positions)
    return x, k, v


def forward_with_cache(params, tokens: torch.Tensor, cfg: MoEConfig):
    """Prefill twin of transformer.forward_with_cache (MoE FFN): returns
    (last-token logits (B, V), cache {"k", "v"} (L, B, S, Hkv, Dh))."""
    return transformer.prefill(params, tokens, cfg, _cache_block)


# ---------------------------------------------------------------- decode ---
def init_cache(cfg: MoEConfig, batch: int, max_seq: int,
               device: torch.device | str | None = None):
    return transformer.init_cache(cfg, batch, max_seq, device=device)


def _decode_ffn(lp, h2, cfg: MoEConfig):
    return _ffn(lp, h2, cfg)[0]


def decode_step(params, cache, tokens: torch.Tensor, pos: torch.Tensor,
                cfg: MoEConfig):
    """One-token decode over the pool, tokens (B,), pos (B,): the dense
    model's decode step with the MoE FFN, which routes the B slots' tokens
    together (capacity over B tokens). The cache is updated in place and
    returned with the logits (B, V)."""
    return transformer.decode(params, cache, tokens, pos, cfg, _decode_ffn)

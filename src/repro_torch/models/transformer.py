"""Dense decoder-only transformer with GQA, RoPE and pluggable FFN.

The port of the reference's `models/transformer.py`: forward, the LM loss,
prefill and decode. Covers
nemotron-4-15b (squared-ReLU), codeqwen1.5-7b (SwiGLU) and gemma-7b (GeGLU,
head_dim 256). Parameters are a plain dict in the reference's layout, layer
weights STACKED with a leading `n_layers` axis; the forward passes loop over
the layers in Python where the reference scans.

Attention with `use_flash` and a square (S == T, S % 128 == 0) problem runs
the flash-attention kernel (`kernels/ops.flash_attention`, CUDA on the card,
its plain version on the CPU), as in the reference; on the card a head dim
the kernel does not take (`kops.FLASH_HEAD_DIMS`) raises there, so a caller
with such a config leaves `use_flash` off. Every other branch is
plain torch. The kernel is forward-only, as the reference's is: gradients
are taken through the plain attention (`use_flash=False`), and asking for
them through the kernel raises. The matrix products are `torch.matmul` in
the config's dtype, with TF32 switched off so that f32 means f32.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from .. import pytree
from ..device import resolve_device
from ..kernels import ops as kops
from . import layers
from .layers import activation, apply_norm, dense_init, init_norm, rope


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's `TransformerConfig`, field for field.

    `remat` recomputes each layer in the backward pass (activation
    checkpointing) and `loss_chunks` splits the LM loss's vocab projection
    over the sequence; both act only when gradients are taken.
    `scatter_cache_update` selects nothing (both cache-update modes are one
    in-place write). `batch_axes`/`seq_axes` name the ambient mesh's axes
    of the residual-stream constraint (`layers.shard_activations`), checked
    as the reference checks them; the stream stays on the model's device.
    """
    name: str = "transformer"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    act: str = "silu"          # silu | gelu | sq_relu
    glu: bool = True           # gated FFN (SwiGLU/GeGLU); False = plain MLP
    norm: str = "rms"
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    window: int | None = None  # sliding-window attention (serve-time bound)
    dtype: str = "bfloat16"
    remat: bool = True         # per-layer activation checkpointing
    loss_chunks: int = 8       # vocab-projection chunking for the LM loss
    use_flash: bool = False    # route square attention through the kernel
    attn_chunk: int | None = None  # query-chunked attention (long prefill):
    #   bounds the (B,H,chunk,S) logit buffer instead of (B,H,S,S)
    batch_axes: tuple = ()     # residual-stream sharding constraint (SP)
    seq_axes: tuple = ()
    attn_bf16_operands: bool = False  # QK^T / PV operands in the cache dtype
    #   with f32 accumulation
    scatter_cache_update: bool = False  # decode: per-slot scatter instead of
    #   the one-hot multiply-add (both are an in-place index write here)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        qkv = self.d_model * self.head_dim * (self.n_heads
                                              + 2 * self.n_kv_heads)
        o = self.n_heads * self.head_dim * self.d_model
        ff = self.d_model * self.d_ff * (3 if self.glu else 2)
        per_layer = qkv + o + ff
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb


def _full_f32_matmuls() -> None:
    """f32 products in full f32 on the card: TF32 off, and checked."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32


def param_shapes(cfg: TransformerConfig) -> dict:
    """The shape of every parameter, in the reference's nested layout."""
    L, D, H, Hk, Dh, F = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.n_kv_heads, cfg.head_dim, cfg.d_ff)
    norm = {"scale": (D,)} if cfg.norm == "rms" else {"scale": (D,),
                                                      "bias": (D,)}
    lay = {"wq": (L, D, H * Dh), "wk": (L, D, Hk * Dh), "wv": (L, D, Hk * Dh),
           "wo": (L, H * Dh, D), "w_up": (L, D, F), "w_down": (L, F, D),
           "ln1": {k: (L,) + s for k, s in norm.items()},
           "ln2": {k: (L,) + s for k, s in norm.items()}}
    if cfg.glu:
        lay["w_gate"] = (L, D, F)
    shapes = {"embed": (cfg.vocab, D), "layers": lay, "final_norm": norm}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, cfg.vocab)
    return shapes


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: torch.device | str | None = None) -> dict:
    """Random parameters of `param_shapes` in the reference's distributions
    (normal / sqrt(fan_in) weights, the norms' identity init), drawn from a
    generator seeded with `seed` on `device` (CUDA unless given; the draws
    differ from the reference's jax.random ones)."""
    device = resolve_device(device, "init_params")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shapes = param_shapes(cfg)

    def norm(stack: tuple = ()):
        return {k: v.expand(stack + v.shape).contiguous() for k, v in
                init_norm(cfg.norm, cfg.d_model, device=device).items()}

    def weight(shape, in_axis):
        return dense_init(gen, shape, in_axis=in_axis, dtype=cfg.torch_dtype)

    params = {
        "embed": weight(shapes["embed"], 1),
        "layers": {k: norm((cfg.n_layers,)) if isinstance(s, dict)
                   else weight(s, 1)
                   for k, s in shapes["layers"].items()},
        "final_norm": norm(),
    }
    if "lm_head" in shapes:
        params["lm_head"] = weight(shapes["lm_head"], 0)
    return params


def _layer_params(params: dict, i: int) -> dict:
    """Layer i's slice of the stacked layer parameters."""
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                else v[i]) for k, v in params["layers"].items()}


def _attention(q, k, v, cfg: TransformerConfig, causal: bool,
               kv_positions=None, q_positions=None):
    """q (B,S,H,Dh), k/v (B,T,Hk,Dh) -> (B,S,H,Dh). fp32 softmax."""
    b, s, h, dh = q.shape
    t = k.shape[1]
    hk = k.shape[2]
    g = h // hk
    if cfg.use_flash and s == t and s % 128 == 0:
        if torch.is_grad_enabled() and q.requires_grad:
            raise RuntimeError(
                "flash_attention is forward-only, as in the reference: take "
                "gradients with use_flash=False")
        # the kernel takes (B, H, S, D) and never copies: lay it out here
        out = kops.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal)
        return out.transpose(1, 2)
    if cfg.attn_chunk is not None and s > cfg.attn_chunk \
            and s % cfg.attn_chunk == 0:
        if q_positions is None:
            q_positions = torch.arange(s, device=q.device).expand(b, s)
        ck = cfg.attn_chunk
        base = dataclasses.replace(cfg, attn_chunk=None)
        return torch.cat([
            _attention(q[:, i:i + ck], k, v, base, causal,
                       kv_positions=kv_positions,
                       q_positions=q_positions[:, i:i + ck])
            for i in range(0, s, ck)], dim=1)
    if g > 1 and _heads_split_unevenly(q, hk):
        # an SPMD step whose model axis cannot split the KV heads: each KV
        # head repeated for its group, so the query heads can be split and
        # every device holds the KV heads of its own (the same products)
        k, v = (_split_like_heads(x.repeat_interleave(g, dim=2), q)
                for x in (k, v))
        hk, g = h, 1
    qg = q.reshape(b, s, hk, g, dh)
    # bf16 operands with f32 accumulation (attn_bf16_operands) are the same
    # products as the f32 ones: each bf16 value and each product of two is
    # exact in f32. What that option changes is the weights' cast to the
    # cache dtype before the PV product, kept below.
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k.float()) * dh ** -0.5
    if q_positions is None:
        q_positions = torch.arange(s, device=q.device)[None, :]
    if kv_positions is None:
        kv_positions = torch.arange(t, device=q.device)[None, :]
    mask = kv_positions[:, None, :] <= q_positions[:, :, None]  # (B,S,T)
    if cfg.window is not None:
        mask &= kv_positions[:, None, :] > (q_positions[:, :, None]
                                            - cfg.window)
    if not causal:
        mask = torch.ones_like(mask)
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.tensor(-1e30, dtype=torch.float32,
                                      device=q.device))
    w = torch.softmax(logits, dim=-1)
    if cfg.attn_bf16_operands:
        w = w.to(v.dtype).float()
    out = torch.einsum("bhgst,bthd->bshgd", w, v.float())
    return out.reshape(b, s, h, dh).to(q.dtype)


def _heads_split_unevenly(q, hk: int) -> bool:
    """Is q a DTensor on a mesh whose "model" axis does not divide `hk`,
    the KV head count? Its query heads may be split there (in the forward
    pass, or in the backward pass by the output projection's rows), and
    the KV heads cannot follow."""
    from torch.distributed.tensor import DTensor
    if not isinstance(q, DTensor):
        return False
    names = q.device_mesh.mesh_dim_names or ()
    return "model" in names \
        and hk % q.device_mesh.size(names.index("model")) != 0


def _split_like_heads(x, q):
    """x (B, T, H, Dh), whole over the mesh dimensions that split q's
    heads, split there as q's heads are; its other splits kept. (Its
    gradient comes back whole there, as the repeat it follows needs.)"""
    from torch.distributed.tensor import Shard
    pls = [Shard(2) if isinstance(p, Shard) and p.dim == 2 else xp
           for p, xp in zip(q.placements, x.placements)]
    return x.redistribute(x.device_mesh, pls)


def _ffn(lp, x, cfg: TransformerConfig):
    up = x @ lp["w_up"]
    if cfg.glu:
        up = activation(x @ lp["w_gate"], cfg.act) * up
    else:
        up = activation(up, cfg.act)
    return up @ lp["w_down"]


def _attend(lp, x, cfg: TransformerConfig, positions):
    """A layer's attention half over (B, S, D): x plus the attention's
    output, and k, v (B,S,Hk,Dh) for the cache."""
    b, s, _ = x.shape
    h = apply_norm(x, lp["ln1"], cfg.norm)
    q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    attn = _attention(q, k, v, cfg, causal=True,
                      q_positions=positions, kv_positions=positions)
    return x + attn.reshape(b, s, -1) @ lp["wo"], k, v


def _block(lp, x, cfg: TransformerConfig, positions):
    """One layer over (B, S, D); returns (x, k, v) with k, v (B,S,Hk,Dh)."""
    x, k, v = _attend(lp, x, cfg, positions)
    x = x + _ffn(lp, apply_norm(x, lp["ln2"], cfg.norm), cfg)
    return x, k, v


def _needs_grad(*tensors) -> bool:
    """Is autograd recording, and does any of `tensors` (or a tensor in a
    dict of them) take part?"""
    return torch.is_grad_enabled() and any(
        t.requires_grad for x in tensors
        for t in (pytree.leaves(x) if isinstance(x, dict) else [x]))


def _remat(cfg: TransformerConfig, lp, x) -> bool:
    """Recompute a layer in the backward pass: `remat` set and a gradient
    being taken through it (the reference's jax.checkpoint around the layer
    scan)."""
    return cfg.remat and _needs_grad(x, lp)


def _embed(params, tokens, cfg: TransformerConfig):
    return params["embed"][tokens].to(cfg.torch_dtype)


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens (B, S) int -> final hidden states (B, S, D)."""
    _full_f32_matmuls()
    x = _embed(params, tokens, cfg)
    x = layers.shard_activations(x, cfg.batch_axes, cfg.seq_axes)
    positions = torch.arange(tokens.shape[1],
                             device=tokens.device).expand(tokens.shape)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        if _remat(cfg, lp, x):
            x, _, _ = checkpoint(_block, lp, x, cfg, positions,
                                 use_reentrant=False)
        else:
            x, _, _ = _block(lp, x, cfg, positions)
    return apply_norm(x, params["final_norm"], cfg.norm)


def logits_fn(params, hidden, cfg: TransformerConfig):
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    return hidden @ head


def _chunk_nll(h, targets, head):
    """Summed next-token NLL of one sequence chunk: logits in f32."""
    logits = (h @ head).float()                         # (B, sc, V)
    # (B, sc, 1) throughout: the same values and sum as (B, sc), in a shape
    # DTensor's masked gather from a vocabulary block reduces correctly
    gold = torch.gather(logits, -1, targets[..., None].long())
    return torch.sum(torch.logsumexp(logits, dim=-1, keepdim=True) - gold)


def lm_nll(params, hidden, targets, cfg: TransformerConfig):
    """Mean NLL with the vocab projection chunked over the SEQUENCE axis
    (`loss_chunks` chunks when they divide S, else one), each chunk
    recomputed in the backward pass, so neither pass holds more than one
    (B, S / chunks, V) logit chunk. The chunks' sums add up in order, as
    the reference's scan does."""
    b, s, _ = hidden.shape
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    nc = cfg.loss_chunks if cfg.loss_chunks > 1 and s % cfg.loss_chunks == 0 \
        else 1
    sc = s // nc
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, sc):
        h, t = hidden[:, i:i + sc], targets[:, i:i + sc]
        if _needs_grad(h, head):
            total = total + checkpoint(_chunk_nll, h, t, head,
                                       use_reentrant=False)
        else:
            total = total + _chunk_nll(h, t, head)
    return total / (b * s)


def lm_loss(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """Causal LM loss of tokens (B, S + 1): the mean NLL of tokens[:, 1:]
    given the prefix, through `lm_nll`."""
    hidden = forward(params, tokens[:, :-1], cfg)
    return lm_nll(params, hidden, tokens[:, 1:], cfg)


def forward_with_cache(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """Prefill: returns (last-token logits (B, V), kv cache dict).

    Cache layout matches decode_step: (L, B, S, Hkv, Dh)."""
    return prefill(params, tokens, cfg, _block)


def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig, block):
    """`forward_with_cache` with each layer run by `block(lp, x, cfg,
    positions) -> (x, k, v)`: the dense layer here, the MoE one in
    `models.moe`."""
    _full_f32_matmuls()
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, k, v = block(_layer_params(params, i), x, cfg, positions)
        ks.append(k)
        vs.append(v)
    x = apply_norm(x, params["final_norm"], cfg.norm)
    logits = logits_fn(params, x[:, -1, :], cfg)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


# ----------------------------------------------------------------- decode ---
def write_rows(cache, slots, rows, new) -> None:
    """cache (B, S, Hk, Dh): row rows[b] of slot slots[b] becomes new[b]
    (B, Hk, Dh), in place. On a DTensor cache (the dry run's SPMD step)
    each rank writes into its own block the slots and heads it holds, and
    only the rows that fall in its block of the sequence."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(cache, DTensor):
        cache[slots, rows] = new
        return
    dmesh, pls = cache.device_mesh, cache.placements
    # the new rows and positions laid out as the cache's slots and heads
    by = {0: 0, 2: 1, 3: 2}
    new_pl = [Shard(by[p.dim]) if isinstance(p, Shard) and p.dim in by
              else Replicate() for p in pls]
    row_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in pls]
    whole = [Replicate()] * dmesh.ndim
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, dmesh, whole)
    if not isinstance(rows, DTensor):
        rows = DTensor.from_local(rows, dmesh, whole)
    block = cache.to_local()
    n = new.redistribute(dmesh, new_pl).to_local()
    r = rows.redistribute(dmesh, row_pl).to_local()
    idx = 0
    for d, p in enumerate(pls):
        if isinstance(p, Shard) and p.dim == 1:
            idx = idx * dmesh.size(d) + dmesh.get_local_rank(d)
    s_loc = block.shape[1]
    r = r - idx * s_loc
    inside = (r >= 0) & (r < s_loc)
    r = r.clamp(0, s_loc - 1)
    local_slots = torch.arange(block.shape[0], device=block.device)
    block[local_slots, r] = torch.where(inside[:, None, None], n,
                                        block[local_slots, r])


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device: torch.device | str | None = None):
    device = resolve_device(device, "init_cache")
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def decode_step(params, cache, tokens: torch.Tensor, pos: torch.Tensor,
                cfg: TransformerConfig):
    """One-token decode. tokens (B,) int; pos (B,) current positions.

    Returns (logits (B, V), cache). The cache is updated IN PLACE and
    returned: each slot's new K/V row is written at its position, which
    overwrites whatever the slot held there, as both of the reference's
    update modes (one-hot multiply-add and per-slot scatter) do; so
    `scatter_cache_update` selects nothing here.
    """
    return decode(params, cache, tokens, pos, cfg, _ffn)


def decode(params, cache, tokens: torch.Tensor, pos: torch.Tensor,
           cfg: TransformerConfig, ffn):
    """`decode_step` with each layer's feed-forward half `ffn(lp, h, cfg)`
    over the normed (B, 1, D) stream: the dense FFN here, the MoE one in
    `models.moe`."""
    _full_f32_matmuls()
    b = tokens.shape[0]
    x = _embed(params, tokens, cfg)[:, None, :]                 # (B,1,D)
    positions = pos[:, None]
    max_seq = cache["k"].shape[2]
    kv_pos = torch.arange(max_seq, device=tokens.device)[None, :]
    slots = torch.arange(b, device=tokens.device)
    rows = pos.long()
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        h = apply_norm(x, lp["ln1"], cfg.norm)
        q = (h @ lp["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
        k = (h @ lp["wk"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ lp["wv"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        write_rows(k_cache, slots, rows, k[:, 0])
        write_rows(v_cache, slots, rows, v[:, 0])
        attn = _attention(q, k_cache, v_cache, cfg, causal=True,
                          q_positions=positions, kv_positions=kv_pos)
        x = x + attn.reshape(b, 1, -1) @ lp["wo"]
        x = x + ffn(lp, apply_norm(x, lp["ln2"], cfg.norm), cfg)
    x = apply_norm(x, params["final_norm"], cfg.norm)
    logits = logits_fn(params, x[:, 0, :], cfg)
    return logits, cache

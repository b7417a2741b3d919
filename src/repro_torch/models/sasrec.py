"""SASRec: self-attentive sequential recommendation [arXiv:1808.09781].

The port of the reference's `models/sasrec.py`: item embedding table ->
learned positional embedding -> `n_blocks` causal single-head transformer
blocks -> dot-product scoring against the item embeddings. Parameters are
a plain dict in the reference's layout (`blocks` a list of per-block
dicts). Attention runs in f32 whatever the weights' dtype, and masked
logits are -1e30, not -inf, as in the reference: a query row whose keys
are all padding (position 0 of a sequence that starts with padding)
softmaxes to uniform weights instead of NaN.

Serving scores the catalog through STREAK's block-wise top-k with
threshold early termination (`serve/retrieval.py`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .layers import dense_init, layer_norm


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    """The reference's `SASRecConfig`, field for field (`dropout` is kept
    for equality and, as there, not applied)."""
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    d_ff: int = 50
    dropout: float = 0.2
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        d = self.embed_dim
        per_block = 4 * d * d + 2 * d * self.d_ff
        return (self.n_items + self.seq_len) * d + self.n_blocks * per_block


def param_shapes(cfg: SASRecConfig) -> dict:
    """The shape of every parameter, in the reference's nested layout."""
    d, f = cfg.embed_dim, cfg.d_ff
    block = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
             "w1": (d, f), "w2": (f, d), "ln1_scale": (d,), "ln1_bias": (d,),
             "ln2_scale": (d,), "ln2_bias": (d,)}
    return {"item_embed": (cfg.n_items, d), "pos_embed": (cfg.seq_len, d),
            "blocks": [dict(block) for _ in range(cfg.n_blocks)]}


def init_params(cfg: SASRecConfig, seed: int = 0,
                device: torch.device | str | None = None) -> dict:
    """Random parameters of `param_shapes` in the reference's distributions
    (normal / sqrt(fan_in) weights, the embeddings' fan-in their width, the
    norms' identity init), drawn from a generator seeded with `seed` on
    `device` (CUDA unless given; the draws differ from jax.random's)."""
    device = resolve_device(device, "sasrec.init_params")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = cfg.torch_dtype
    shapes = param_shapes(cfg)

    def block(shape: dict) -> dict:
        return {k: (dense_init(gen, s, dtype=dt) if k[0] == "w" else
                    torch.full(s, 1.0 if k.endswith("scale") else 0.0,
                               dtype=dt, device=device))
                for k, s in shape.items()}

    return {"item_embed": dense_init(gen, shapes["item_embed"], in_axis=1,
                                     dtype=dt),
            "pos_embed": dense_init(gen, shapes["pos_embed"], in_axis=1,
                                    dtype=dt),
            "blocks": [block(b) for b in shapes["blocks"]]}


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] with the reference's indexing semantics: an id past the
    table reads its last row and passes it no gradient (jnp indexing
    clamps a gather and drops the scatter of its gradient).
    `data.recsys.InteractionStream`, as the reference's, draws positive
    items up to n_items, one past the table."""
    ids = ids.long()
    last = table.shape[0] - 1
    rows = table[ids.clamp(max=last)]
    return torch.where((ids > last)[..., None], rows.detach(), rows)


def encode(params: dict, seq: torch.Tensor, cfg: SASRecConfig
           ) -> torch.Tensor:
    """seq (B, S) item ids (0 = padding) -> user states (B, S, D)."""
    s = seq.shape[1]
    d = cfg.embed_dim
    x = take_rows(params["item_embed"], seq) * (d ** 0.5) \
        + params["pos_embed"][None, :s]
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=seq.device))
    mask = causal[None] & (seq != 0)[:, None, :]
    masked = torch.tensor(-1e30, dtype=torch.float32, device=seq.device)
    for blk in params["blocks"]:
        h = layer_norm(x, blk["ln1_scale"], blk["ln1_bias"])
        q, k, v = h @ blk["wq"], h @ blk["wk"], h @ blk["wv"]
        logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
            * (d ** -0.5)
        w = torch.softmax(torch.where(mask, logits, masked), dim=-1)
        att = torch.einsum("bqk,bkd->bqd", w, v.float()).to(x.dtype)
        x = x + att @ blk["wo"]
        h = layer_norm(x, blk["ln2_scale"], blk["ln2_bias"])
        x = x + F.relu(h @ blk["w1"]) @ blk["w2"]
    return x


def user_state(params: dict, seq: torch.Tensor, cfg: SASRecConfig
               ) -> torch.Tensor:
    """Last-position state (B, D)."""
    return encode(params, seq, cfg)[:, -1, :]


def score_candidates(params: dict, state: torch.Tensor,
                     candidates: torch.Tensor) -> torch.Tensor:
    """state (B, D) x candidates (B, C) item ids -> (B, C) scores."""
    emb = take_rows(params["item_embed"], candidates)      # (B, C, D)
    return torch.einsum("bd,bcd->bc", state, emb)


def score_all(params: dict, state: torch.Tensor) -> torch.Tensor:
    """Full-catalog scores (B, N_items): the offline bulk scoring path."""
    return state @ params["item_embed"].T


def bpr_loss(params: dict, seq: torch.Tensor, pos_items: torch.Tensor,
             neg_items: torch.Tensor, cfg: SASRecConfig) -> torch.Tensor:
    """Sequence-to-sequence BPR: predict item t+1 at every position."""
    states = encode(params, seq, cfg)                      # (B, S, D)
    pe = take_rows(params["item_embed"], pos_items)
    ne = take_rows(params["item_embed"], neg_items)
    pos_s = torch.sum(states * pe, dim=-1)
    neg_s = torch.sum(states * ne, dim=-1)
    valid = (pos_items != 0).float()
    ll = F.logsigmoid(pos_s - neg_s) * valid
    return -ll.sum() / torch.clamp(valid.sum(), min=1.0)

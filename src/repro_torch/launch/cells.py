"""Cell builder: (arch, shape, mesh) -> (step function, sharded inputs).

The port of the reference's `launch/cells.py`. Each of the 40 (architecture
x input-shape) cells is a step function plus its arguments as `Abstract`
leaves (shape, dtype, `NamedSharding`: the reference's sharded
`ShapeDtypeStruct`s), which allocate nothing. `materialize` gives the
arguments either as fake DTensors laid out over a `DeviceMesh` (the dry
run, `launch/dryrun.py`, which counts one device's work) or as real tensors
drawn from a seed on a device (the tests and the card), and the same step
runs on both.

The steps use the port's modules: `transformer`/`moe` `lm_loss`,
`forward_with_cache` and `decode_step`, `gnn.nll_loss`,
`graphcast.mse_loss`, `equivariant.batched_energy_loss`,
`sasrec.bpr_loss`/`user_state`, `retrieval.blocked_topk(_sharded)` and
`streak_topk(_sharded)`, `optim.apply_updates`; gradients come from
`torch.autograd.grad`. The layouts come from `dist/partitioning.py`.

A step writes its parameters, optimizer state and decode cache in place,
as the port's `optim.apply_updates` and `decode_step` do; `donate` names
the arguments the reference donates for it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import pytree
from ..configs import registry
from ..dist import partitioning as pt
from ..models import equivariant, gnn, graphcast, moe, sasrec, transformer
from ..models.layers import constrain
from ..serve import retrieval
from ..train import optim
from .mesh import NamedSharding, PartitionSpec as P, local_shape, to_dtensor


@dataclasses.dataclass(frozen=True)
class Abstract:
    """An argument that holds no memory: its global shape, dtype and
    layout (the reference's `jax.ShapeDtypeStruct(..., sharding=)`)."""
    shape: tuple
    dtype: torch.dtype
    sharding: NamedSharding | None = None

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    def local_nbytes(self) -> int:
        """The bytes of one position's block."""
        return math.prod(local_shape(self.shape, self.sharding)) \
            * self.dtype.itemsize


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: object                # the step: fn(*args)
    args: tuple               # trees of Abstract leaves
    real: object = None       # real(device, seed) -> args as real tensors
    out_shardings: object = None
    donate: tuple = ()        # arg indices donated (written in place)
    static: dict = dataclasses.field(default_factory=dict)


def _map(fn, tree, *rest):
    """`fn` over the Abstract leaves of `tree` (dicts, lists, tuples)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def abstract_leaves(cell: Cell) -> list:
    out = []
    _map(lambda a: out.append(a), cell.args)
    return out


def materialize(cell: Cell, device=None, seed: int = 0, dmesh=None,
                fake: bool = False):
    """The cell's arguments. With `dmesh` (a `DeviceMesh` of the cell's
    mesh shape; call inside `FakeTensorMode`): DTensors whose local blocks
    are fake tensors of this rank's block shape, so nothing is allocated.
    With `fake` (inside `FakeTensorMode`): plain tensors of the whole
    shape, for a one-device count. Otherwise: real tensors on `device`,
    drawn from `seed` by the cell's `real`, checked against the abstract
    shapes and dtypes."""
    if dmesh is not None:
        return _map(lambda a: to_dtensor(
            torch.empty(local_shape(a.shape, a.sharding), dtype=a.dtype),
            dmesh, a.sharding, a.shape), cell.args)
    if fake:
        return _map(lambda a: torch.empty(a.shape, dtype=a.dtype),
                    cell.args)
    args = cell.real(torch.device(device), seed)

    def check(a: Abstract, t):
        if tuple(t.shape) != tuple(a.shape) or t.dtype != a.dtype:
            raise AssertionError(f"{cell.arch} x {cell.shape}: real "
                                 f"{tuple(t.shape)} {t.dtype} against "
                                 f"abstract {a.shape} {a.dtype}")
        return t
    return _map(check, cell.args, args)


def _sds(shape, dtype, sharding) -> Abstract:
    return Abstract(tuple(shape), dtype, sharding)


def _shard_tree(abstract_tree, sharding_tree):
    return _map(lambda a, s: Abstract(a.shape, a.dtype, s), abstract_tree,
                sharding_tree)


def _abstract(make):
    """The shapes and dtypes of the tree `make()` builds, built on fake
    tensors (no memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = make()
    return pytree.tree_map(lambda t: Abstract(tuple(t.shape), t.dtype), tree)


def _abstract_params(init_fn, cfg):
    return _abstract(lambda: init_fn(cfg, device="cpu"))


def _opt_abstract(p_abs) -> dict:
    def f32(a):
        return Abstract(a.shape, torch.float32)
    return {"m": pytree.tree_map(f32, p_abs), "v": pytree.tree_map(f32, p_abs),
            "step": Abstract((), torch.int32)}


def _opt_sharding(param_sharding, mesh, abstract_params) -> dict:
    """ZeRO-1 moments (the reference's default) and a replicated step."""
    moments = pt.zero1_sharding(param_sharding, abstract_params, mesh)
    return {"m": moments, "v": moments, "step": NamedSharding(mesh, P())}


def value_and_grad(loss_fn, params, *args):
    """(loss, gradients of loss_fn(params, *args) by `params`' leaves), the
    gradients a tree like `params` (jax.value_and_grad)."""
    leaves = pytree.leaves(params)
    with torch.enable_grad():
        ps = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(pytree.unflatten(params, ps), *args)
        grads = torch.autograd.grad(loss, ps)
    return loss.detach(), pytree.unflatten(params, list(grads))


def _train_step(loss_fn, ocfg):
    """step(params, opt_state, *batch) -> (params, opt_state, loss,
    metrics): one AdamW step on loss_fn(params, *batch)."""
    def train_step(params, opt_state, *batch):
        loss, grads = value_and_grad(loss_fn, params, *batch)
        params, opt_state, metrics = optim.apply_updates(
            params, grads, opt_state, ocfg)
        return params, opt_state, loss, metrics
    return train_step


def _gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _ints(g, hi: int, shape, lo: int = 0) -> torch.Tensor:
    return torch.randint(lo, hi, tuple(shape), generator=g,
                         device=g.device, dtype=torch.int32)


def _normal(g, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=g, device=g.device,
                       dtype=torch.float32).to(dtype)


# ---------------------------------------------------------------------------
# LM / MoE cells
# ---------------------------------------------------------------------------

def _lm_cell(arch, shape_name, spec, mesh, cfg,
             variant: str = "base") -> Cell:
    is_moe = registry.get(arch).family == "moe"
    model_mod = moe if is_moe else transformer
    loss_fn = model_mod.lm_loss
    dp = pt.dp_axes(mesh)
    rep = NamedSharding(mesh, P())

    p_abs = _abstract_params(model_mod.init_params, cfg)
    p_shard = pt.lm_param_sharding(p_abs, mesh, cfg)
    params_in = _shard_tree(p_abs, p_shard)

    def params_real(device, seed):
        return model_mod.init_params(cfg, seed=seed, device=device)

    if spec["kind"] == "train":
        if variant == "base":
            # sequence-parallel residual stream (SP): the per-layer carry
            # shards over "model"
            cfg = dataclasses.replace(cfg, batch_axes=dp, seq_axes=("model",))
            n_micro = 1
        elif variant == "opt":
            # gradient-accumulation microbatching, no SP
            cfg = dataclasses.replace(cfg, batch_axes=dp, seq_axes=())
            n_micro = 4
        else:  # "opt2": SP + microbatching
            cfg = dataclasses.replace(cfg, batch_axes=dp, seq_axes=("model",))
            n_micro = 4
        o_shard = _opt_sharding(p_shard, mesh, p_abs)
        opt_in = _shard_tree(_opt_abstract(p_abs), o_shard)
        tshape = (spec["global_batch"], spec["seq_len"] + 1)
        tokens = _sds(tshape, torch.int32, NamedSharding(mesh, P(dp, None)))
        ocfg = optim.AdamWConfig()

        def train_step(params, opt_state, batch):
            if n_micro == 1:
                loss, grads = value_and_grad(loss_fn, params, batch, cfg)
            else:
                gb = batch.shape[0]
                # each micro-batch's rows split over the data axes (an SPMD
                # step gathers the token ids, then keeps its own rows)
                mb = constrain(constrain(batch, None, None).reshape(
                    n_micro, gb // n_micro, -1), None, dp, None)
                gsum = pytree.tree_map(
                    lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
                losses = []
                for i in range(n_micro):
                    l, g = value_and_grad(loss_fn, params, mb[i], cfg)
                    gsum = pytree.tree_map(lambda a, b2: a + b2.float(),
                                           gsum, g)
                    losses.append(l)
                grads = pytree.tree_map(lambda g: g / n_micro, gsum)
                loss = torch.mean(torch.stack(losses))
            params, opt_state, metrics = optim.apply_updates(
                params, grads, opt_state, ocfg)
            return params, opt_state, loss, metrics

        def real(device, seed):
            p = params_real(device, seed)
            g = _gen(device, seed + 1)
            return p, optim.init_state(p), _ints(g, cfg.vocab, tshape)

        return Cell(arch, shape_name, train_step,
                    (params_in, opt_in, tokens), real,
                    out_shardings=(p_shard, o_shard, rep, None),
                    donate=(0, 1))

    if spec["kind"] == "prefill":
        cfg2 = dataclasses.replace(cfg, attn_chunk=2048, remat=True)
        if variant == "opt":
            cfg2 = dataclasses.replace(cfg2, attn_bf16_operands=True)
        tshape = (spec["global_batch"], spec["seq_len"])
        tokens = _sds(tshape, torch.int32, NamedSharding(mesh, P(dp, None)))
        cache_shard = pt.kv_cache_sharding(mesh, cfg.n_kv_heads)

        def prefill(params, batch):
            return model_mod.forward_with_cache(params, batch, cfg2)

        def real(device, seed):
            return (params_real(device, seed),
                    _ints(_gen(device, seed + 1), cfg.vocab, tshape))

        return Cell(arch, shape_name, prefill, (params_in, tokens), real,
                    out_shardings=(None, {"k": cache_shard, "v": cache_shard}))

    # decode kinds -----------------------------------------------------
    if variant == "opt":
        # bf16 cache reads with f32 accumulation + scatter cache update
        cfg = dataclasses.replace(cfg, attn_bf16_operands=True,
                                  scatter_cache_update=True)
    b, s = spec["global_batch"], spec["seq_len"]
    if b == 1:  # long-context: batch unshardable, spread seq over everything
        cache_spec = NamedSharding(mesh, P(None, None, dp + ("model",),
                                           None, None))
        tok_spec = NamedSharding(mesh, P(None))
    else:
        cache_spec = pt.kv_cache_sharding(mesh, cfg.n_kv_heads)
        tok_spec = NamedSharding(mesh, P(dp))
    cache_abs = _abstract(lambda: model_mod.init_cache(cfg, b, s,
                                                       device="cpu"))
    cache_in = _map(lambda a: _sds(a.shape, a.dtype, cache_spec), cache_abs)
    tokens = _sds((b,), torch.int32, tok_spec)
    pos = _sds((b,), torch.int32, tok_spec)

    def serve_step(params, cache, tok, pos):
        return model_mod.decode_step(params, cache, tok, pos, cfg)

    def real(device, seed):
        g = _gen(device, seed + 1)
        return (params_real(device, seed),
                model_mod.init_cache(cfg, b, s, device=device),
                _ints(g, cfg.vocab, (b,)), _ints(g, s, (b,)))

    return Cell(arch, shape_name, serve_step,
                (params_in, cache_in, tokens, pos), real,
                out_shardings=(None, {"k": cache_spec, "v": cache_spec}),
                donate=(1,) if variant == "opt" else ())


# ---------------------------------------------------------------------------
# GNN cells (gcn / sage)
# ---------------------------------------------------------------------------

def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in pt.dp_axes(mesh))


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _gnn_sizes(spec, mesh) -> tuple[int, int]:
    """Node/edge counts padded to the data-axis size (loaders zero-pad;
    loss masks exclude padding)."""
    if spec["kind"] == "sampled":
        b = spec["batch_nodes"]
        f1, f2 = spec["fanout"]
        nodes = b * (1 + f1 + f1 * f2)
        edges = b * f1 + b * f1 * f2
    elif spec["kind"] == "batched":
        nodes = spec["n_nodes"] * spec["batch"]
        edges = spec["n_edges"] * spec["batch"]
    else:
        nodes, edges = spec["n_nodes"], spec["n_edges"]
    m = _dp_size(mesh)
    return _pad_to(nodes, m), _pad_to(edges, m)


def _gnn_cell(arch, shape_name, spec, mesh, cfg) -> Cell:
    n, e = _gnn_sizes(spec, mesh)
    cfg = dataclasses.replace(cfg, d_in=spec["d_feat"],
                              d_out=max(spec["n_classes"], 2))
    dp = pt.dp_axes(mesh)
    rep = NamedSharding(mesh, P())
    p_abs = _abstract_params(gnn.init_params, cfg)
    p_shard = pt.gnn_param_sharding(p_abs, mesh,
                                    shard_input=shape_name == "ogb_products")
    params_in = _shard_tree(p_abs, p_shard)
    o_shard = _opt_sharding(p_shard, mesh, p_abs)
    opt_in = _shard_tree(_opt_abstract(p_abs), o_shard)
    x = _sds((n, spec["d_feat"]), torch.float32,
             NamedSharding(mesh, P(dp, None)))
    edges = _sds((2, e), torch.int32, NamedSharding(mesh, P(None, dp)))
    labels = _sds((n,), torch.int32, NamedSharding(mesh, P(dp)))
    mask = _sds((n,), torch.bool, NamedSharding(mesh, P(dp)))

    def loss_fn(params, x, edges, labels, mask):
        return gnn.nll_loss(params, x, edges, labels, mask, cfg)

    def real(device, seed):
        p = gnn.init_params(cfg, seed=seed, device=device)
        g = _gen(device, seed + 1)
        return (p, optim.init_state(p), _normal(g, (n, spec["d_feat"])),
                _ints(g, n, (2, e)), _ints(g, cfg.d_out, (n,)),
                _ints(g, 2, (n,)).bool())

    return Cell(arch, shape_name, _train_step(loss_fn, optim.AdamWConfig()),
                (params_in, opt_in, x, edges, labels, mask), real,
                out_shardings=(p_shard, o_shard, rep, None))


# ---------------------------------------------------------------------------
# GraphCast cells
# ---------------------------------------------------------------------------

def _graphcast_cell(arch, shape_name, spec, mesh, cfg) -> Cell:
    n, e = _gnn_sizes(spec, mesh)
    n_mesh = max(n // 4, 16)
    n_bip = 4 * n
    dp = pt.dp_axes(mesh)
    rep = NamedSharding(mesh, P())
    p_abs = _abstract_params(graphcast.init_params, cfg)
    p_shard = pt.graphcast_param_sharding(p_abs, mesh)
    params_in = _shard_tree(p_abs, p_shard)
    o_shard = _opt_sharding(p_shard, mesh, p_abs)
    opt_in = _shard_tree(_opt_abstract(p_abs), o_shard)
    edge_spec = NamedSharding(mesh, P(None, dp))
    gx = _sds((n, cfg.n_vars), torch.float32,
              NamedSharding(mesh, P(dp, None)))
    g2m = _sds((2, n_bip), torch.int32, edge_spec)
    me = _sds((2, e), torch.int32, edge_spec)
    m2g = _sds((2, n_bip), torch.int32, edge_spec)
    target = _sds((n, cfg.n_vars), torch.float32,
                  NamedSharding(mesh, P(dp, None)))

    def loss_fn(params, gx, g2m, me, m2g, target):
        return graphcast.mse_loss(params, gx, target, g2m, me, m2g, n_mesh,
                                  cfg)

    def real(device, seed):
        p = graphcast.init_params(cfg, seed=seed, device=device)
        # random weights summed over a mean in-degree of ~16 at every one
        # of 16 processor layers grow the activations ~16^8-fold and the
        # step's gradient norm overflows; the MLP branches that feed a sum
        # are scaled by 1 / in-degree, as a trained model keeps them small
        for key, deg in (("proc_edge", e / n_mesh),
                         ("g2m_edge", n_bip / n_mesh)):
            p[key]["w2"].mul_(1.0 / max(deg, 1.0))
        g = _gen(device, seed + 1)
        grid_mesh = torch.stack([_ints(g, n, (n_bip,)),
                                 _ints(g, n_mesh, (n_bip,))])
        mesh_grid = torch.stack([_ints(g, n_mesh, (n_bip,)),
                                 _ints(g, n, (n_bip,))])
        return (p, optim.init_state(p), _normal(g, (n, cfg.n_vars)), grid_mesh,
                _ints(g, n_mesh, (2, e)), mesh_grid,
                _normal(g, (n, cfg.n_vars)))

    return Cell(arch, shape_name, _train_step(loss_fn, optim.AdamWConfig()),
                (params_in, opt_in, gx, g2m, me, m2g, target), real,
                out_shardings=(p_shard, o_shard, rep, None),
                static={"n_mesh": n_mesh})


# ---------------------------------------------------------------------------
# NequIP cells
# ---------------------------------------------------------------------------

def _nequip_cell(arch, shape_name, spec, mesh, cfg) -> Cell:
    n, e = _gnn_sizes(spec, mesh)
    n_graphs = spec.get("batch", 1)
    dp = pt.dp_axes(mesh)
    rep = NamedSharding(mesh, P())
    p_abs = _abstract_params(equivariant.init_params, cfg)
    p_shard = pytree.tree_map(lambda _: rep, p_abs)  # tiny weights: replicate
    params_in = _shard_tree(p_abs, p_shard)
    o_shard = _opt_sharding(p_shard, mesh, p_abs)
    opt_in = _shard_tree(_opt_abstract(p_abs), o_shard)
    species = _sds((n,), torch.int32, NamedSharding(mesh, P(dp)))
    positions = _sds((n, 3), torch.float32, NamedSharding(mesh, P(dp, None)))
    edges = _sds((2, e), torch.int32, NamedSharding(mesh, P(None, dp)))
    gid = _sds((n,), torch.int32, NamedSharding(mesh, P(dp)))
    targets = _sds((n_graphs,), torch.float32, NamedSharding(mesh, P(None)))

    def loss_fn(params, species, positions, edges, gid, targets):
        return equivariant.batched_energy_loss(
            params, species, positions, edges, gid, targets, cfg)

    def real(device, seed):
        p = equivariant.init_params(cfg, seed=seed, device=device)
        g = _gen(device, seed + 1)
        graph_of = (torch.arange(n, device=device) * n_graphs // n)
        return (p, optim.init_state(p), _ints(g, cfg.n_species, (n,)),
                _normal(g, (n, 3)) * 2.0, _ints(g, n, (2, e)),
                graph_of.to(torch.int32), _normal(g, (n_graphs,)))

    return Cell(arch, shape_name, _train_step(loss_fn, optim.AdamWConfig()),
                (params_in, opt_in, species, positions, edges, gid, targets),
                real, out_shardings=(p_shard, o_shard, rep, None))


# ---------------------------------------------------------------------------
# SASRec cells
# ---------------------------------------------------------------------------

def _sasrec_cell(arch, shape_name, spec, mesh, cfg,
                 variant: str = "base") -> Cell:
    dp = pt.dp_axes(mesh)
    rep = NamedSharding(mesh, P())
    p_abs = _abstract_params(sasrec.init_params, cfg)
    p_shard = pt.sasrec_param_sharding(p_abs, mesh)
    params_in = _shard_tree(p_abs, p_shard)

    def params_real(device, seed):
        return sasrec.init_params(cfg, seed=seed, device=device)

    if spec["kind"] == "train":
        o_shard = _opt_sharding(p_shard, mesh, p_abs)
        opt_in = _shard_tree(_opt_abstract(p_abs), o_shard)
        bshape = (spec["batch"], cfg.seq_len)
        bspec = NamedSharding(mesh, P(dp, None))
        seq = _sds(bshape, torch.int32, bspec)
        pos_i = _sds(bshape, torch.int32, bspec)
        neg_i = _sds(bshape, torch.int32, bspec)

        def loss_fn(params, seq, pos_i, neg_i):
            return sasrec.bpr_loss(params, seq, pos_i, neg_i, cfg)

        def real(device, seed):
            p = params_real(device, seed)
            g = _gen(device, seed + 1)
            return (p, optim.init_state(p), _ints(g, cfg.n_items, bshape),
                    _ints(g, cfg.n_items, bshape),
                    _ints(g, cfg.n_items, bshape))

        return Cell(arch, shape_name,
                    _train_step(loss_fn, optim.AdamWConfig()),
                    (params_in, opt_in, seq, pos_i, neg_i), real,
                    out_shardings=(p_shard, o_shard, rep, None))

    if spec["kind"] in ("serve", "bulk"):
        b = spec["batch"]
        seq = _sds((b, cfg.seq_len), torch.int32,
                   NamedSharding(mesh, P(dp, None)))
        user_chunk = 512 if spec["kind"] == "bulk" else b

        def serve_step(params, seq):
            state = sasrec.user_state(params, seq, cfg)
            if variant == "opt":
                # catalog stays sharded: shard-local scans + k-wide merge
                def scorer(st):
                    return retrieval.blocked_topk_sharded(
                        st, params["item_embed"], mesh=mesh, axis="model",
                        k=100, block=131072)
            else:
                def scorer(st):
                    return retrieval.blocked_topk(
                        st, params["item_embed"], k=100, block=131072)
            if user_chunk < b:
                states = state.reshape(b // user_chunk, user_chunk, -1)
                outs = [scorer(states[i]) for i in range(b // user_chunk)]
                return tuple(torch.stack(x) for x in zip(*outs))
            return scorer(state)

        def real(device, seed):
            return (params_real(device, seed),
                    _ints(_gen(device, seed + 1), cfg.n_items,
                          (b, cfg.seq_len)))

        return Cell(arch, shape_name, serve_step, (params_in, seq), real)

    # retrieval_cand: 1 query x 1M candidates through STREAK early-out top-k
    n_items = cfg.n_items
    block = 65536
    nb = -(-n_items // block)
    seq = _sds((spec["batch"], cfg.seq_len), torch.int32,
               NamedSharding(mesh, P(None, None)))
    items_sorted = _sds((n_items, cfg.embed_dim), torch.float32,
                        NamedSharding(mesh, P("model", None)))
    item_order = _sds((n_items,), torch.int32,
                      NamedSharding(mesh, P("model")))
    if variant == "opt":
        # shard-local early-out scans + one k-wide merge; bounds sharded
        # with their blocks
        bounds = _sds((nb,), torch.float32, NamedSharding(mesh, P("model")))

        def retrieval_step(params, seq, items_sorted, item_order, bounds):
            state = sasrec.user_state(params, seq, cfg)
            return retrieval.streak_topk_sharded(
                state, items_sorted, item_order, bounds, mesh=mesh,
                axis="model", k=100, block=block)
    else:
        bounds = _sds((nb,), torch.float32, rep)

        def retrieval_step(params, seq, items_sorted, item_order, bounds):
            state = sasrec.user_state(params, seq, cfg)
            return retrieval.streak_topk(state, items_sorted, item_order,
                                         bounds, k=100, block=block)

    def real(device, seed):
        p = params_real(device, seed)
        g = _gen(device, seed + 1)
        items, order = retrieval.sort_items_by_norm(p["item_embed"], block)
        return (p, _ints(g, n_items, (spec["batch"], cfg.seq_len)), items,
                order.to(torch.int32), retrieval.block_bounds(items, block))

    return Cell(arch, shape_name, retrieval_step,
                (params_in, seq, items_sorted, item_order, bounds), real)


# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_name: str, mesh, variant: str = "base",
               cfg=None, spec=None) -> Cell:
    """The cell of (arch, shape_name) on `mesh` (a `launch.mesh.Mesh`).
    `cfg` and `spec` replace the arch's config and the shape's spec (the
    tests run smoke configs at small shapes)."""
    a = registry.get(arch)
    spec = a.shapes[shape_name] if spec is None else spec
    cfg = a.config if cfg is None else cfg
    fam = a.family
    if fam in ("lm", "moe"):
        return _lm_cell(arch, shape_name, spec, mesh, cfg, variant)
    if fam == "gnn":
        return _gnn_cell(arch, shape_name, spec, mesh, cfg)
    if fam == "graphcast":
        return _graphcast_cell(arch, shape_name, spec, mesh, cfg)
    if fam == "nequip":
        return _nequip_cell(arch, shape_name, spec, mesh, cfg)
    if fam == "recsys":
        return _sasrec_cell(arch, shape_name, spec, mesh, cfg, variant)
    raise ValueError(fam)


def variants(arch: str, shape_name: str) -> tuple:
    """The variants a cell has: base everywhere; opt for the LM train,
    prefill and decode cells and the SASRec serve and retrieval cells;
    opt2 for the LM train cells."""
    a = registry.get(arch)
    kind = a.shapes[shape_name]["kind"]
    if a.family in ("lm", "moe"):
        return ("base", "opt", "opt2") if kind == "train" else ("base", "opt")
    if a.family == "recsys" and kind != "train":
        return ("base", "opt")
    return ("base",)

"""Port vs reference: catalog-sharded STREAK retrieval
(`streak_topk_sharded`, `blocked_topk_sharded`).

The reference runs on 4 forced host devices in one subprocess
(`test_torch_mesh.run_reference`), over `make_host_mesh(1, S)` for S = 1,
2, 4 and over a (2, 2) mesh whose "data" axis replicates; the port runs the
same shapes over meshes that name `torch.device("cpu")` at every position.
Ids, scores and blocks read must be equal, with no tolerance: the merge is
the reference's `lax.top_k`, the lower shard first among equal scores. The
integer catalog is full of ties.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as pmesh
from repro_torch.launch.mesh import NamedSharding, PartitionSpec as P
from repro_torch.serve import retrieval
from test_torch_mesh import run_reference

CPU = torch.device("cpu")
N, D, B, BLOCK = 512, 16, 3, 64
MESHES = [(1, 1), (1, 2), (1, 4), (2, 2)]
CATALOGS = ("float", "ties")
KS = (8,)


def catalog(kind: str):
    """(state (B, D), items (N, D)) f32 from a seed: normal rows with norms
    spread over two decades, or small integers full of equal scores."""
    rng = np.random.default_rng(7)
    if kind == "ties":
        items = rng.integers(-1, 3, (N, D)).astype(np.float32)
        state = rng.integers(0, 2, (B, D)).astype(np.float32)
    else:
        items = (rng.normal(size=(N, D))
                 * np.exp(rng.normal(size=(N, 1)))).astype(np.float32)
        state = rng.normal(size=(B, D)).astype(np.float32)
    return state, items


REFERENCE = r"""
import jax.numpy as jnp
from repro.launch import mesh as M
from repro.serve import retrieval as R
N, D, B, BLOCK = %(n)d, %(d)d, %(b)d, %(block)d
ans = {}
for kind in %(catalogs)r:
    rng = np.random.default_rng(7)
    if kind == "ties":
        items = rng.integers(-1, 3, (N, D)).astype(np.float32)
        state = rng.integers(0, 2, (B, D)).astype(np.float32)
    else:
        items = (rng.normal(size=(N, D))
                 * np.exp(rng.normal(size=(N, 1)))).astype(np.float32)
        state = rng.normal(size=(B, D)).astype(np.float32)
    st, it = jnp.asarray(state), jnp.asarray(items)
    srt, order = R.sort_items_by_norm(it, BLOCK)
    bounds = R.block_bounds(srt, BLOCK)
    for k in %(ks)r:
        s, i, bi = R.streak_topk(st, srt, order, bounds, k=k, block=BLOCK)
        ans[f"{kind}_{k}_streak"] = np.concatenate(
            [np.asarray(s), np.asarray(i).astype(np.float32)], 1)
        ans[f"{kind}_{k}_streak_read"] = np.asarray(bi)
        for data, model in %(meshes)r:
            mesh = M.make_host_mesh(data, model)
            tag = f"{kind}_{k}_{data}x{model}"
            s, i, bi = R.streak_topk_sharded(st, srt, order, bounds, mesh,
                                             k=k, block=BLOCK)
            ans[tag + "_streak_s"] = np.asarray(s)
            ans[tag + "_streak_i"] = np.asarray(i)
            ans[tag + "_streak_read"] = np.asarray(bi)
            s, i = R.blocked_topk_sharded(st, it, mesh, k=k, block=BLOCK)
            ans[tag + "_blocked_s"] = np.asarray(s)
            ans[tag + "_blocked_i"] = np.asarray(i)
np.savez(OUT, **ans)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    code = REFERENCE % dict(n=N, d=D, b=B, block=BLOCK, catalogs=CATALOGS,
                            ks=KS, meshes=MESHES)
    return run_reference(code, tmp_path_factory.mktemp("retr") / "ref.npz")


def port_inputs(kind: str):
    state, items = (torch.from_numpy(x) for x in catalog(kind))
    srt, order = retrieval.sort_items_by_norm(items, BLOCK)
    return state, items, srt, order, retrieval.block_bounds(srt, BLOCK)


def cpu_mesh(data: int, model: int):
    return pmesh.make_host_mesh(data, model, devices=[CPU] * (data * model))


@pytest.mark.parametrize("kind", CATALOGS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("data,model", MESHES)
def test_streak_topk_sharded_matches_reference(ref, kind, k, data, model):
    state, _, srt, order, bounds = port_inputs(kind)
    tag = f"{kind}_{k}_{data}x{model}"
    s, i, read = retrieval.streak_topk_sharded(
        state, srt, order, bounds, cpu_mesh(data, model), k=k, block=BLOCK)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), ref[tag + "_streak_s"])
    np.testing.assert_array_equal(i.numpy(), ref[tag + "_streak_i"])
    assert read == int(ref[tag + "_streak_read"])


@pytest.mark.parametrize("kind", CATALOGS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("data,model", MESHES)
def test_blocked_topk_sharded_matches_reference(ref, kind, k, data, model):
    state, items, *_ = port_inputs(kind)
    tag = f"{kind}_{k}_{data}x{model}"
    s, i = retrieval.blocked_topk_sharded(state, items,
                                          cpu_mesh(data, model), k=k,
                                          block=BLOCK)
    np.testing.assert_array_equal(s.numpy(), ref[tag + "_blocked_s"])
    np.testing.assert_array_equal(i.numpy(), ref[tag + "_blocked_i"])


@pytest.mark.parametrize("kind", CATALOGS)
def test_sharded_reads_fewer_blocks_and_answers_as_unsharded(ref, kind):
    """On 4 shards a shard reads fewer of its blocks than the unsharded
    scan reads of all of them (the early out per shard, the `pmax`), and
    every sharded top-k's scores equal the unsharded one's."""
    state, _, srt, order, bounds = port_inputs(kind)
    k = KS[0]
    s1, _, read1 = retrieval.streak_topk(state, srt, order, bounds, k=k,
                                         block=BLOCK)
    assert read1 == int(ref[f"{kind}_{k}_streak_read"])
    s4, _, read4 = retrieval.streak_topk_sharded(
        state, srt, order, bounds, cpu_mesh(1, 4), k=k, block=BLOCK)
    assert torch.equal(s4, s1)
    assert read4 <= read1


def test_resident_shards_are_used_as_they_lie():
    """Inputs already laid out P("model") over the mesh are not cut again:
    the blocks each shard scans are the resident ones."""
    state, items, srt, order, bounds = port_inputs("float")
    mesh = cpu_mesh(1, 4)
    # copies: cutting the originals again would give other blocks
    put = {n: pmesh.device_put(x.clone(), NamedSharding(mesh, P("model")))
           for n, x in dict(srt=srt, order=order, bounds=bounds,
                            items=items).items()}
    seen = []
    streak = retrieval.streak_topk

    def spy(state_, items_, *a, **kw):
        seen.append(items_.data_ptr())
        return streak(state_, items_, *a, **kw)
    retrieval.streak_topk = spy
    try:
        got = retrieval.streak_topk_sharded(state, put["srt"], put["order"],
                                            put["bounds"], mesh, k=8,
                                            block=BLOCK)
    finally:
        retrieval.streak_topk = streak
    assert seen == [b.data_ptr() for b in put["srt"].along("model")]
    want = retrieval.streak_topk_sharded(state, srt, order, bounds, mesh,
                                         k=8, block=BLOCK)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
    got_b = retrieval.blocked_topk_sharded(state, put["items"], mesh, k=8,
                                           block=BLOCK)
    want_b = retrieval.blocked_topk_sharded(state, items, mesh, k=8,
                                            block=BLOCK)
    assert all(torch.equal(a, b) for a, b in zip(got_b, want_b))


def test_sizes_the_shards_do_not_divide_raise():
    state, items = (torch.from_numpy(x) for x in catalog("float"))
    mesh = cpu_mesh(1, 4)
    with pytest.raises(ValueError, match="divisible by 4"):
        retrieval.blocked_topk_sharded(state, items[:510], mesh, k=8)
    srt, order = retrieval.sort_items_by_norm(items[:448], BLOCK)
    bounds = retrieval.block_bounds(srt, BLOCK)              # 7 blocks
    with pytest.raises(ValueError, match="divisible by 4"):
        retrieval.streak_topk_sharded(state, srt, order, bounds, mesh, k=8,
                                      block=BLOCK)

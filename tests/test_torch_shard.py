"""Port vs reference: the Morton-prefix sharded store (the twins of
`tests/test_shard.py`).

Both packages shard the same `make_lgd` store into S = 1, 2, 4, 8
Morton-prefix ranges. The port's shards must equal the reference's array
for array, and its sharded engine (on ``device="cpu"``, where the kernel
backends run their plain torch versions) must answer as the reference's
sharded engine does: rows, scores, order, `plan_log` and `ExecStats`, with
no tolerance. Its answers must also equal the port's unsharded engine's
(rows, scores, order: a sharded run logs one APS decision a shard, so its
`plan_log` is its own). The "fused" policy is the reference test's
(fused join, kcap "auto"); on the port it also runs the Phase-1 descent
on its kernel, so S > 1 goes through `ops.tree_descend_sharded`, one call
a SIP window. The reference keeps its host frontier there: its descent
backends agree bit for bit, and its `shard_map` route compiles anew at
every call on the CPU (`test_torch_fault.py` holds the port's sharded
call counts to that route's on a smaller store). The Bloom probes and
rank pass stay on numpy (their kernels are held to the reference in
`test_torch_engine_probe_rank.py`).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import fault as ref_fault
from repro.core import shard as ref_shard
from repro.data import synth_rdf as ref_synth
from repro.kernels import ops as ref_ops
from repro_torch.core import fault
from repro_torch.core import shard as port_shard
from repro_torch.core.squadtree import PackedEList
from repro_torch.data import synth_rdf as port_synth
from repro_torch.interop import PACKED_FIELDS, TREE_FIELDS, store_from_state
from repro_torch.kernels import ops
from repro_torch.serve import spatial as port_serve
from test_torch_serve_spatial import assert_same_serve
from test_torch_store import assert_states_equal, state_of

SHARD_COUNTS = (1, 2, 4, 8)
POLICIES = {"numpy": {}, "fused": dict(join="fused", kcap="auto")}
# the port's extra stages per policy: the descent on its kernel
PORT_EXTRA = {"numpy": {}, "fused": dict(descend="kernel")}


@pytest.fixture(scope="module")
def ds():
    build = dict(n_per_class=400, seed=1, block=256)
    return ref_synth.make_lgd(**build), port_synth.make_lgd(**build)


@pytest.fixture(scope="module")
def sharded(ds):
    """S -> (reference sharded store, port sharded store)."""
    return {n: (ref_shard.shard_store(ds[0].store, n),
                port_shard.shard_store(ds[1].store, n))
            for n in SHARD_COUNTS}


@pytest.fixture(scope="module")
def ref_answers():
    """Reference answers, computed once per key."""
    return {}


def engine(pkg, store, policy):
    port = pkg is repro_torch
    cfg = pkg.ExecConfig(policy=pkg.BackendPolicy(
        **POLICIES[policy], **(PORT_EXTRA[policy] if port else {})))
    return pkg.StreakEngine(store, cfg, **(dict(device="cpu") if port
                                           else {}))


def assert_same_answer(got, want, stats=True):
    """Equal scores and rows, in order; with `stats`, the same column order
    and `ExecStats` too (a sharded run's relation may list its columns in
    another order than an unsharded one's, as the reference's does)."""
    np.testing.assert_array_equal(got[0], want[0])
    if stats:
        assert list(got[1]) == list(want[1])
    assert sorted(got[1]) == sorted(want[1])
    for c in want[1]:
        np.testing.assert_array_equal(got[1][c], want[1][c])
    if stats:
        assert dataclasses.asdict(got[2]) == dataclasses.asdict(want[2])


def sharded_state_of(store) -> dict:
    """`state_of` plus every shard's tree arrays, Bloom banks, CS stats,
    packed E-list tier and id range, in `store_from_state`'s layout."""
    st = state_of(store)
    for i, sh in enumerate(store.tree_shards):
        t, pre = sh.tree, f"tree_shards.{i}"
        st[f"{pre}.id_lo"], st[f"{pre}.id_hi"] = sh.id_lo, sh.id_hi
        for f in TREE_FIELDS:
            st[f"{pre}.{f}"] = getattr(t, f)
        for w in ("self", "in", "out"):
            st[f"{pre}.bloom_{w}.bits"] = getattr(t, f"bloom_{w}").bits
            st[f"{pre}.bloom_{w}.k"] = getattr(t, f"bloom_{w}").k
        for c in ("offsets", "cs_ids", "counts"):
            st[f"{pre}.cs_stats.{c}"] = getattr(t.cs_stats, c)
        if t.packed is not None:
            for f in PACKED_FIELDS:
                st[f"{pre}.packed.{f}"] = getattr(t.packed, f)
            st[f"{pre}.packed.rank"] = int(t.packed.src is not None)
    return st


# ------------------------------------------------------------- partition ---
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_shards_partition_object_space(ds, sharded, n_shards):
    """Shard object ranges are disjoint, ordered, and cover obj_ids."""
    st = sharded[n_shards][1]
    assert isinstance(st, repro_torch.ShardedQuadStore)
    assert st.n_shards == n_shards
    cat = np.concatenate([sh.tree.obj_ids for sh in st.tree_shards])
    np.testing.assert_array_equal(cat, ds[1].store.tree.obj_ids)
    for sh in st.tree_shards:
        assert sh.id_lo == sh.tree.obj_ids[0]
        assert sh.id_hi == sh.tree.obj_ids[-1]
        # the shard trees are their own objects: no device copy of theirs
        # can alias the global tree's
        assert sh.tree is not st.tree
        assert sh.tree.bloom_self is not st.tree.bloom_self
    his = [sh.id_hi for sh in st.tree_shards]
    los = [sh.id_lo for sh in st.tree_shards]
    assert all(h < lo for h, lo in zip(his[:-1], los[1:]))


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_shard_store_matches_reference(sharded, n_shards):
    """The port's shards equal the reference's, field by field."""
    ref, port = sharded[n_shards]
    assert_states_equal(sharded_state_of(port), sharded_state_of(ref))
    for p, r in zip(port.tree_shards, ref.tree_shards):
        assert (p.id_lo, p.id_hi, p.clip) == (r.id_lo, r.id_hi, r.clip)
        assert p.tree.entity_to_id == r.tree.entity_to_id
        assert dataclasses.astuple(p.tree.extent) == \
            dataclasses.astuple(r.tree.extent)
        assert p.tree.l_max == r.tree.l_max
        np.testing.assert_array_equal(p.tree.level_order, r.tree.level_order)
    assert port.shard_tree_nbytes() == ref.shard_tree_nbytes()


def test_shard_views_unsharded_is_single_noclip(ds):
    views = port_shard.shard_views(ds[1].store)
    assert len(views) == 1 and not views[0].clip
    assert views[0].tree is ds[1].store.tree


# ------------------------------------------- shard-count invariance --------
@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_results_match_reference(ds, sharded, ref_answers, n_shards, policy):
    ref_store, port_store = sharded[n_shards]
    whole = engine(repro_torch, ds[1].store, policy)
    eng = engine(repro_torch, port_store, policy)
    ref_eng = engine(repro, ref_store, policy)
    plan = fault.FaultPlan()
    for qi, q in enumerate(ds[1].queries):
        with fault.fault_plan(plan):
            got = eng.execute(q)
        key = ("run", n_shards, policy, qi)
        if key not in ref_answers:
            ref_answers[key] = ref_eng.execute(ds[0].queries[qi])
        assert_same_answer(got, ref_answers[key])
        assert_same_answer(got, whole.execute(q), stats=False)
    if policy == "fused":
        # S > 1: one sharded descent a SIP window and no per-shard one
        descents = (plan.calls.get("tree_descend_sharded", 0),
                    plan.calls.get("tree_descend", 0))
        assert descents[n_shards == 1] > 0 and not descents[n_shards > 1]


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_deadline_anytime_answer_invariant(ds, sharded, ref_answers,
                                           n_shards):
    """A block-budget deadline truncates at the same block on every shard
    count: the partial answer and its certified bound equal the unsharded
    port's and the sharded reference's."""
    ref_store, port_store = sharded[n_shards]
    whole = engine(repro_torch, ds[1].store, "numpy")
    eng = engine(repro_torch, port_store, "numpy")
    ref_eng = engine(repro, ref_store, "numpy")
    hit_partial = False
    for qi, q in enumerate(ds[1].queries):
        for blocks in (1, 2):
            got = eng.execute(q, deadline=fault.QueryDeadline(
                max_blocks=blocks))
            want = whole.execute(q, deadline=fault.QueryDeadline(
                max_blocks=blocks))
            assert_same_answer(got, want, stats=False)
            for f in ("partial", "deadline_expired", "score_bound"):
                assert getattr(got[2], f) == getattr(want[2], f)
            key = ("deadline", n_shards, qi, blocks)
            if key not in ref_answers:
                ref_answers[key] = ref_eng.execute(
                    ds[0].queries[qi],
                    deadline=ref_fault.QueryDeadline(max_blocks=blocks))
            assert_same_answer(got, ref_answers[key])
            hit_partial |= got[2].partial
    assert hit_partial, "deadline never truncated: test is vacuous"


@pytest.mark.parametrize("n_shards", (2, 8))
def test_serve_loop_matches_serial_on_sharded_store(ds, sharded, n_shards):
    """The serving loop on a sharded store answers as serial execution on
    the unsharded store, and as the reference's loop on its sharded store,
    request by request and counter by counter."""
    from repro.serve import spatial as ref_serve
    runs = []
    for pkg, mod, store, d in ((repro, ref_serve, sharded[n_shards][0],
                                ds[0]),
                               (repro_torch, port_serve,
                                sharded[n_shards][1], ds[1])):
        eng = engine(pkg, store, "fused")
        extra = dict(device="cpu") if pkg is repro_torch else {}
        srv = mod.SpatialServeEngine(store, eng.config, max_slots=4, **extra)
        runs.append((srv, srv.serve(list(d.queries[:4]))))
    assert_same_serve(*runs)
    serial = engine(repro_torch, ds[1].store, "fused")
    for req, q in zip(runs[1][1], ds[1].queries[:4]):
        assert req.done and req.error is None
        scores, rows, _ = serial.execute(q)
        np.testing.assert_array_equal(req.scores, scores)
        assert req.rows.n == rows.n


def test_sip_disabled_collapses_to_whole_view(ds, sharded):
    """With SIP off there is no interval clip, so the cursor falls back to
    ONE global view, and still matches the unsharded engine."""
    cfg = repro_torch.ExecConfig(use_sip=False)
    eng0 = repro_torch.StreakEngine(ds[1].store, cfg, device="cpu")
    eng1 = repro_torch.StreakEngine(sharded[4][1], cfg, device="cpu")
    q = ds[1].queries[0]
    cur = eng1.cursor(q)
    assert len(cur.shards) == 1 and not cur.shards[0].clip
    assert cur.shards[0].tree is ds[1].store.tree
    assert_same_answer(eng1.execute(q), eng0.execute(q))


# ------------------------------------------------- compressed E-list tier --
def test_packed_elist_roundtrip(ds):
    tree = ds[1].store.tree
    ref_ids = tree.elist_ids.copy()
    ref_off = tree.elist_offsets
    t2 = copy.copy(tree)
    t2.elist_ids = ref_ids.copy()
    t2.packed = None
    t2.pack_elists()
    pk = t2.packed
    assert pk.src is not None, "tree-owned ids must pack in rank mode"
    np.testing.assert_array_equal(pk.decode(np.arange(len(pk.nodes))),
                                  ref_ids)
    rng = np.random.default_rng(0)
    sub = rng.permutation(len(pk.nodes))[:25]
    want = np.concatenate([ref_ids[ref_off[n]:ref_off[n + 1]]
                           for n in pk.nodes[sub]])
    np.testing.assert_array_equal(pk.decode(sub), want)
    for node in pk.nodes[:64]:
        a, b = ref_off[node], ref_off[node + 1]
        np.testing.assert_array_equal(t2.elist(int(node)), ref_ids[a:b])
        assert t2.elist_size(int(node)) == b - a


def test_packed_elist_raw_fallback():
    """Ids absent from the src array fall back to raw-id gap packing and
    still decode exactly, as the reference's do."""
    from repro.core.squadtree import PackedEList as RefPacked
    offsets = np.array([0, 3, 3, 7], dtype=np.int64)
    ids = np.array([10, 1 << 40, (1 << 40) + 5,
                    7, 9, 1 << 50, (1 << 50) + 1], dtype=np.int64)
    src = np.array([1, 2, 3], dtype=np.int64)      # contains none of them
    pk = PackedEList.encode(offsets, ids, src)
    assert pk.src is None
    np.testing.assert_array_equal(pk.decode(np.arange(len(pk.nodes))), ids)
    want = RefPacked.encode(offsets, ids, src)
    for f in PACKED_FIELDS:
        np.testing.assert_array_equal(getattr(pk, f), getattr(want, f))


def test_plain_and_packed_tiers_answer_alike(ds, sharded):
    """Shards built without the packed tier answer as the packed ones, and
    the packed tier holds fewer bytes."""
    plain = port_shard.shard_store(ds[1].store, 4, compressed=False)
    packed = sharded[4][1]
    assert all(sh.tree.packed is None for sh in plain.tree_shards)
    packed_b = sum(sh.tree.packed.nbytes() for sh in packed.tree_shards)
    plain_b = sum(sh.tree.elist_ids.nbytes for sh in plain.tree_shards)
    assert packed_b < plain_b
    e0, e1 = (engine(repro_torch, s, "fused") for s in (plain, packed))
    for q in ds[1].queries:
        assert_same_answer(e1.execute(q), e0.execute(q))


# ------------------------------------------------- the sharded descent ----
def _stacked_inputs(seed, sizes=(37, 50, 11), nb=3, m=9):
    """Random stacked node planes with pad columns, root-path masks False on
    them, and shared box keys with ragged padding rows."""
    rng = np.random.default_rng(seed)
    n_max = max(sizes)
    planes = np.empty((len(sizes), 4, n_max), dtype=np.int64)
    planes[:] = ops.DESCEND_PAD_BOX[None, :, None]
    cs = np.zeros((len(sizes), n_max), dtype=bool)
    for si, n in enumerate(sizes):
        lo = rng.random((n, 2))
        mbr = np.concatenate([lo, lo + 0.2 * rng.random((n, 2))], axis=1)
        planes[si, :, :n] = ops.f64_sort_keys(np.ascontiguousarray(mbr.T))
        cs[si, :n] = rng.random(n) < 0.8
    lo = rng.random((nb, m, 2))
    boxes = np.concatenate([lo, lo + 0.1 * rng.random((nb, m, 2))], axis=2)
    keys = ops.f64_sort_keys(boxes)
    keys[:, m - 2:] = ops.DESCEND_PAD_BOX
    return planes, cs, keys


@pytest.mark.parametrize("seed", range(3))
def test_tree_descend_sharded_matches_reference(seed):
    """The port's sharded descent (its plain version here) against the
    reference's interpret-mode Pallas kernel under `shard_map`, and its
    per-shard fallback against both."""
    planes, cs, keys = _stacked_inputs(seed)
    want = ref_ops.tree_descend_sharded(planes, cs, keys,
                                        backend="interpret")
    args = tuple(torch.from_numpy(x) for x in (planes, cs, keys))
    got = ops.tree_descend_sharded(*args)
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # a transposed view of (4, S, N) planes, as core/shard keeps them
    view = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    np.testing.assert_array_equal(
        ops.tree_descend_sharded(view, *args[1:]).numpy(), want)
    plan = fault.FaultPlan(rules=(fault.FaultRule(op="tree_descend_sharded"),))
    with fault.fault_plan(plan):
        fallback = ops.tree_descend_sharded(*args)
    assert plan.calls == {"tree_descend_sharded": 1,
                          "tree_descend": planes.shape[0]}
    np.testing.assert_array_equal(fallback.numpy(), want)
    fault.STATE.reset()


def test_stacked_planes_built_once_per_device(sharded):
    """The stacked descent planes are made once per shard set, device and
    span of shards and are exactly each shard tree's own key planes,
    padded."""
    shards = port_shard.shard_views(sharded[4][1])
    a = port_shard.stacked_node_planes(shards, torch.device("cpu"))
    b = port_shard.stacked_node_planes(
        port_shard.shard_views(sharded[4][1]), torch.device("cpu"))
    assert a.data_ptr() == b.data_ptr()
    assert list(sharded[4][1].tree_shards.planes) == [
        (torch.device("cpu"), 0, 4)]
    assert a.transpose(0, 1).is_contiguous()
    for si, sh in enumerate(shards):
        n = sh.tree.n_nodes
        np.testing.assert_array_equal(
            a[si, :, :n].numpy(),
            sh.tree._node_key_planes(torch.device("cpu")).numpy())
        assert (a[si, :, n:].numpy() == ops.DESCEND_PAD_BOX[:, None]).all()



# ------------------------------------ the sharded descent over a mesh ----
MESH_SIZES = {4: (37, 50, 11, 64), 8: (37, 50, 11, 64, 9, 80, 21, 3)}
MESH_REFERENCE = r"""
from repro.kernels import ops as ref_ops
ans = {}
for s, sizes in %(sizes)r.items():
    for seed in range(2):
        planes, cs, keys = _stacked_inputs(seed, sizes)
        ans[f"{s}_{seed}"] = ref_ops.tree_descend_sharded(
            planes, cs, keys, backend="interpret")
np.savez(OUT, **ans)
"""


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    """The reference's `shard_map` route on 4 forced host devices:
    `make_shard_mesh(S)` has 4 positions at S = 4 and S = 8."""
    import inspect
    from test_torch_mesh import run_reference
    helper = inspect.getsource(_stacked_inputs).replace(
        "ops.", "ref_ops.")
    code = ("from repro.kernels import ops as ref_ops\n" + helper
            + MESH_REFERENCE % dict(sizes=MESH_SIZES))
    return run_reference(code, tmp_path_factory.mktemp("descent") / "r.npz")


@pytest.mark.parametrize("n_pos", (1, 2, 4))
@pytest.mark.parametrize("n_shards", sorted(MESH_SIZES))
@pytest.mark.parametrize("seed", range(2))
def test_tree_descend_sharded_over_a_mesh_matches_reference(
        mesh_ref, n_pos, n_shards, seed):
    """`ops.tree_descend_sharded` called once a position of a 1-, 2- or
    4-position shard mesh (the CPU at every position) over its P("shard")
    planes (`shard.descend_over_mesh`) equals the single call and the
    reference's `shard_map` route over 4 devices; each position's per-shard
    fallback too."""
    from repro_torch.launch import mesh as pmesh
    planes, cs, keys = _stacked_inputs(seed, MESH_SIZES[n_shards])
    args = tuple(torch.from_numpy(x) for x in (planes, cs, keys))
    mesh = pmesh.make_shard_mesh(n_shards, devices=[torch.device("cpu")]
                                 * n_pos)
    assert mesh.shape["shard"] == n_pos
    placed = pmesh.device_put(args[0], pmesh.NamedSharding(
        mesh, pmesh.PartitionSpec("shard")))
    got = port_shard.descend_over_mesh(placed, *args[1:])
    want = mesh_ref[f"{n_shards}_{seed}"]
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ops.tree_descend_sharded(*args))
    plan = fault.FaultPlan(rules=(fault.FaultRule(op="tree_descend_sharded"),))
    with fault.fault_plan(plan):
        fallback = port_shard.descend_over_mesh(placed, *args[1:])
    assert plan.calls == {"tree_descend_sharded": n_pos,
                          "tree_descend": n_shards}
    np.testing.assert_array_equal(fallback.numpy(), want)
    fault.STATE.reset()


def test_tree_descend_sharded_refuses_an_unsplit_layout():
    from repro_torch.launch import mesh as pmesh
    planes, cs, keys = (torch.from_numpy(x) for x in _stacked_inputs(0))
    mesh = pmesh.make_shard_mesh(3, devices=[torch.device("cpu")] * 3)
    whole = pmesh.device_put(planes, pmesh.NamedSharding(
        mesh, pmesh.PartitionSpec()))
    with pytest.raises(ValueError, match="needs P"):
        port_shard.descend_over_mesh(whole, cs, keys)


def test_descent_over_two_devices_keeps_each_call_on_its_device():
    """A shard mesh whose two positions lie on different devices (the CPU
    and `meta`, which holds no values): each position's call gets its
    planes, its shards' cs_path rows and the boxes all on its own device,
    and the masks come back in shard order on the boxes' device. The stub
    wrapper answers each call from the CPU copy of the same shards."""
    from repro_torch.launch import mesh as pmesh
    planes, cs, keys = (torch.from_numpy(x)
                        for x in _stacked_inputs(0, MESH_SIZES[4]))
    mesh = pmesh.make_shard_mesh(4, devices=[torch.device("cpu"),
                                             torch.device("meta")])
    placed = pmesh.device_put(planes, pmesh.NamedSharding(
        mesh, pmesh.PartitionSpec("shard")))
    assert [b.device.type for b in placed.along("shard")] == ["cpu", "meta"]
    real, calls = ops.tree_descend_sharded, []

    def stub(node_keys, cs_path, box_keys):
        lo = sum(k for _, k in calls)
        k = node_keys.shape[0]
        calls.append(({t.device.type for t in (node_keys, cs_path,
                                               box_keys)}, k))
        return real(planes[lo:lo + k], cs[lo:lo + k], keys)
    ops.tree_descend_sharded = stub
    try:
        got = port_shard.descend_over_mesh(placed, cs, keys)
    finally:
        ops.tree_descend_sharded = real
    assert calls == [({"cpu"}, 2), ({"meta"}, 2)]
    assert got.device == keys.device
    assert torch.equal(got, real(planes, cs, keys))


@pytest.mark.parametrize("n_shards,n_pos", [(4, 2), (4, 4), (8, 4)])
def test_engine_over_a_shard_mesh_matches_reference(ds, sharded, ref_answers,
                                                    n_shards, n_pos):
    """The sharded engine with its descent laid over a 2- or 4-position
    shard mesh answers as the reference's sharded engine (rows, scores,
    order, `ExecStats`); each position's planes are made once and stay."""
    from repro_torch.launch import mesh as pmesh
    cpu = torch.device("cpu")
    ref_store, port_store = sharded[n_shards]
    store = port_store.on_mesh(pmesh.make_shard_mesh(n_shards,
                                                     devices=[cpu] * n_pos))
    assert store.tree_shards.mesh.shape["shard"] == n_pos
    assert list(store.tree_shards) == list(port_store.tree_shards)
    eng = engine(repro_torch, store, "fused")
    ref_eng = engine(repro, ref_store, "fused")
    launches = []
    over_mesh = port_shard.descend_over_mesh

    def spy(placed, *a):
        launches.append([b.data_ptr() for b in placed.along("shard")])
        return over_mesh(placed, *a)
    port_shard.descend_over_mesh = spy
    try:
        for qi, q in enumerate(ds[1].queries):
            key = ("run", n_shards, "fused", qi)
            if key not in ref_answers:
                ref_answers[key] = ref_eng.execute(ds[0].queries[qi])
            assert_same_answer(eng.execute(q), ref_answers[key])
    finally:
        port_shard.descend_over_mesh = over_mesh
    per = n_shards // n_pos
    assert sorted(store.tree_shards.planes) == [
        (cpu, i * per, (i + 1) * per) for i in range(n_pos)]
    assert launches and all(ptrs == launches[0] for ptrs in launches)

# ------------------------------------------------------- carried state ----
def test_store_from_state_carries_a_sharded_store(ds, sharded):
    """A reference sharded store's arrays give the port a `ShardedQuadStore`
    equal to the port's own `shard_store`, field by field, that answers
    alike."""
    ref_store, port_store = sharded[4]
    state = sharded_state_of(ref_store)
    carried = store_from_state(state)
    assert isinstance(carried, repro_torch.ShardedQuadStore)
    assert_states_equal(sharded_state_of(carried), state)
    assert_states_equal(sharded_state_of(carried),
                        sharded_state_of(port_store))
    plain = store_from_state(sharded_state_of(
        port_shard.shard_store(ds[1].store, 2, compressed=False)))
    assert all(sh.tree.packed is None for sh in plain.tree_shards)
    e0, e1 = (engine(repro_torch, s, "fused") for s in (port_store, carried))
    for q in ds[1].queries[:4]:
        assert_same_answer(e1.execute(q), e0.execute(q))

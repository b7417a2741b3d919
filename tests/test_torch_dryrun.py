"""Port vs reference: the multi-device dry run (`repro_torch.launch.dryrun`)
and the per-device counts under it (`repro_torch.roofline.op_count` on
DTensors over a fake process group).

Counting: a matmul on a fake (16, 16) mesh counts its local block's FLOPs
(the global count / 256, / 16 or x 1 by placement), a row-parallel product
one all-reduce of the local output, and no op twice.

Against the reference: one subprocess over 4 forced host devices
(`test_torch_mesh.run_reference`) lowers the reference's own step
functions, composed inline from its modules (its `launch/cells.py` does not
import: ROADMAP §3), on a (data=2, model=2) mesh under the shardings the
port's `dist/partitioning` gives, and reads XLA's per-device argument bytes
(`memory_analysis`) and dot FLOPs (`hlo_parse.dot_flops`). The port's
records must equal both exactly; where XLA's partitioner does other dot
work than DTensor, both numbers are pinned here and in ROADMAP §3.

Full size: gemma-7b prefill_32k on the (16, 16) mesh, every field of the
reference's record, its argument bytes from `param_shapes` and the rules.
"""
import json
import math

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch import pytree
from repro_torch.configs import registry
from repro_torch.dist import partitioning as pt
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import (NamedSharding, PartitionSpec as P,
                                     _make_mesh, device_mesh,
                                     fake_process_group, make_production_mesh,
                                     placeholder_devices, to_dtensor)
from repro_torch.models import transformer
from repro_torch.roofline import analysis, op_count

from test_torch_mesh import run_reference

M, K, N = 64, 32, 48


def _count_on_mesh(shape, names, fn, specs, shapes):
    """Count fn over DTensors of `shapes` laid out by `specs` on a fake
    mesh of `shape`."""
    mesh = _make_mesh(shape, names, placeholder_devices(math.prod(shape)))
    with fake_process_group(mesh.size):
        dm = device_mesh(mesh)
        with op_count.fake_mode():
            args = []
            for spec, s in zip(specs, shapes):
                sh = NamedSharding(mesh, spec)
                args.append(to_dtensor(torch.empty(
                    tuple(n // sh.parts(d) for d, n in enumerate(s))),
                    dm, sh, s))
            return op_count.count(fn, *args)


@pytest.mark.parametrize("xspec,wspec,div", [
    (P(), P(), 1),
    (P("data", None), P(), 16),
    (P(None, None), P(None, "model"), 16),
    (P("data", None), P(None, "model"), 256),
])
def test_matmul_flops_are_the_local_blocks(xspec, wspec, div):
    """x (M, K) @ w (K, N): 2·M·N·K over the devices that split it."""
    c = _count_on_mesh((16, 16), ("data", "model"), lambda x, w: x @ w,
                       [xspec, wspec], [(M * 16, K), (K, N * 16)])
    assert c["dot_flops"] == 2 * (M * 16) * (N * 16) * K / div
    assert c["collectives"] == {}


def test_row_parallel_product_is_one_all_reduce():
    """x (M, K) split on K over "model" @ w (K, N) split on K: each device
    multiplies its K-block, and the replicated result is one all-reduce of
    the local (M, N) output."""
    def f(x, w):
        y = x @ w
        return y.redistribute(y.device_mesh, [Replicate(), Replicate()])
    c = _count_on_mesh((16, 16), ("data", "model"), f,
                       [P(None, "model"), P("model", None)],
                       [(M, K * 16), (K * 16, N)])
    assert c["dot_flops"] == 2 * M * N * K
    assert c["collectives"] == {"all-reduce": {"count": 1,
                                               "bytes": 4.0 * M * N}}


def test_no_op_counted_twice():
    """Neither the DTensor-level call nor DTensor's global-shape shape
    propagation is counted: one local tanh reads and writes its block once,
    one replicated product counts 2·M·N·K once."""
    c = _count_on_mesh((16, 16), ("data", "model"), torch.tanh,
                       [P("data", "model")], [(M * 16, K * 16)])
    assert c["hbm_bytes"] == 2 * 4 * M * K and c["dot_flops"] == 0
    c = _count_on_mesh((2, 2), ("data", "model"), lambda x, w: x @ w,
                       [P(), P()], [(M, K), (K, N)])
    assert c["dot_flops"] == 2 * M * N * K
    assert c["hbm_bytes"] == 4 * (M * K + K * N + M * N)


def test_a_data_dependent_loop_counts_one_pass():
    """A while loop on a fake tensor's value runs its body once and the
    count says it answered a test."""
    def f(x):
        n = 0
        while bool((x > 0).any()):
            x = x - 1
            n += 1
        return x, n
    with op_count.fake_mode():
        c = op_count.count(f, torch.empty(8))
    assert c["out"][1] == 1 and c["data_dependent_tests"] == 2


# ------------------------------------------------- against the reference --
SMOKE = {
    "gemma_prefill": ("gemma-7b", "prefill_32k",
                      dict(kind="prefill", seq_len=64, global_batch=4)),
    "gemma_train": ("gemma-7b", "train_4k",
                    dict(kind="train", seq_len=32, global_batch=4)),
    "moe_prefill": ("qwen2-moe-a2.7b", "prefill_32k",
                    dict(kind="prefill", seq_len=64, global_batch=4)),
}
# dot FLOPs where XLA's partitioner and DTensor do different dot work
# (ROADMAP §3): {case: (port, reference)}; empty where they agree
DOT_DIFFERENCES = {}

REFERENCE = r"""
import dataclasses, json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.models import moe, transformer
from repro.roofline import hlo_parse
from repro.train import optim

cases = json.loads(CASES)
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))

def spec(e):
    return P(*[tuple(x) if isinstance(x, list) else x for x in e])

def shard_tree(tree, specs):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    def key(p):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in p)
    leaves = [NamedSharding(mesh, spec(specs[key(p)])) for p, _ in paths]
    return jax.tree.unflatten(jax.tree.structure(tree), leaves)

out = {}
for name, c in cases.items():
    mod = registry.get(c["arch"])
    fam = moe if mod.FAMILY == "moe" else transformer
    cfg = mod.SMOKE
    p_abs = jax.eval_shape(lambda k: fam.init_params(k, cfg),
                           jax.random.PRNGKey(0))
    p_sh = shard_tree(p_abs, c["params"])
    tok_sh = NamedSharding(mesh, spec(c["tokens"]))
    tok = jax.ShapeDtypeStruct(tuple(c["tokens_shape"]), jnp.int32)
    if c["kind"] == "prefill":
        cfg2 = dataclasses.replace(cfg, attn_chunk=2048, remat=True)
        fn = lambda p, t: fam.forward_with_cache(p, t, cfg2)
        args, shard = (p_abs, tok), (p_sh, tok_sh)
    else:
        cfg2 = dataclasses.replace(cfg, batch_axes=("data",),
                                   seq_axes=("model",))
        o_abs = jax.eval_shape(optim.init_state, p_abs)
        o_sh = {"m": shard_tree(o_abs["m"], c["moments"]),
                "v": shard_tree(o_abs["v"], c["moments"]),
                "step": NamedSharding(mesh, P())}
        ocfg = optim.AdamWConfig()
        def fn(p, o, t):
            loss, g = jax.value_and_grad(fam.lm_loss)(p, t, cfg2)
            p, o, m = optim.apply_updates(p, g, o, ocfg)
            return p, o, loss, m
        args, shard = (p_abs, o_abs, tok), (p_sh, o_sh, tok_sh)
    with mesh:
        comp = jax.jit(fn, in_shardings=shard).lower(*args).compile()
    out[name] = dict(
        arg_bytes=int(comp.memory_analysis().argument_size_in_bytes),
        dot_flops=float(hlo_parse.dot_flops(comp.as_text())))
np.savez(OUT, result=np.array(json.dumps(out)))
"""


def _flat_specs(tree) -> dict:
    """{"a/b/0/c": spec entries as JSON} of a tree of Abstract leaves."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = [list(e) if isinstance(e, tuple) else e
                                   for e in node.sharding.spec]
    walk(tree, ())
    return out


@pytest.fixture(scope="module")
def small_mesh():
    return _make_mesh((2, 2), ("data", "model"), placeholder_devices(4))


@pytest.fixture(scope="module")
def against_reference(small_mesh, tmp_path_factory):
    """The port's counts and the reference's XLA figures of the three
    smoke cells on (data=2, model=2)."""
    ours, cases = {}, {}
    for name, (arch, shape, spec) in SMOKE.items():
        cell = cells.build_cell(arch, shape, small_mesh,
                                cfg=registry.get(arch).smoke, spec=spec)
        ours[name] = dryrun.count_cell(cell, small_mesh)
        case = dict(arch=arch, kind=spec["kind"],
                    params=_flat_specs(cell.args[0]),
                    tokens=_flat_specs({"t": cell.args[-1]})["t"],
                    tokens_shape=list(cell.args[-1].shape))
        if spec["kind"] == "train":
            case["moments"] = _flat_specs(cell.args[1]["m"])
        cases[name] = case
    code = f"CASES = {json.dumps(json.dumps(cases))}\n" + REFERENCE
    res = run_reference(code, tmp_path_factory.mktemp("dry") / "ref.npz")
    return ours, json.loads(str(res["result"]))


@pytest.mark.parametrize("case", sorted(SMOKE))
def test_arg_bytes_equal_xla_memory_analysis(against_reference, case):
    ours, ref = against_reference
    assert ours[case]["arg_bytes"] == ref[case]["arg_bytes"]


@pytest.mark.parametrize("case", sorted(SMOKE))
def test_dot_flops_equal_the_reference_hlo(against_reference, case):
    ours, ref = against_reference
    got, want = ours[case]["dot_flops"], ref[case]["dot_flops"]
    if case in DOT_DIFFERENCES:
        assert (got, want) == DOT_DIFFERENCES[case]
    else:
        assert got == want


# ------------------------------------------------------------ full size --
def test_full_size_gemma_prefill_record(tmp_path):
    """gemma-7b prefill_32k on the (16, 16) mesh: the reference's record
    fields, per-device argument bytes from `param_shapes` and the rules
    (every weight split 16 ways over "model" but the replicated norms; the
    tokens (32, 32768) int32 split 16 ways over "data"), and the record
    read back by `analysis.load_all`."""
    rec = dryrun.run_cell("gemma-7b", "prefill_32k", False, verbose=False,
                          art=tmp_path)
    for key in ("arch", "shape", "variant", "mesh", "n_devices",
                "compile_s", "arg_bytes", "out_bytes", "temp_bytes",
                "alias_bytes", "flops_per_device",
                "bytes_accessed_per_device", "dot_flops_per_device",
                "hbm_bytes_per_device", "collectives", "dtype"):
        assert key in rec, key
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    cfg = registry.get("gemma-7b").config
    shapes = transformer.param_shapes(cfg)
    split = {"embed", "wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down"}

    def walk(node, name):
        if isinstance(node, dict):
            return sum(walk(v, k) for k, v in node.items())
        n = math.prod(node)
        # weights are bf16; the norms' scales f32
        return n * 2 // 16 if name in split else n * 4
    want = walk(shapes, None) + 32 * 32768 * 4 // 16
    assert rec["arg_bytes"] == want
    assert rec["dtype"] == "bfloat16" and rec["temp_bytes"] > 0
    assert set(rec["collectives"]) <= {"all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all"}
    on_disk = json.loads((tmp_path / "gemma-7b__prefill_32k__16x16.json")
                         .read_text())
    assert on_disk == rec
    rows = analysis.load_all(mesh="16x16", art=tmp_path)
    assert [r["shape"] for r in rows] == ["prefill_32k"]


def test_main_writes_one_record_per_mesh(tmp_path, capsys):
    """`main` over one small cell on both production meshes, then
    `--skip-existing`."""
    argv = ["--arch", "gcn-cora", "--shape", "molecule", "--out",
            str(tmp_path)]
    dryrun.main(argv)
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == ["gcn-cora__molecule__16x16.json",
                     "gcn-cora__molecule__2x16x16.json"]
    dryrun.main(argv + ["--skip-existing"])
    assert capsys.readouterr().out.count("[skip]") == 2

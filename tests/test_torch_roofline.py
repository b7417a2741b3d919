"""Port vs reference: the roofline (`repro_torch.roofline`).

`model_flops` must equal the reference's on all 40 (arch, shape) cells;
`analyze` on the reference's TPU v5e model must give the reference's
numbers for the same record; `op_count.dot_flops` of a port forward must
equal `hlo_parse.dot_flops` of the reference's compiled forward, exactly,
on the gemma-7b, MoE and GCN smoke configs; `hbm_bytes` must equal a count
by hand.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import gnn as ref_gnn
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tr
from repro.roofline import analysis as ref_analysis
from repro.roofline import hlo_parse
from repro_torch.configs import registry
from repro_torch.models import gnn, moe, transformer
from repro_torch.roofline import analysis, op_count

CELLS = ref_registry.all_cells()


def test_registry_cells_are_the_references():
    assert registry.all_cells() == CELLS and len(CELLS) == 40
    for arch, _ in CELLS:
        assert registry.get(arch).shapes == ref_registry.get(arch).SHAPES
        assert registry.get(arch).family == ref_registry.get(arch).FAMILY
    assert registry.LM_SHAPES == ref_registry.LM_SHAPES


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_reference(arch, shape):
    for n in (1, 256):
        assert analysis.model_flops(arch, shape, n) \
            == ref_analysis.model_flops(arch, shape, n)


def record(arch, shape, dot, hbm, coll, mesh="16x16", n=256):
    return dict(arch=arch, shape=shape, mesh=mesh, n_devices=n,
                dot_flops_per_device=dot, hbm_bytes_per_device=hbm,
                collectives={"all-gather": {"count": 3, "bytes": coll},
                             "all-reduce": {"count": 1, "bytes": coll / 7}},
                arg_bytes=2 ** 33, temp_bytes=2 ** 31, out_bytes=2 ** 20)


@pytest.mark.parametrize("rec", [
    record("gemma-7b", "train_4k", 4.1e15, 2.2e12, 3.0e10),
    record("qwen3-moe-30b-a3b", "prefill_32k", 9e14, 5e12, 1e9),
    record("graphcast", "ogb_products", 1e12, 2e11, 9e11),
    record("sasrec", "serve_p99", 3e9, 1e9, 0.0, mesh="2x16x16", n=512)])
def test_analyze_on_the_tpu_model_matches_reference(rec):
    """The same record through both `analyze`s on the reference's hardware
    model: every term and figure equal (the advice text is the port's)."""
    got = analysis.analyze(rec, analysis.TPU_V5E)
    want = ref_analysis.analyze(rec)
    assert got.pop("note") and want.pop("note")
    assert got == want


def test_the_card_model_picks_the_peak_of_the_records_dtype():
    rec = record("gemma-7b", "train_4k", 989e12, 0.0, 0.0)
    assert analysis.analyze(rec)["t_compute_s"] == 1.0
    f32 = analysis.analyze(dict(rec, dtype="float32"))
    assert f32["t_compute_s"] == 989e12 / 67e12
    own = analysis.analyze(dict(rec, model_flops_per_device=989e12))
    assert own["roofline_fraction"] == 1.0 and own["useful_ratio"] == 1.0


def ref_dot_flops(fn, *args) -> float:
    return hlo_parse.dot_flops(jax.jit(fn).lower(*args).compile().as_text())


def test_dot_flops_match_hlo_on_gemma_smoke():
    cfg = ref_registry.get("gemma-7b").SMOKE
    params = ref_tr.init_params(jax.random.PRNGKey(0), cfg)
    want = ref_dot_flops(lambda p, t: ref_tr.forward(p, t, cfg), params,
                         jnp.zeros((2, 64), jnp.int32))
    assert want == 184_549_376
    pc = registry.get("gemma-7b").smoke
    got = op_count.dot_flops(transformer.forward,
                             transformer.init_params(pc, device="cpu"),
                             torch.zeros(2, 64, dtype=torch.long), pc)
    assert got == want


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
def test_dot_flops_match_hlo_on_moe_smoke(arch):
    cfg = ref_registry.get(arch).SMOKE
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 64))
    want = ref_dot_flops(lambda p, t: ref_moe.forward(p, t, cfg),
                         ref_moe.init_params(jax.random.PRNGKey(0), cfg),
                         jnp.asarray(tokens, jnp.int32))
    pc = registry.get(arch).smoke
    got = op_count.dot_flops(moe.forward, moe.init_params(pc, device="cpu"),
                             torch.from_numpy(tokens), pc)
    assert got == want > 0


def test_dot_flops_match_hlo_on_gcn_smoke():
    cfg = ref_registry.get("gcn-cora").SMOKE
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, cfg.d_in)).astype(np.float32)
    e = rng.integers(0, 50, (2, 200)).astype(np.int32)
    want = ref_dot_flops(lambda p, x, e: ref_gnn.forward(p, x, e, cfg),
                         ref_gnn.init_params(jax.random.PRNGKey(0), cfg),
                         jnp.asarray(x), jnp.asarray(e))
    pc = registry.get("gcn-cora").smoke
    got = op_count.dot_flops(gnn.forward, gnn.init_params(pc, device="cpu"),
                             torch.from_numpy(x),
                             torch.from_numpy(e).long(), pc)
    assert got == want == 2 * 50 * (32 * 8 + 8 * 4)


def test_hbm_bytes_of_a_matmul_and_tanh_by_hand():
    """tanh(x @ w) in f32: the product reads x and w and writes (M, N); tanh
    reads and writes (M, N); the transposed view of w moves nothing."""
    m, k, n = 16, 24, 8
    x, w = torch.ones(m, k), torch.ones(n, k)
    def f(x, w):
        return torch.tanh(x @ w.t())
    assert op_count.hbm_bytes(f, x, w) \
        == 4 * (m * k + k * n + m * n) + 4 * 2 * m * n
    c = op_count.count(f, x, w)
    assert c["dot_flops"] == 2 * m * n * k
    assert c["collectives"] == {} and c["peak_bytes"] is None
    assert c["arg_bytes"] == 4 * (m * k + n * k) and c["out_bytes"] == 4 * m * n
    # in place: read and written; copy_: its source read, its target written
    y = torch.zeros(m, n)
    c = op_count.count(lambda y: y.add_(1.0).copy_(torch.ones(m, n)), y)
    assert c["hbm_bytes"] == 2 * 4 * m * n + 4 * m * n + 2 * 4 * m * n


def test_copies_between_devices_are_collectives():
    """On fake tensors (no memory, no card) a copy from one accelerator to
    another counts as device-to-device bytes; on one device nothing does."""
    with op_count.fake_mode():
        x = torch.empty(4, 8, device="cuda:0")
        c = op_count.count(lambda x: x.to("cuda:1") + 1, x)
        same = op_count.collective_bytes(lambda x: x.to("cuda:0") + 1, x)
    assert c["collectives"] == {"device-to-device": {"count": 1,
                                                     "bytes": 128.0}}
    assert c["hbm_bytes"] == 2 * 128 + 2 * 128
    assert same == {}


def test_full_gemma_prefill_counts_without_memory(tmp_path, capsys):
    """gemma-7b at full width and depth, a 4,096-token prefill, counted on
    fake tensors: the products' FLOPs are 2·N·T for the non-embedding
    parameters plus the plain path's full T x T attention products,
    4·L·H·T²·Dh; the record goes
    through `analyze` on the card's model and `main`'s table."""
    cfg = registry.get("gemma-7b").config
    t = 4096
    with op_count.fake_mode():
        params = transformer.init_params(cfg, device="cpu")
        tokens = torch.zeros(1, t, dtype=torch.long)
        rec = op_count.record("gemma-7b", "prefill_4k", transformer.forward,
                              params, tokens, cfg, out_dir=tmp_path,
                              model_flops_per_device=2.0 * cfg.n_params() * t)
    non_embed = cfg.n_params() - cfg.vocab * cfg.d_model
    attn = 4 * cfg.n_layers * cfg.n_heads * t * t * cfg.head_dim
    assert rec["dot_flops_per_device"] == 2 * non_embed * t + attn
    assert rec["dtype"] == "bfloat16" and rec["arg_bytes"] > 1.6e10
    on_disk = json.loads((tmp_path / "gemma-7b_prefill_4k.json").read_text())
    assert on_disk == rec
    row = analysis.analyze(rec)
    assert row["dominant"] in ("compute", "memory")
    assert row["t_compute_s"] == rec["dot_flops_per_device"] / 989e12
    assert [r["shape"] for r in analysis.load_all(art=tmp_path)] \
        == ["prefill_4k"]
    analysis.main(["--dir", str(tmp_path)])
    assert "gemma-7b" in capsys.readouterr().out

"""Three-term roofline analysis of counted records.

The port of the reference's `roofline/analysis.py`. Per (arch x shape x
mesh) record (`op_count.record`):

    compute term    = dot FLOPs per device / peak FLOP/s of its dtype  [s]
    memory term     = HBM bytes per device / HBM bandwidth              [s]
    collective term = device-to-device bytes per device / link bandwidth [s]

The hardware model is a `Hardware` record: `H100_SXM` (the port's card)
by default, `TPU_V5E` with the reference's constants for comparison.
`model_flops` uses the reference's 6·N·D (train) / 2·N·D (inference)
convention with N_active for MoE, and its GNN and recsys counts; the
ratio model FLOPs / counted FLOPs exposes recompute and redundancy.

    PYTHONPATH=src python -m repro_torch.roofline.analysis [--mesh 1]

reads every record under `artifacts/roofline_torch/` and prints the table.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" \
    / "roofline_torch"


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Peak rates of one device: dense dot FLOP/s in bf16 and in f32, HBM
    bytes/s, and link bytes/s in one direction."""
    name: str
    bf16_flops: float
    f32_flops: float
    hbm_bw: float
    link_bw: float

    def peak_flops(self, dtype: str = "bfloat16") -> float:
        return self.f32_flops if dtype == "float32" else self.bf16_flops


# NVIDIA H100 SXM data sheet (dense, no sparsity, at its 700 W limit):
# 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside them (the
# port keeps TF32 off), 3.35 TB/s HBM3, 900 GB/s NVLink = 450 GB/s a way
H100_SXM = Hardware("H100 SXM", bf16_flops=989e12, f32_flops=67e12,
                    hbm_bw=3.35e12, link_bw=450e9)
# the reference's model (its analysis.py: one 197 TFLOP/s peak for every
# dtype, 819 GB/s HBM, ~50 GB/s an ICI link); held by the tests only
TPU_V5E = Hardware("TPU v5e", bf16_flops=197e12, f32_flops=197e12,
                   hbm_bw=819e9, link_bw=50e9)


def _arch(arch: str):
    from ..configs import registry
    return registry.get(arch)


def _spec(arch: str, shape) -> dict:
    """A shape by name from the arch's set, or a spec dict as it is."""
    return shape if isinstance(shape, dict) else _arch(arch).shapes[shape]


def model_flops_per_device(arch: str, shape, n_devices: int) -> float:
    """Useful-math FLOPs per device per step (6ND / 2ND convention)."""
    a = _arch(arch)
    spec = _spec(arch, shape)
    cfg = a.config
    if a.family in ("lm", "moe"):
        n = cfg.n_active_params() if a.family == "moe" else cfg.n_params()
        if spec["kind"] == "train":
            tok = spec["global_batch"] * spec["seq_len"]
            return 6.0 * n * tok / n_devices
        if spec["kind"] == "prefill":
            tok = spec["global_batch"] * spec["seq_len"]
            return 2.0 * n * tok / n_devices
        tok = spec["global_batch"]  # decode: one token per sequence
        return 2.0 * n * tok / n_devices
    return 0.0


def _gnn_model_flops(arch: str, shape, n_devices: int) -> float:
    a = _arch(arch)
    spec = _spec(arch, shape)
    cfg = a.config
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
    if a.family == "graphcast":
        h = cfg.d_hidden
        fl = 2 * nodes * cfg.n_vars * h          # encode/decode embeds
        fl += cfg.n_layers * (2 * edges * 3 * h * h + 2 * nodes * 2 * h * h)
        fl += 2 * (4 * nodes) * 2 * h * h * 2    # bipartite MLPs
        return 3.0 * fl / n_devices              # fwd+bwd
    if a.family == "nequip":
        from ..models.equivariant import allowed_paths
        paths = len(allowed_paths(cfg.l_max))
        c = cfg.n_channels
        per_edge = paths * c * (9 + 25) + cfg.n_rbf * cfg.radial_hidden \
            + cfg.radial_hidden * paths * c
        fl = cfg.n_layers * (2 * edges * per_edge
                             + 2 * nodes * (cfg.l_max + 1) * c * c * 5)
        return 3.0 * fl / n_devices
    # gcn / sage
    dims = [spec["d_feat"]] + [cfg.d_hidden] * (cfg.n_layers - 1) \
        + [max(spec["n_classes"], 2)]
    fl = 0.0
    for a_, b2 in zip(dims[:-1], dims[1:]):
        fl += 2 * nodes * a_ * b2 * (2 if cfg.arch == "sage" else 1)
        fl += edges * a_  # message gather+reduce
    return 3.0 * fl / n_devices


def _recsys_model_flops(arch: str, shape, n_devices: int) -> float:
    spec = _spec(arch, shape)
    cfg = _arch(arch).config
    d = cfg.embed_dim
    per_tok = cfg.n_blocks * (4 * d * d + 2 * d * cfg.d_ff) * 2
    if spec["kind"] == "train":
        fl = 3 * spec["batch"] * cfg.seq_len * (per_tok
                                                + cfg.seq_len * d * 2) + \
            3 * spec["batch"] * cfg.seq_len * 2 * d * 2
        return fl / n_devices
    b = spec.get("batch", 1)
    enc = b * cfg.seq_len * (per_tok + cfg.seq_len * d * 2)
    if spec["kind"] == "retrieval":
        score = b * spec["n_candidates"] * 2 * d
    else:
        score = b * cfg.n_items * 2 * d
    return (enc + score) / n_devices


def model_flops(arch: str, shape, n_devices: int) -> float:
    """Useful FLOPs per device of (arch, shape): `shape` a name of the
    arch's shape set, or a spec dict of the same kind."""
    fam = _arch(arch).family
    if fam in ("lm", "moe"):
        return model_flops_per_device(arch, shape, n_devices)
    if fam == "recsys":
        return _recsys_model_flops(arch, shape, n_devices)
    return _gnn_model_flops(arch, shape, n_devices)


def analyze(rec: dict, hw: Hardware = H100_SXM) -> dict:
    """The three terms of `rec` on `hw`, the dominant one, the useful
    ratio and the roofline fraction. A record's own
    `model_flops_per_device` (a workload cut from its cell) replaces the
    cell's `model_flops`; its `dtype` picks the peak (bf16 if absent)."""
    coll = sum(v["bytes"] for v in rec["collectives"].values())
    peak = hw.peak_flops(rec.get("dtype", "bfloat16"))
    t_compute = rec["dot_flops_per_device"] / peak
    t_memory = rec["hbm_bytes_per_device"] / hw.hbm_bw
    t_coll = coll / hw.link_bw
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = rec.get("model_flops_per_device")
    if mf is None:
        mf = model_flops(rec["arch"], rec["shape"], rec["n_devices"])
    ratio = mf / max(rec["dot_flops_per_device"], 1.0)
    # roofline fraction: useful-FLOPs time / bound time (an achievable-MFU
    # style score; 1.0 = useful math fully hides behind the binding term)
    frac = (mf / peak) / max(bound, 1e-12)
    # results that are arguments written in place count once (dry-run
    # records give their bytes; a record without them has none)
    peak_gib = (rec["arg_bytes"] + rec["temp_bytes"] + rec["out_bytes"]
                - rec.get("alias_bytes", 0)) / 2**30
    recs = {
        "compute": "compute-bound: raise MFU via larger tiles / fused "
                   "attention; remat ratio shows recompute overhead",
        "memory": "memory-bound: cut activation traffic (fusion, bf16 "
                  "carries, flash attention keeps logits on chip)",
        "collective": "collective-bound: reshard to cut all-gathers "
                      "(2D sharding, overlap, gradient compression)",
    }
    return {
        **{k: rec[k] for k in ("arch", "shape", "mesh", "n_devices")},
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_per_device": mf, "useful_ratio": ratio,
        "roofline_fraction": frac, "peak_gib": peak_gib,
        "note": recs[dominant],
    }


def load_all(mesh: str | None = None, variant: str = "base",
             hw: Hardware = H100_SXM, art: pathlib.Path = ART) -> list:
    out = []
    for p in sorted(art.glob("*.json")):
        rec = json.loads(p.read_text())
        if mesh and rec["mesh"] != mesh:
            continue
        if rec.get("variant", "base") != variant:
            continue
        out.append(analyze(rec, hw))
    return out


def table(rows: list) -> str:
    hdr = (f"| {'arch':<18s} | {'shape':<13s} | {'mesh':<7s} | "
           f"{'compute s':>9s} | {'memory s':>9s} | {'collect s':>9s} | "
           f"{'bound':<10s} | {'6ND/dots':>8s} | {'roofline%':>9s} | "
           f"{'peak GiB':>8s} |")
    sep = "|" + "|".join("-" * (len(c) + 2) for c in
                         ["arch" + " " * 14, "shape" + " " * 8, "mesh" + " " * 3,
                          "compute s", "memory  s", "collect s",
                          "bound" + " " * 5, "6ND/dots", "roofline%",
                          "peak GiB"]) + "|"
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']:<18s} | {str(r['shape']):<13s} | "
            f"{r['mesh']:<7s} | "
            f"{r['t_compute_s']:9.4f} | {r['t_memory_s']:9.4f} | "
            f"{r['t_collective_s']:9.4f} | {r['dominant']:<10s} | "
            f"{r['useful_ratio']:8.2f} | {r['roofline_fraction']*100:8.1f}% | "
            f"{r['peak_gib']:8.2f} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default=None,
                    help="only the records of this mesh (e.g. 1, 1x4)")
    ap.add_argument("--dir", default=str(ART), help="the records' directory")
    args = ap.parse_args(argv)
    print(table(load_all(args.mesh, art=pathlib.Path(args.dir))))


if __name__ == "__main__":
    main()

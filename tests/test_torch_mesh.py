"""Port vs reference: device meshes, shardings, elastic resharding and the
activation-sharding constraint (`repro_torch.launch.mesh`,
`repro_torch.dist.elastic`, `repro_torch.models.layers.shard_activations`).

The reference's multi-device answers come from one subprocess per file
under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as the
reference's CI shard lane runs (`run_reference`); it writes them to an
.npz file. The port builds its meshes over `torch.device("cpu")` named
1, 2 or 4 times, or over CUDA device descriptors where only the layout is
compared (no tensor touches them).
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.dist import elastic
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.mesh import (Mesh, NamedSharding, PartitionSpec as P,
                                     device_put)
from repro_torch.models import layers

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def run_reference(code: str, out: pathlib.Path) -> dict:
    """Run `code` (which writes its answers with `np.savez(OUT, ...)`) in a
    fresh process over 4 forced host devices; return the arrays."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    prelude = ("import numpy as np, jax\n"
               "assert len(jax.devices()) == 4, jax.devices()\n"
               f"OUT = {str(out)!r}\n")
    subprocess.run([sys.executable, "-c", prelude + code], check=True,
                   env=env, cwd=ROOT, timeout=600)
    with np.load(out, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


HOST_MESHES = [(1, 1), (1, 4), (2, 2), (4, 1), (3, 4), (2, 1), (4, 4),
               (1, 3)]
SHRINKS = [("data_model", (4, 1), n) for n in (0, 1, 2, 3)] \
    + [("data_model", (2, 2), n) for n in (0, 1, 2, 3)] \
    + [("pod_data_model", (2, 2, 2), n) for n in (0, 1, 3, 5)] \
    + [("model_data", (2, 2), n) for n in (1, 2)]
RESPECS = [(("pod", ("pod", "data"), None)), (("pod", "pod", "model")),
           (("pod", None, ("data", "model"))), (("pod", ("pod",), None)),
           (("data", "data", "model")), (("data", ("data", "model"),))]

REFERENCE = r"""
import json
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import jax.numpy as jnp
from repro.launch import mesh as M
from repro.dist import elastic
from repro.models import layers
HOST_MESHES = %(host)s
SHRINKS = %(shrinks)s
RESPECS = %(respecs)s
ans = {}
for d, m in HOST_MESHES:
    mm = M.make_host_mesh(d, m)
    ans[f"host_{d}_{m}"] = json.dumps([list(mm.shape.items()),
                                       [x.id for x in mm.devices.flat]])
for s in range(1, 13):
    ans[f"shard_{s}"] = json.dumps(list(M.make_shard_mesh(s).shape.items()))
for multi in (False, True):
    try:
        M.make_production_mesh(multi_pod=multi)
        ans[f"prod_{multi}"] = "built"
    except ValueError as e:
        ans[f"prod_{multi}"] = str(e)
devs = jax.devices()
NAMES = {"data_model": ("data", "model"), "model_data": ("model", "data"),
         "pod_data_model": ("pod", "data", "model")}
for i, (kind, shape, lost) in enumerate(SHRINKS):
    n = int(np.prod(shape))
    arr = np.array((devs * 2)[:n], dtype=object).reshape(shape)
    new = elastic.shrink_mesh(Mesh(arr, NAMES[kind]), lost)
    ans[f"shrink_{i}"] = json.dumps([list(new.shape.items()),
                                     [x.id for x in new.devices.flat]])
one = np.array(devs[:1], dtype=object)
for i, (old, *spec) in enumerate(RESPECS):
    old_mesh = Mesh(one.reshape(1, 1, 1), ("pod", "data", "model")) \
        if old == "pod" else Mesh(one.reshape(1, 1), ("data", "model"))
    new_mesh = Mesh(one.reshape(1, 1), ("data", "model"))
    ns = elastic.respec(NamedSharding(old_mesh, P(*spec)), new_mesh)
    ans[f"respec_{i}"] = json.dumps([list(e) if isinstance(e, tuple) else e
                                     for e in ns.spec])
x = np.arange(16.0, dtype=np.float32).reshape(4, 4)
mesh4 = M.make_host_mesh(data=4, model=1)
a = jax.device_put(jnp.asarray(x), NamedSharding(mesh4, P("data", None)))
even = elastic.reshard_tree({"x": a}, {"x": a.sharding},
                            elastic.shrink_mesh(mesh4, 2))
ans["even"] = np.asarray(even["x"])
try:
    elastic.reshard_tree({"x": a}, {"x": a.sharding},
                         elastic.shrink_mesh(mesh4, 1))
    ans["uneven"] = "no error"
except ValueError as e:
    ans["uneven"] = str(e)
h = jnp.asarray(np.arange(2 * 4 * 8, dtype=np.float32).reshape(2, 4, 8))
def act(axes, ctx):
    try:
        if ctx:
            with M.make_host_mesh(2, 2):
                y = layers.shard_activations(h, *axes)
        else:
            y = layers.shard_activations(h, *axes)
        return "same" if np.array_equal(np.asarray(y), np.asarray(h)) \
            else "changed"
    except Exception as e:
        return type(e).__name__
ans["act_none"] = act(((), ()), False)
ans["act_nomesh"] = act((("data",), ()), False)
ans["act_badaxis"] = act((("pod",), ()), True)
ans["act_ok"] = act((("data",), ("model",)), True)
np.savez(OUT, **ans)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    code = REFERENCE % dict(host=HOST_MESHES, shrinks=SHRINKS,
                            respecs=RESPECS)
    return run_reference(code, tmp_path_factory.mktemp("mesh") / "ref.npz")


def cuda_devices(n: int) -> list:
    """n distinct device descriptors: layouts are compared by index, and
    no tensor is put on them."""
    return [torch.device("cuda", i) for i in range(n)]


def layout(m: Mesh) -> list:
    return [list(map(list, m.shape.items())),
            [d.index for d in m.devices.flat]]


@pytest.mark.parametrize("data,model", HOST_MESHES)
def test_make_host_mesh_matches_reference(ref, data, model):
    got = pmesh.make_host_mesh(data, model, devices=cuda_devices(4))
    assert got.axis_names == ("data", "model")
    assert layout(got) == json.loads(str(ref[f"host_{data}_{model}"]))


@pytest.mark.parametrize("n_shards", range(1, 13))
def test_make_shard_mesh_matches_reference(ref, n_shards):
    got = pmesh.make_shard_mesh(n_shards, devices=cuda_devices(4))
    assert got.axis_names == ("shard",)
    assert list(map(list, got.shape.items())) == json.loads(
        str(ref[f"shard_{n_shards}"]))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_refuses_too_few_devices(ref, multi_pod):
    with pytest.raises(ValueError) as err:
        pmesh.make_production_mesh(multi_pod=multi_pod,
                                   devices=cuda_devices(4))
    assert str(err.value) == str(ref[f"prod_{multi_pod}"])
    m = pmesh.make_production_mesh(multi_pod=multi_pod,
                                   devices=cuda_devices(512))
    assert m.axis_names == (("pod", "data", "model") if multi_pod
                            else ("data", "model"))
    assert tuple(m.shape.values()) == ((2, 16, 16) if multi_pod
                                       else (16, 16))


def test_mesh_constructors_want_cuda_without_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: pmesh.make_host_mesh(1, 1),
                  lambda: pmesh.make_shard_mesh(4),
                  lambda: pmesh.make_production_mesh()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


@pytest.mark.parametrize("case", range(len(SHRINKS)))
def test_shrink_mesh_matches_reference(ref, case):
    kind, shape, lost = SHRINKS[case]
    names = {"data_model": ("data", "model"), "model_data": ("model", "data"),
             "pod_data_model": ("pod", "data", "model")}[kind]
    n = int(np.prod(shape))
    devs = np.empty(n, dtype=object)
    devs[:] = (cuda_devices(4) * 2)[:n]
    got = elastic.shrink_mesh(Mesh(devs.reshape(shape), names), lost)
    assert layout(got) == json.loads(str(ref[f"shrink_{case}"]))


@pytest.mark.parametrize("case", range(len(RESPECS)))
def test_respec_matches_reference(ref, case):
    """`respec` drops the vanished axes; the pod fold (reference
    tests/test_substrate.py::test_elastic_respec_folds_pod_axis) among
    them."""
    old, *spec = RESPECS[case]
    old_mesh = (Mesh(np.array([[[CPU]]], dtype=object),
                     ("pod", "data", "model")) if old == "pod"
                else Mesh(np.array([[CPU]], dtype=object), ("data", "model")))
    new_mesh = Mesh(np.array([[CPU]], dtype=object), ("data", "model"))
    got = elastic.respec(NamedSharding(old_mesh, P(*spec)), new_mesh)
    assert got.mesh is new_mesh
    assert [list(e) if isinstance(e, tuple) else e for e in got.spec] \
        == json.loads(str(ref[f"respec_{case}"]))


def data_mesh(n: int) -> Mesh:
    return pmesh.make_host_mesh(data=n, model=1, devices=[CPU] * n)


def test_reshard_tree_even_case_matches_reference(ref):
    x = torch.arange(16.0).reshape(4, 4)
    mesh4 = data_mesh(4)
    a = device_put(x, NamedSharding(mesh4, P("data", None)))
    new = elastic.shrink_mesh(mesh4, 2)
    y = elastic.reshard_tree({"x": a}, {"x": a.sharding}, new)["x"]
    assert y.sharding.mesh is new and tuple(y.blocks.shape) == (2, 1)
    assert [tuple(b.shape) for b in y.blocks.flat] == [(2, 4), (2, 4)]
    np.testing.assert_array_equal(y.gather(CPU).numpy(), ref["even"])


def test_reshard_tree_uneven_case_raises_as_the_reference_does(ref):
    """The reference's own test (tests/test_substrate.py::
    test_elastic_shrink_and_reshard) on 4 devices: data 4 -> 3 cannot hold
    a (4, 4) P("data", None) tensor. Both packages raise the same
    ValueError (a reference fault the port shares)."""
    want = str(ref["uneven"])
    assert "should be divisible by 3, but it is equal to 4" in want
    mesh4 = data_mesh(4)
    a = device_put(torch.arange(16.0).reshape(4, 4),
                   NamedSharding(mesh4, P("data", None)))
    with pytest.raises(ValueError) as err:
        elastic.reshard_tree({"x": a}, {"x": a.sharding},
                             elastic.shrink_mesh(mesh4, 1))
    tail = "the global size of its dimension 0 should be divisible by 3, " \
        "but it is equal to 4 (full shape: (4, 4))"
    assert want.endswith(tail) and str(err.value).endswith(tail)


@pytest.mark.parametrize("case,axes,ctx", [
    ("none", ((), ()), False), ("nomesh", (("data",), ()), False),
    ("badaxis", (("pod",), ()), True), ("ok", (("data",), ("model",)), True)])
def test_shard_activations_matches_reference(ref, case, axes, ctx):
    h = torch.arange(2 * 4 * 8, dtype=torch.float32).reshape(2, 4, 8)
    want = str(ref[f"act_{case}"])
    try:
        if ctx:
            with pmesh.make_host_mesh(2, 2, devices=[CPU] * 4):
                y = layers.shard_activations(h, *axes)
        else:
            y = layers.shard_activations(h, *axes)
        got = "same" if torch.equal(y, h) else "changed"
    except (RuntimeError, ValueError) as e:
        got = type(e).__name__
    assert got == want
    assert pmesh.ambient_mesh() is None


def test_transformer_with_activation_axes_equals_without():
    """A smoke transformer with `batch_axes`/`seq_axes` set, under a mesh
    that has them, gives the unconstrained forward's values exactly."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tr
    cfg = registry.get("gemma-7b").smoke
    params = tr.init_params(cfg, seed=0, device=CPU)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    want = tr.forward(params, tokens, cfg)
    sp = dataclasses.replace(cfg, batch_axes=("data",), seq_axes=("model",))
    with pytest.raises(RuntimeError):
        tr.forward(params, tokens, sp)
    with pmesh.make_host_mesh(2, 2, devices=[CPU] * 4):
        got = tr.forward(params, tokens, sp)
    assert torch.equal(got, want)


# ------------------------------------------------ the port's own types ----
@pytest.mark.parametrize("spec", [P("data", None), P(None, "model"),
                                  P(("data", "model")), P(), P("model"),
                                  P(("model", "data"), None)])
def test_device_put_blocks_and_gather(spec):
    """Each position's block is the slice jax gives it (the splitting axes'
    coordinates row-major, the first outermost); replicated dimensions are
    whole; gather puts the tensor back bit for bit."""
    mesh = pmesh.make_host_mesh(2, 2, devices=[CPU] * 4)
    x = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8)
    y = device_put(x, NamedSharding(mesh, spec))
    assert y.shape == (4, 8) and y.dtype == torch.float32
    for pos in mesh.positions():
        sl = []
        for dim in range(2):
            axes = spec.axes(dim)
            parts, i = 1, 0
            for a in axes:
                n = mesh.shape[a]
                i = i * n + pos[mesh.axis_names.index(a)]
                parts *= n
            step = x.shape[dim] // parts
            sl.append(slice(i * step, (i + 1) * step))
        assert torch.equal(y.blocks[pos], x[tuple(sl)])
        assert y.blocks[pos].device == mesh.devices[pos]
    assert torch.equal(y.gather(CPU), x)


def test_a_mesh_may_repeat_a_device():
    """One device named at every position holds every block; jax builds such
    a mesh but refuses device_put onto it (a deliberate difference)."""
    mesh = pmesh.make_shard_mesh(4, devices=[CPU] * 4)
    assert mesh.shape["shard"] == 4 and mesh.size == 4
    y = device_put(torch.arange(8), NamedSharding(mesh, P("shard")))
    assert [b.tolist() for b in y.along("shard")] == [[0, 1], [2, 3],
                                                     [4, 5], [6, 7]]


def test_device_put_checks_what_jax_checks():
    mesh = data_mesh(4)
    with pytest.raises(ValueError, match="should be divisible by 4"):
        device_put(torch.zeros(6, 2), NamedSharding(mesh, P("data")))
    with pytest.raises(ValueError, match="not found in mesh"):
        NamedSharding(mesh, P("pod"))
    with pytest.raises(ValueError, match="rank"):
        device_put(torch.zeros(4), NamedSharding(mesh, P("data", None)))
    with pytest.raises(ValueError, match="twice"):
        NamedSharding(mesh, P("data", "data"))
    # a sharded tensor is put again by way of its whole
    a = device_put(torch.arange(8.0), NamedSharding(mesh, P("data")))
    b = device_put(a, NamedSharding(data_mesh(2), P("data")))
    assert [t.tolist() for t in b.along("data")] == [[0, 1, 2, 3],
                                                    [4, 5, 6, 7]]


def test_mesh_context_nests_and_unwinds():
    outer, inner = data_mesh(2), data_mesh(4)
    assert pmesh.ambient_mesh() is None
    with outer:
        with inner:
            assert pmesh.ambient_mesh() is inner
        assert pmesh.ambient_mesh() is outer
    assert pmesh.ambient_mesh() is None
    assert outer == data_mesh(2) and outer != inner

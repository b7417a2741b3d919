"""Build the CUDA kernels in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into `_build/<name>-<hash>.so`, a
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds), with the flags `nvcc_flags(name)` gives it. All sources build in
parallel, once per hash of their content and flags, at the first launch of
any kernel; nothing is built when the package is imported. A failed build
raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# flags of every source; -Xptxas -v reports registers, shared memory and
# spills into build_logs
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# --fmad=false: no multiply-add contraction, so every f32 step is rounded as
# the plain torch versions round it (the STREAK kernels' exact f32
# predicates, block_scan's compares, morton_encode's integers)
EXACT_F32 = ["--fmad=false"]

# kernel name -> C launcher symbol, its ctypes argument types and the
# source's own nvcc flags; every launcher returns the cudaError_t of its
# launch. flash_attention contracts multiply-adds: it is held to a tolerance,
# not to its plain version's bits.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
KERNELS = {
    "fused_topk_join": ("fused_topk_join_launch",
                        [_P] * 11 + [_I] * 6 + [_P], EXACT_F32),
    "distance_join": ("distance_join_launch", [_P, _P, _P, _L, _L, _P],
                      EXACT_F32),
    "bucketed_min_core": ("bucketed_min_core_launch",
                          [_P, _P, _P, _I, _I, _I, _P], EXACT_F32),
    "tree_descend": ("tree_descend_launch", [_P, _P, _P, _P, _I, _I, _I, _P],
                     EXACT_F32),
    "bloom_probe": ("bloom_probe_launch", [_P, _P, _P, _L, _I, _I, _P],
                    EXACT_F32),
    "merge_join_ranks": ("merge_join_ranks_launch",
                         [_P, _P, _P, _L, _L, _I, _I, _P], EXACT_F32),
    "block_scan": ("block_scan_launch", [_P, _F, _P, _P, _P, _I, _I, _P],
                   EXACT_F32),
    "morton_encode": ("morton_encode_launch", [_P, _P, _P, _L, _P],
                      EXACT_F32),
    "flash_attention": ("flash_attention_launch", [_P] * 4 + [_I] * 7 + [_P],
                        []),
}

# further C entry points: symbol -> (kernel whose library has it, ctypes
# argument types); each returns a cudaError_t
HOST_CALLS = {
    "merge_join_ranks_round_trip": ("merge_join_ranks",
                                    [_P, _P, _P, _L, _L, _P, _I, _I, _P]),
    "distance_join_pairs_launch": ("distance_join",
                                   [_P, _P, _L, _L, _F, _P, _P, _L, _P]),
    "distance_join_pairs_round_trip": (
        "distance_join", [_P, _P, _P, _P, _L, _L, _F, _P, _P, _L, _P]),
    "bloom_probe_any_launch": ("bloom_probe",
                               [_P, _I, _I, _P, _L, _I, _P, _P]),
    "bloom_probe_any_round_trip": ("bloom_probe",
                                   [_P, _P, _P, _I, _I, _L, _I, _P, _P]),
}

_launchers: dict[str, object] = {}   # kernel or host-call name -> function
build_logs: dict[str, str] = {}     # kernel name -> ptxas report of its build


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def nvcc_flags(name: str) -> list[str]:
    """Every flag nvcc gets for kernel `name`'s source, output aside."""
    return [*NVCC_FLAGS, *KERNELS[name][2]]


def _target(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    for dep in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every kernel not yet built, one nvcc per source, all at once.

    Returns kernel name -> library path. Raises RuntimeError with nvcc's
    output when any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in KERNELS}
    jobs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.parent / f"{so.name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *nvcc_flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    failed = []
    for name, (proc, tmp, so) in jobs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, so)
        so.with_suffix(".log").write_text(out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name, so in targets.items():
        log = so.with_suffix(".log")
        if name not in build_logs and log.exists():
            build_logs[name] = log.read_text()
    return targets


def launcher(name: str):
    """The ctypes launcher of kernel `name` (or the host call `name` of
    `HOST_CALLS`), building and loading all kernels first if this process
    has loaded none yet."""
    fn = _launchers.get(name)
    if fn is None:
        libs = {kname: ctypes.CDLL(str(path))
                for kname, path in build_all().items()}
        entries = {kname: (kname, *KERNELS[kname][:2]) for kname in KERNELS}
        entries.update((sym, (kname, sym, argtypes))
                       for sym, (kname, argtypes) in HOST_CALLS.items())
        for key, (kname, symbol, argtypes) in entries.items():
            f = getattr(libs[kname], symbol)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _launchers[key] = f
        fn = _launchers[name]
    return fn

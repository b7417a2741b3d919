"""The benchmark's files found by name.

A generator, a query shape or a metric reader is the file
`portbench/<folder>/<name>.py` under a checkout's root, loaded by its path:
a file that a later change adds is found with no edit to the harness.
"""
from __future__ import annotations

import importlib.util
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def load(folder: str, name: str, root: pathlib.Path = ROOT):
    """The module `root`/portbench/`folder`/`name`.py, loaded anew. It is
    entered in `sys.modules` (by folder and name) before it runs, so the
    dataclasses it defines can look their module up."""
    path = pathlib.Path(root) / "portbench" / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {folder} file {path}")
    modname = f"portbench_{folder}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod

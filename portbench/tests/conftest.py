"""The benchmark's own tests: `python3 -m pytest portbench/tests` from the
repository's root. The repository's suite (`tests/`) does not collect
them. Tests that need the card are marked `cuda` and decide in a fixture."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

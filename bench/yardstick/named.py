"""Files found by the name that ``BENCHMARK.json`` or a data file gives:
``bench/<folder>/<name>.py``, loaded by path, so a name may hold ``.`` and
``-``."""

from __future__ import annotations

import importlib.util
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
_loaded: dict = {}


def load(folder: str, name: str):
    """The module ``bench/<folder>/<name>.py`` (loaded once)."""
    key = (folder, name)
    if key not in _loaded:
        path = BENCH / folder / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {folder} named {name!r}: {path} is missing")
        tag = "bench_" + f"{folder}_{name}".replace("/", "_") \
            .replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(tag, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[key] = module
    return _loaded[key]

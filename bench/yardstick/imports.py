"""The benchmark runs the port alone: no module of the JAX package, JAX
or Flax may be imported by the harness, nor loaded into its process."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the plain reference judges the program, so it imports none of it either
REFERENCE_FORBIDDEN = FORBIDDEN + ("repro_torch",)


def top_level(name: str) -> str:
    """The part of a module's name before its first dot."""
    return name.split(".", 1)[0]


def imported(path: Path) -> set:
    """Top-level names of every module that ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(top_level(node.module))
    return names


def violations(bench: Path) -> list:
    """(file, name) of every forbidden import under ``bench``."""
    out = []
    for path in sorted(bench.rglob("*.py")):
        bad = REFERENCE_FORBIDDEN if "reference" in path.relative_to(
            bench).parts else FORBIDDEN
        out.extend((str(path.relative_to(bench)), n)
                   for n in sorted(imported(path) & set(bad)))
    return out


def forbidden_loaded() -> list:
    """Forbidden top-level names present in ``sys.modules``."""
    return sorted({top_level(m) for m in sys.modules} & set(FORBIDDEN))

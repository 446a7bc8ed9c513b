"""What the benchmark may load and read.

Nothing it runs may load JAX or the JAX package ``repro`` (top-level
module names compared whole: the port ``repro_torch`` is not ``repro``),
the references may not load the port either, and no source opens the JAX
package's CPU benchmarks (``benchmarks/``, ``BENCH_*.json``).  ``scan``
reads the sources; ``loaded`` reads ``sys.modules`` of a running process.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
# the references are plain PyTorch: not the program either
FORBIDDEN_IN_REFERENCE = FORBIDDEN | {"repro_torch"}
# the JAX package's CPU benchmark files and folder
FORBIDDEN_PATHS = ("benchmarks/", "BENCH_")


def top_level(module: str) -> str:
    return module.split(".", 1)[0]


def imported(tree: ast.AST) -> set[str]:
    """Top-level names of the absolute imports in a parsed source."""
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level \
                and node.module:
            names.add(top_level(node.module))
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            names.add(top_level(node.args[0].value))
    return names


def scan(root: Path = HERE) -> list[str]:
    """Every breach in the benchmark's sources (tests aside: they hold the
    port against the references on the CPU and may load both)."""
    found = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root)
        if rel.parts[0] == "tests":
            continue
        src = path.read_text()
        tree = ast.parse(src, str(path))
        banned = (FORBIDDEN_IN_REFERENCE if rel.parts[0] == "reference"
                  else FORBIDDEN)
        for name in sorted(imported(tree) & banned):
            found.append(f"{rel}: imports {name}")
        if path == Path(__file__).resolve():
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and any(p in node.value for p in FORBIDDEN_PATHS):
                found.append(f"{rel}: names {node.value!r}")
    return found


def loaded(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    modules = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in modules} & FORBIDDEN)

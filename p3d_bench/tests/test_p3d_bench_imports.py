"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program under test.

The walk follows every import of the benchmark's modules (the harness,
its scripts, the metric readers and the reference) into the modules of
this repository that they reach, transitively, and compares each
imported module's top-level name (the part before the first dot) whole.
A child process then runs a tiny cell on the CPU with those packages
blocked."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import bench_tiny

ROOT = bench_tiny.ROOT
BENCH = ROOT / "p3d_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "pseudo_3d_interpolation_tpu"}
PORT = "pseudo_3d_interpolation_torch"


def _module_path(name: str) -> Path | None:
    """The repository's file of module ``name``, if it is one."""
    base = ROOT.joinpath(*name.split("."))
    for p in (base.with_suffix(".py"), base / "__init__.py"):
        if p.is_file():
            return p
    return None


def _imports(path: Path, package: str) -> set[str]:
    """The absolute names ``path`` imports anywhere in its body."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split(".")
                base = ".".join(parts[:len(parts) - node.level + 1])
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module
            out.add(mod)
            out.update(f"{mod}.{a.name}" for a in node.names)
    return out


def _walk(start: list[Path]) -> dict[str, set[str]]:
    """{file: the names it imports} over everything reachable."""
    seen: dict[str, set[str]] = {}
    todo = list(start)
    while todo:
        path = todo.pop()
        key = str(path.relative_to(ROOT))
        if key in seen:
            continue
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        package = ".".join(parts if path.name == "__init__.py"
                           else parts[:-1])
        names = _imports(path, package or "p3d_bench")
        seen[key] = names
        for n in names:
            p = _module_path(n)
            if p is not None:
                todo.append(p)
    return seen


def _bench_files() -> list[Path]:
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_module_the_benchmark_reaches_imports_jax():
    reached = _walk(_bench_files())
    assert any(k.startswith(PORT) for k in reached)  # the walk reaches it
    bad = {(f, n) for f, names in reached.items() for n in names
           if n.split(".")[0] in FORBIDDEN}
    assert not bad, sorted(bad)


def test_the_reference_imports_nothing_of_the_program():
    """The reference, its bases' modules with it, reaches only its own
    files and the frozen work count that the bases' counts build on."""
    files = list((BENCH / "reference").rglob("*.py"))
    reached = _walk(files)
    bad = {(f, n) for f, names in reached.items() for n in names
           if n.split(".")[0] in FORBIDDEN | {PORT}}
    assert not bad, sorted(bad)
    work = {"p3d_bench/__init__.py", "p3d_bench/work.py"}
    assert set(reached) == {str(p.relative_to(ROOT)) for p in files} | work


def test_a_tiny_run_with_jax_blocked():
    code = textwrap.dedent(f"""
        import sys, time
        BLOCK = {sorted(FORBIDDEN)!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCK:
                    raise ImportError(f"blocked: {{name}}")
                return None

        for m in list(sys.modules):
            if m.split(".")[0] in BLOCK:
                del sys.modules[m]
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(BENCH / "tests")!r})
        import torch
        import bench_tiny
        from p3d_bench import harness
        cell = bench_tiny.tiny_cell("shearlet_cube_1chip")
        cell = cell._replace(check=dict(cell.check,
                                        limits={{"rel_l2": 1e-3}}))
        rc = harness.run_rank(cell, 9, 0.01, False, time.time(),
                              harness.Ranks(), torch.device("cpu"))
        assert rc == 0, rc
        assert not harness.forbidden_modules()
    """)
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert got.returncode == 0, got.stderr[-3000:]
    assert '"correct": true' in got.stdout.splitlines()[-1]

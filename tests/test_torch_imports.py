"""The port stands alone: no module of ``src/repro_torch/`` and nothing in
``chip_smoke.py`` or ``kernel_probe.py`` imports ``jax`` or the reference
package ``repro``.

The check walks every ``.py`` file's syntax tree, so imports inside
functions (the lazy ones) count as much as those at the top.  Relative
imports stay inside the port.  A control: the same walk finds the
reference's own imports of JAX, and a planted lazy ``import repro.core``.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def forbidden_imports(source: str, name: str):
    """(line, module) of every import of a forbidden top-level package."""
    out = []
    for node in ast.walk(ast.parse(source, name)):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        out += [(node.lineno, m) for m in mods
                if m.split(".")[0] in FORBIDDEN]
    return out


def port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "kernel_probe.py"]


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    assert forbidden_imports(path.read_text(), str(path)) == []


@pytest.mark.parametrize("module", [
    "train/__init__.py", "train/checkpoint.py", "launch/__init__.py",
    "launch/serve.py", "configs/qwen2_7b.py", "kernels/fnv1a.py"])
def test_the_walk_covers_the_weight_leg(module):
    """The weight leg's modules are among the files walked, and import."""
    import importlib
    path = ROOT / "src" / "repro_torch" / module
    assert path in port_files()
    name = "repro_torch." + module.removesuffix(".py").replace("/", ".") \
        .removesuffix(".__init__")
    importlib.import_module(name)


def test_the_walk_finds_what_it_must():
    assert len(port_files()) > 40
    sim = (ROOT / "src" / "repro" / "core" / "simulator.py").read_text()
    assert (227, "repro.kernels.maxmin") in forbidden_imports(sim, "sim")
    planted = "def f():\n    if True:\n        import repro.core as c\n" \
              "from jax import numpy\nimport repro_torch\nfrom . import x\n"
    assert sorted(forbidden_imports(planted, "planted")) == \
        [(3, "repro.core"), (4, "jax")]

"""The port stands alone: no module of ``src/repro_torch`` (the coding
stack and ``run_federated`` included) and nothing in ``chip_smoke.py`` or
``cudnn_cost.py`` imports JAX or the JAX package ``repro``, ``repro.obs``
included (an AST walk, so imports inside functions count too).  None
imports ``msgpack`` (the checkpoint format's msgpack is the port's own),
and ``zstandard`` is imported only inside a ``try``, as an option."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "cudnn_cost.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_has_modules():
    assert len(FILES) > 20


@pytest.mark.parametrize("module", [
    "coding/__init__.py", "coding/errors.py", "coding/bitstream.py",
    "coding/golomb.py", "coding/cabac.py", "coding/nnc.py", "core/fsfl.py",
    "kernels/level_assign.py", "kernels/delta_apply.py",
    "kernels/row_stats.py", "kernels/scaled_matmul.py", "core/prand.py",
    "comms/channel.py", "comms/codec.py", "comms/device.py",
    "comms/pool.py", "fl/rounds.py", "obs/__init__.py", "obs/trace.py",
    "obs/metrics.py", "fl/ingest/__init__.py", "fl/ingest/stream.py",
    "checkpoint/__init__.py", "checkpoint/io.py",
    "fl/population/__init__.py", "fl/population/store.py",
    "fl/population/traffic.py", "fl/population/virtual.py"])
def test_walk_covers_the_main_path_modules(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _imports(tree) -> list[tuple[ast.AST, str]]:
    """(node, imported root) of every import statement under ``tree``."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node, node.module.split(".")[0]))
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_msgpack_and_zstandard_only_inside_a_try(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = _imports(tree)
    assert "msgpack" not in {r for _, r in roots}, (
        f"{path.relative_to(ROOT)} imports msgpack")
    guarded = {id(n) for t in ast.walk(tree) if isinstance(t, ast.Try)
               for stmt in t.body for n, _ in _imports(stmt)}
    for node, root in roots:
        if root == "zstandard":
            assert id(node) in guarded, (
                f"{path.relative_to(ROOT)}:{node.lineno} imports zstandard "
                "outside a try")


def test_the_walk_catches_msgpack_and_a_bare_zstandard():
    bad = ast.parse("import msgpack\nimport zstandard\n"
                    "try:\n    import zstandard as z\nexcept ImportError:\n"
                    "    z = None\n")
    roots = _imports(bad)
    assert [r for _, r in roots] == ["msgpack", "zstandard", "zstandard"]
    guarded = {id(n) for t in ast.walk(bad) if isinstance(t, ast.Try)
               for stmt in t.body for n, _ in _imports(stmt)}
    assert [id(n) in guarded for n, _ in roots] == [False, False, True]

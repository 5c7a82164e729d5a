"""The port's public surface against the reference's, by AST walk only
(no module of either package is imported, JAX included).

For each module of ``src/repro/`` (one case each):

* every public top-level name it defines (a ``def``, ``class`` or
  assignment not starting with ``_``) is bound at the top of the port's
  module of the same path (defined or imported there);
* for a package ``__init__``, every name it exports (its ``__all__``, or
  its public bindings) is bound in the port's ``__init__`` and resolves:
  an import from ``repro_torch.x.y`` names something module ``x.y`` binds
  in turn (or a submodule of it).

``EXCEPTIONS`` names what has no counterpart, each with its reason, and
the cases check the reason too.  A last test shows the walk catching a
name taken out of the port."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))

# modules of the reference the port does not have, and why
MODULE_EXCEPTIONS = {
    "launch/train.py": "the reference cannot run it: it imports "
                       "repro.dist.{collectives,sharding,train_step}, which "
                       "src/repro/dist/ does not have",
    "launch/dryrun.py": "the reference cannot run it: it imports "
                        "repro.dist.{collectives,sharding,train_step,"
                        "serve_step}, which src/repro/dist/ does not have",
}
# names of a reference module the port's module of that path does not
# bind, and why
NAME_EXCEPTIONS = {
    ("comms/codecs.py", "jax_sds"): "JAX-only: a jax.ShapeDtypeStruct",
    ("kernels/ops.py", "INTERPRET"): "JAX-only: Pallas's interpret-mode "
                                     "switch, from jax.default_backend()",
    ("kernels/delta_compress.py", "delta_apply"): "lives in "
                                                  "kernels/delta_apply.py",
}
MOVED = {("kernels/delta_compress.py", "delta_apply"):
         "kernels/delta_apply.py"}


def _top_statements(body):
    """Top-level statements, into ``if``/``try``/``with`` blocks (not into
    function or class bodies)."""
    for node in body:
        yield node
        if isinstance(node, (ast.If, ast.With)):
            yield from _top_statements(node.body)
            yield from _top_statements(getattr(node, "orelse", []))
        elif isinstance(node, ast.Try):
            for part in (node.body, node.orelse, node.finalbody,
                         *(h.body for h in node.handlers)):
                yield from _top_statements(part)


def _targets(node):
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        targets = [node.target]
    else:
        return []
    return [n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)]


def defined(source: str) -> set[str]:
    """Names a module defines at its top: functions, classes,
    assignments."""
    out = set()
    for node in _top_statements(ast.parse(source).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        out.update(_targets(node))
    return out


def imports(source: str) -> dict[str, tuple[str | None, str]]:
    """Names a module binds by import -> (the module, the imported name);
    a plain ``import a.b`` binds ``a`` to (None, ``a.b``)."""
    out = {}
    for node in _top_statements(ast.parse(source).body):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            for a in node.names:
                out[a.asname or a.name] = (node.module, a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (None, a.name)
    return out


def bound(source: str) -> set[str]:
    return defined(source) | set(imports(source))


def public(names) -> set[str]:
    return {n for n in names if not n.startswith("_")}


def exports(source: str) -> set[str]:
    """An ``__init__``'s exports: its ``__all__``, else its public
    bindings."""
    for node in _top_statements(ast.parse(source).body):
        if "__all__" in _targets(node):
            return set(ast.literal_eval(node.value))
    return public(bound(source))


def _module_file(module: str) -> Path | None:
    """The port's file of a dotted ``repro_torch`` module name."""
    parts = module.split(".")
    if parts[0] != "repro_torch":
        return None
    base = PORT.joinpath(*parts[1:])
    for p in (base.with_suffix(".py"), base / "__init__.py"):
        if p.is_file():
            return p
    return None


def resolves(source: str, name: str, depth: int = 4) -> bool:
    """``name`` is bound in ``source`` and, where imported from another
    module of the port, bound there too (or a submodule of it)."""
    if name in defined(source):
        return True
    src = imports(source).get(name)
    if src is None:
        return False
    module, real = src
    if module is None or not module.startswith("repro_torch"):
        return module is not None or real.startswith("repro_torch")
    target = _module_file(module)
    if target is None:
        return False
    if target.name == "__init__.py" and (
            (target.parent / f"{real}.py").is_file()
            or (target.parent / real / "__init__.py").is_file()):
        return True
    return depth > 0 and resolves(target.read_text(), real, depth - 1)


def missing(rel: str, ref_source: str, port_source: str) -> list[str]:
    """The reference module's public names (an ``__init__``'s exports)
    with no counterpart in the port's source, less ``NAME_EXCEPTIONS``."""
    if rel.endswith("__init__.py"):
        want = exports(ref_source)
        gaps = [n for n in want if not resolves(port_source, n)]
    else:
        gaps = sorted(public(defined(ref_source)) - bound(port_source))
    return sorted(n for n in gaps if (rel, n) not in NAME_EXCEPTIONS)


def imports_anywhere(source: str) -> list[tuple[str, str]]:
    """(module, name) of every ``from`` import in ``source``, inside
    functions too."""
    return [(n.module, a.name) for n in ast.walk(ast.parse(source))
            if isinstance(n, ast.ImportFrom) and n.level == 0
            for a in n.names]


def _ref_module_file(module: str) -> Path | None:
    base = REF.joinpath(*module.split(".")[1:])
    for p in (base.with_suffix(".py"), base / "__init__.py"):
        if p.is_file():
            return p
    return None


def test_walk_covers_the_reference():
    assert len(MODULES) > 60 and "fl/rounds.py" in MODULES


@pytest.mark.parametrize("rel", MODULES)
def test_port_has_every_public_name(rel):
    ref_source = (REF / rel).read_text()
    port = PORT / rel
    if rel in MODULE_EXCEPTIONS:
        assert not port.exists(), f"{rel} is ported: drop its exception"
        absent = [m for m, _ in imports_anywhere(ref_source)
                  if m.startswith("repro.dist.")
                  and _ref_module_file(m) is None]
        assert absent, f"{rel}: its exception's reason no longer holds"
        return
    assert port.is_file(), f"the port has no {rel}"
    gaps = missing(rel, ref_source, port.read_text())
    assert not gaps, f"repro_torch/{rel} lacks {gaps}"
    for (where, name), to in MOVED.items():
        if where == rel:
            assert name in defined((PORT / to).read_text()), (
                f"{name} is not in repro_torch/{to}")


def test_name_exceptions_hold():
    """Each named exception is still a name of its reference module, and
    the JAX-only ones are defined from JAX."""
    for (rel, name), why in NAME_EXCEPTIONS.items():
        source = (REF / rel).read_text()
        assert name in defined(source), (rel, name)
        if why.startswith("JAX-only"):
            tree = ast.parse(source)
            node = next(n for n in tree.body
                        if getattr(n, "name", None) == name
                        or name in _targets(n))
            assert "jax" in ast.unparse(node), (rel, name)


@pytest.mark.parametrize("rel,name", [
    ("fl/scenarios.py", "list_scenarios"),
    ("fl/__init__.py", "list_scenarios"),
    ("optim/__init__.py", "global_norm")])
def test_walk_catches_a_name_taken_out(rel, name):
    """The port's module with ``name``'s definition (or its import in an
    ``__init__``) taken out fails the walk for that name alone."""
    source = (PORT / rel).read_text()
    tree = ast.parse(source)
    kept = []
    for node in tree.body:
        if getattr(node, "name", None) == name:
            continue
        if isinstance(node, ast.ImportFrom):
            node.names = [a for a in node.names if a.name != name]
            if not node.names:
                continue
        kept.append(node)
    tree.body = kept
    cut = ast.unparse(tree)
    ref_source = (REF / rel).read_text()
    assert missing(rel, ref_source, source) == []
    assert missing(rel, ref_source, cut) == [name]


def test_walk_follows_an_import_to_its_module():
    """An ``__init__`` import of a name its module does not bind does not
    resolve."""
    src = "from repro_torch.fl.scenarios import no_such_name\n"
    assert "no_such_name" in bound(src)
    assert not resolves(src, "no_such_name")
    assert resolves("from repro_torch.fl.scenarios import list_scenarios\n",
                    "list_scenarios")
    assert resolves("from repro_torch.data import federated\n", "federated")

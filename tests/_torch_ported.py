"""Run the reference's own test code against the port's copies.

``against_the_copy("test_simulator_baselines.py")`` executes a reference
test module's text with its ``repro.`` import lines rebound to
``repro_torch.`` and returns its namespace: its test classes, helpers and
checks, now bound to the port's modules. A port test module takes the
classes it wants by name (``TestX = ns["TestX"]``), and pytest collects
them there. With ``only``, just the module's import lines and those
top-level definitions run; ``omit`` drops the import lines of the modules
it names, for a module that imports one the port does not copy.

Nothing here touches ``sys.modules``: the namespace is a fresh dict, and
the reference's test modules stay as they are for every other test.
"""

import ast
import re
from pathlib import Path

TESTS = Path(__file__).resolve().parent
_IMPORT = re.compile(r"^(\s*)(from|import) repro\.", re.M)


def _defined(node) -> set[str]:
    """The top-level names a statement defines."""
    if isinstance(node, ast.Assign):
        return {target.id for target in node.targets if isinstance(target, ast.Name)}
    return {getattr(node, "name", None)}


def _imported(node) -> list[str]:
    if isinstance(node, ast.ImportFrom):
        return [node.module or ""]
    return [alias.name for alias in node.names]


def against_the_copy(name: str, *, only: tuple = (), omit: tuple = ()) -> dict:
    path = TESTS / name
    text = path.read_text()
    if only:
        tree = ast.parse(text)
        keep = [node for node in tree.body
                if _defined(node) & set(only)
                or (isinstance(node, (ast.Import, ast.ImportFrom))
                    and not any(m.startswith(omit) for m in _imported(node)))]
        text = "\n\n".join(ast.get_source_segment(text, node) for node in keep)
    ns = {"__name__": f"{path.stem}_against_the_copy", "__file__": str(path)}
    exec(compile(_IMPORT.sub(r"\1\2 repro_torch.", text), str(path), "exec"), ns)
    missing = set(only) - set(ns)
    assert not missing, f"{name} has no {sorted(missing)}"
    return ns

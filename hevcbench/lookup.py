"""Where the harness finds what a cell names.

Mixes, drivers, entry points and the reference's side of each are files
found by name in directories searched in order: ``DIRS`` holds the
benchmark's own directory alone; the CPU tests put a fixture's directory
before it.  Each directory lies under the checkout's root, and its modules
are imported by their dotted path from there.

An entry point is a pair of modules of one name: ``entries/<name>.py``, the
program's side, whose functions take the ``Program`` and call the port, and
``reference/<name>.py``, the reference's side, plain PyTorch with the same
function names and output keys.  A configuration names its pairs under
"entries"; each public top-level function of a side becomes an entry point
of that side's object under its own name."""

from __future__ import annotations

import ast
import importlib
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "hevcbench"
DIRS = (BENCH,)
SIDES = ("entries", "reference")


def find(kind: str, name: str, suffix: str = ".py", dirs=DIRS) -> Path:
    """``<dir>/<kind>/<name><suffix>`` in the first of ``dirs`` that has it."""
    for d in dirs:
        path = Path(d) / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind}/{name}{suffix} in {', '.join(map(str, dirs))}")


def module(path: Path):
    """The checkout's module at ``path``, imported by its dotted path."""
    return importlib.import_module(".".join(path.relative_to(ROOT).with_suffix("").parts))


def entry_names(path: Path) -> list[str]:
    """A side's entry points: its public top-level functions, read from the
    source without importing it."""
    tree = ast.parse(path.read_text(), str(path))
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")]


def bind(obj, names, side: str, dirs=DIRS) -> list:
    """Bind the entry points of one side ("entries": the program's,
    "reference": the reference's) of the named entries to ``obj``, each
    under its own name, and return that side's modules.  Everything is
    checked before anything is imported; else ValueError: both sides of
    every pair are there and define the same entry points, and none of them
    is a name that ``obj`` already has or that another entry gives."""
    paths, taken = [], set()
    for name in names:
        pair = {}
        for s in SIDES:
            try:
                pair[s] = find(s, name, dirs=dirs)
            except FileNotFoundError as e:
                raise ValueError(f"entry {name!r} has no {s} side: {e}") from None
        defined = [sorted(entry_names(pair[s])) for s in SIDES]
        if defined[0] != defined[1] or not defined[0]:
            raise ValueError(f"entry {name!r}: the program's side defines {defined[0]}, the "
                             f"reference's {defined[1]}")
        for fn in defined[0]:
            if fn in taken or hasattr(obj, fn):
                raise ValueError(f"entry point {fn!r} of entry {name!r} clashes with one that "
                                 f"{type(obj).__name__} already has")
            taken.add(fn)
        paths.append(pair[side])
    modules = [module(p) for p in paths]
    for mod in modules:
        for fn in entry_names(Path(mod.__file__)):
            setattr(obj, fn, types.MethodType(getattr(mod, fn), obj))
    return modules

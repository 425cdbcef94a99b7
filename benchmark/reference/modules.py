"""The benchmark's one loader of its own modules by their paths (the
harness's and the references'): benchmark/<kind>/<name>.py, whose names
hold dots and dashes that an import statement cannot spell. It holds no
program code, so the references that use it stay independent of the
program."""

from __future__ import annotations

import importlib.util
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent.parent      # benchmark/


def load(kind: str, name: str):
    """The module <kind>/<name>.py of the benchmark, loaded once a process
    by its path."""
    key = f"_bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod

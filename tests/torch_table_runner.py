"""Run a JAX test module's cases again on the port.

A case is a test method of a class in one of the JAX package's test
modules. Before it runs, `swap` replaces the names it calls, in its own
module and in the JAX modules its body imports from, with the port's
(each name must exist: a renamed one fails loudly), so the same body
checks the port. Fixture arguments (`tmp_path`, `monkeypatch`) are taken
from the calling test's `request`.

Imports neither package: the caller passes the modules in.
"""

from __future__ import annotations

import inspect

import pytest


def _slow(fn) -> bool:
    return any(m.name == "slow" for m in getattr(fn, "pytestmark", []))


def table_params(classes, skip=()) -> list:
    """One `pytest.param(cls, name)` for each test method of `classes`,
    but the names in `skip` and the cases the JAX suite marks slow (which
    the tier-1 run deselects there too)."""
    return [pytest.param(cls, name, id=f"{cls.__name__}.{name}")
            for cls in classes for name in sorted(vars(cls))
            if name.startswith("test_") and name not in skip
            and not _slow(vars(cls)[name])]


def swap(monkeypatch, module, names: dict) -> None:
    """`module`'s attributes `names` replaced for the test's length."""
    for name, value in names.items():
        assert hasattr(module, name), (module.__name__, name)
        monkeypatch.setattr(module, name, value)


def run_case(cls, name: str, request) -> None:
    """Call `cls().name(...)` with its fixture arguments."""
    method = getattr(cls(), name)
    kwargs = {arg: request.getfixturevalue(arg)
              for arg in inspect.signature(method).parameters}
    method(**kwargs)


def mirror(monkeypatch, jax_module, port_module, **overrides) -> None:
    """Every public name of `jax_module` that `port_module` also has,
    replaced by the port's, then `overrides` on top, for the test's
    length."""
    names = {
        name: getattr(port_module, name) for name in vars(jax_module)
        if not name.startswith("_") and hasattr(port_module, name)
        and not inspect.ismodule(getattr(port_module, name))
    }
    names.update(overrides)
    swap(monkeypatch, jax_module, names)


class PortSubprocess:
    """Stands in for the `subprocess` module in a JAX test module: a
    command `[python, "-m", jax_module, ...]` runs `port_module` instead,
    with `extra` arguments appended (the daemon's `--device cpu`); any
    other command and every other attribute pass through."""

    def __init__(self, real, jax_module: str, port_module: str,
                 extra=()):
        self._real = real
        self._jax = jax_module
        self._port = port_module
        self._extra = list(extra)

    def __getattr__(self, name):
        return getattr(self._real, name)

    def _argv(self, argv):
        argv = list(argv)
        if (len(argv) > 2 and argv[1] == "-m" and argv[2] == self._jax):
            argv[2] = self._port
            if "--help" not in argv:
                argv += self._extra
        return argv

    def Popen(self, argv, *args, **kw):
        return self._real.Popen(self._argv(argv), *args, **kw)

    def run(self, argv, *args, **kw):
        return self._real.run(self._argv(argv), *args, **kw)

"""Run the JAX package's own test cases against the port.

``case_on(module, name, package)`` returns ``module.name``, a case of a JAX
test module, ready to call with its fixtures' values. For
``package == "lemon_tpu_torch"``:

- every name the module imports from ``lemon_tpu.*`` at its top is bound
  to the same name of the port's twin module (``lemon_tpu.cli.sweep`` ->
  ``lemon_tpu_torch.cli.sweep``), in the case and in the module's helper
  functions that the case calls;
- every ``lemon_tpu.*`` module that the test module imports inside a
  function resolves to the port's twin while the case runs.

So the case's own body, unchanged, runs on the port. For ``"lemon_tpu"``
the case is returned as it is.
"""

import ast
import contextlib
import importlib
import sys
import types
from pathlib import Path

import pytest

PACKAGES = ("lemon_tpu", "lemon_tpu_torch")


def twin(name: str):
    """The port's module of the JAX module ``name``."""
    return importlib.import_module("lemon_tpu_torch" + name[len("lemon_tpu"):])


def _member(module_name: str, attr: str):
    """``from module_name import attr`` on the port's twin (a submodule when
    ``attr`` names one)."""
    mod = twin(module_name)
    if hasattr(mod, attr):
        return getattr(mod, attr)
    return twin(f"{module_name}.{attr}")


def _imports(module):
    """({bound name: (JAX module, attribute or None)} of the module's top
    imports from ``lemon_tpu``, the JAX modules it imports inside functions)."""
    tree = ast.parse(Path(module.__file__).read_text())
    top, inner = {}, set()
    for node in ast.walk(tree):
        at_top = node in tree.body
        if isinstance(node, ast.ImportFrom) and node.level == 0 and (node.module or "").startswith("lemon_tpu."):
            for a in node.names:
                if at_top:
                    top[a.asname or a.name] = (node.module, a.name)
                else:
                    inner.add(node.module)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith("lemon_tpu."):
                    if at_top:
                        top[a.asname or a.name] = (a.name, None)
                    else:
                        inner.add(a.name)
    return top, sorted(inner)


@contextlib.contextmanager
def _inner_imports_on_the_port(names):
    with pytest.MonkeyPatch.context() as mp:
        for name in names:
            port = twin(name)
            importlib.import_module(name)  # the JAX module, restored on exit
            parent, _, child = name.rpartition(".")
            mp.setitem(sys.modules, name, port)
            mp.setattr(importlib.import_module(parent), child, port)
        yield


def case_on(module, name: str, package: str):
    case = getattr(module, name)
    if package == "lemon_tpu":
        return case
    top, inner = _imports(module)
    names = dict(module.__dict__)
    for bound, (mod, attr) in top.items():
        names[bound] = twin(mod) if attr is None else _member(mod, attr)
    for key, val in module.__dict__.items():
        if isinstance(val, types.FunctionType) and val.__module__ == module.__name__:
            names[key] = types.FunctionType(val.__code__, names, val.__name__, val.__defaults__, val.__closure__)

    def run(*args, **kwargs):
        with _inner_imports_on_the_port(inner):
            return names[name](*args, **kwargs)

    run.case = names[name]  # the rebound case
    return run


def run_case(request, module, name: str, package: str):
    """``case_on(...)`` called with the fixtures its signature names."""
    import inspect

    args = inspect.signature(getattr(module, name)).parameters
    return case_on(module, name, package)(**{arg: request.getfixturevalue(arg) for arg in args})

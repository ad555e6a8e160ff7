"""Reflection helpers for string-based configuration (own copy of
``dlwp_tpu.utils.reflection``): resolve declarative names of modules,
classes and methods.
"""

from __future__ import annotations

import importlib
import inspect


def get_from_module(module_name: str, attr: str):
    """Import ``module_name`` and fetch ``attr`` from it."""
    mod = importlib.import_module(module_name)
    try:
        return getattr(mod, attr)
    except AttributeError:
        raise AttributeError(
            f"module {module_name!r} has no attribute {attr!r}"
        ) from None


def get_classes(module_name: str) -> dict[str, type]:
    """All classes defined in (or exported by) a module, by name."""
    mod = importlib.import_module(module_name)
    return dict(inspect.getmembers(mod, inspect.isclass))


def get_methods(cls) -> dict[str, object]:
    """All public methods of a class, by name."""
    return {
        n: m
        for n, m in inspect.getmembers(cls, inspect.isfunction)
        if not n.startswith("_")
    }

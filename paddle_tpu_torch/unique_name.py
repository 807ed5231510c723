"""fluid.unique_name module surface (generate / guard / switch).
Delegates to the framework's namespace helper, so there is one generator
state."""
from __future__ import annotations

from . import framework as _fw

__all__ = ["generate", "guard", "switch"]


def generate(key):
    return _fw.unique_name.generate(key)


def guard(new_generator=None):
    return _fw.unique_name.guard(new_generator)


def switch(new_generator=None):
    """Swap the active generator; returns the previous one. With no
    argument, starts a fresh namespace."""
    old = _fw._name_gen
    _fw._name_gen = new_generator or _fw._UniqueNameGenerator()
    return old

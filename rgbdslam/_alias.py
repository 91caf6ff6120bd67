"""Keep a former package name importable as an alias of ``rgbdslam``.

``install(old)`` adds an import hook under which ``old.x.y`` is the module
``rgbdslam.x.y`` itself (one module object, not a copy), and
``python -m old.cli`` runs ``rgbdslam.cli``.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import sys

_TARGET = "rgbdslam"


class _AliasLoader(importlib.abc.Loader):
    def __init__(self, real: str, real_spec):
        self.real, self.real_spec = real, real_spec

    def create_module(self, spec):
        return importlib.import_module(self.real)

    def exec_module(self, module):
        # the import system stamps the alias spec on the module it got
        # from create_module; give the shared module its own back
        module.__spec__ = self.real_spec

    def get_code(self, fullname):
        """For ``python -m``: the real module's code."""
        return self.real_spec.loader.get_code(self.real)


class _AliasFinder(importlib.abc.MetaPathFinder):
    def __init__(self, alias: str):
        self.alias = alias

    def find_spec(self, name, path=None, target=None):
        if not name.startswith(self.alias + "."):
            return None
        real = _TARGET + name[len(self.alias):]
        real_spec = importlib.util.find_spec(real)
        if real_spec is None:
            return None
        return importlib.util.spec_from_loader(
            name, _AliasLoader(real, real_spec), origin=real_spec.origin,
            is_package=real_spec.submodule_search_locations is not None)


def install(alias: str) -> _AliasFinder:
    """Route imports under `alias` to ``rgbdslam``; returns the hook."""
    sys.modules.setdefault(alias, importlib.import_module(_TARGET))
    finder = _AliasFinder(alias)
    # ahead of the path finder, which would load a second copy of each file
    sys.meta_path.insert(0, finder)
    return finder

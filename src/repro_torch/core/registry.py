"""Generic name-based component registry.

One implementation behind every ``repro.platform`` registry
(schedulers, scenario kinds, trace programs, routers): a dict with
duplicate-registration protection and a consistent unknown-name error
that lists what *is* registered.  ``register`` doubles as a decorator
when called without an object.
"""
from __future__ import annotations

from typing import Any, Dict, List


class Registry:
    """Named components of one ``kind`` (used in error messages)."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Any] = {}

    def register(self, name: str, obj: Any = None, *,
                 overwrite: bool = False):
        """Register ``obj`` under ``name``; duplicate names raise unless
        ``overwrite=True``.  With ``obj=None`` returns a decorator."""
        def _do(o):
            if name in self._items and not overwrite:
                raise ValueError(
                    f"{self.kind} {name!r} already registered "
                    f"(pass overwrite=True to replace)")
            self._items[name] = o
            return o
        return _do if obj is None else _do(obj)

    def get(self, name: str) -> Any:
        obj = self._items.get(name)
        if obj is None:
            raise ValueError(f"unknown {self.kind} {name!r} "
                             f"(registered: {self.names()})")
        return obj

    def names(self) -> List[str]:
        return sorted(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items

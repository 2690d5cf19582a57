"""Typed name registries (counterpart of ``paddlefleetx_tpu/utils/registry.py``):
the config's ``name:`` keys resolve through these instead of ``eval()``.
The port registers its datasets in ``DATASETS`` and its tokenizers in
``TOKENIZERS``."""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str = None):
        def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
            key = name or fn.__name__
            if key in self._entries:
                raise KeyError(f"{self.kind} {key!r} already registered")
            self._entries[key] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable[..., Any]:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} {name!r}; known: {sorted(self._entries)}"
            )
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self):
        return sorted(self._entries)


DATASETS = Registry("dataset")
TOKENIZERS = Registry("tokenizer")

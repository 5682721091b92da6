"""Registries mapping config ``type`` strings to builder callables (the
port's copy of ``pairnet_tpu/config/registry.py``; of its registries only
the datasets' is used here: models are built by
``models.frameworks.psgtr.build_model``).

The reference resolves type strings against mmcv registries populated by
``@register_module()`` decorators at ``custom_imports`` time
(ref: SURVEY.md §3.4; pairnet/models/__init__.py). Here registration is
explicit and import-time deterministic: each subpackage registers its public
classes on import.
"""

from __future__ import annotations

from typing import Callable


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._items: dict[str, Callable] = {}

    def register(self, name: str | None = None):
        def deco(obj: Callable) -> Callable:
            key = name or obj.__name__
            if key in self._items and self._items[key] is not obj:
                raise KeyError(f"{key} already registered in {self.name}")
            self._items[key] = obj
            return obj

        return deco

    def get(self, key: str) -> Callable:
        if key not in self._items:
            raise KeyError(
                f"'{key}' not found in registry '{self.name}'. "
                f"Available: {sorted(self._items)}"
            )
        return self._items[key]

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def keys(self):
        return self._items.keys()


DATASETS = Registry("datasets")

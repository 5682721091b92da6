"""Hierarchical config system (the port's copy of ``pairnet_tpu/config/core.py``).

Re-provides the capability surface of the reference's mmcv Config
(ref: configs/** used via Config.fromfile in tools/train.py:118-127):

* Python-file configs with ``_base_`` inheritance chains,
* deep merge with ``_delete_=True`` subtree replacement
  (ref: configs/_base_/models/panoptic_fpn_r50_fpn_psg.py:46),
* dotted-path CLI overrides (``--cfg-options model.head.num_queries=50``,
  ref: tools/train.py:78-88),
* ``${var}`` interpolation against top-level keys (ref: tools/train.py:121),
* dump/round-trip to JSON.

Unlike mmcv there is no runtime ``custom_imports`` machinery — model assembly
is done by the explicit registry in :mod:`pairnet_torch.config.registry`.
"""

from __future__ import annotations

import ast
import copy
import json
import os
import re
from typing import Any, Iterator, Mapping

_DELETE_KEY = "_delete_"
_BASE_KEY = "_base_"


class Config(dict):
    """A dict with attribute access and deep-merge semantics."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    # -- construction -----------------------------------------------------
    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    def __init__(self, *args, **kwargs):
        super().__init__()
        for src in list(args) + [kwargs]:
            if src:
                for k, v in dict(src).items():
                    self[k] = Config._wrap(v)

    def copy(self) -> "Config":
        return copy.deepcopy(self)

    # -- merge ------------------------------------------------------------
    def merge(self, other: Mapping) -> "Config":
        """Deep-merge ``other`` into a copy of self; honors ``_delete_``."""
        out = self.copy()
        _merge_into(out, other)
        return out

    # -- dotted access ----------------------------------------------------
    def get_path(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in _split_path(path):
            try:
                node = node[part]
            except (KeyError, IndexError, TypeError):
                return default
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = _split_path(path)
        node: Any = self
        for part in parts[:-1]:
            if isinstance(part, int):
                node = node[part]
            else:
                if part not in node or not isinstance(node[part], (dict, list)):
                    node[part] = Config()
                node = node[part]
        node[parts[-1]] = Config._wrap(value)

    # -- io -----------------------------------------------------------------
    def to_dict(self) -> dict:
        def conv(v: Any) -> Any:
            if isinstance(v, Mapping):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v

        return conv(self)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)

    def pretty(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


def _split_path(path: str) -> list:
    """'a.b.0.c' -> ['a', 'b', 0, 'c'] (ints index into lists)."""
    parts: list = []
    for p in path.split("."):
        parts.append(int(p) if re.fullmatch(r"-?\d+", p) else p)
    return parts


def _merge_into(dst: Config, src: Mapping) -> None:
    for key, val in src.items():
        if key == _DELETE_KEY:
            continue
        if (
            isinstance(val, Mapping)
            and not val.get(_DELETE_KEY, False)
            and isinstance(dst.get(key), Mapping)
        ):
            _merge_into(dst[key], val)
        else:
            if isinstance(val, Mapping):
                val = {k: v for k, v in val.items() if k != _DELETE_KEY}
            dst[key] = Config._wrap(val)


def _exec_config_file(path: str) -> dict:
    """Execute a Python config file and collect its top-level names."""
    with open(path) as f:
        source = f.read()
    namespace: dict = {"__file__": os.path.abspath(path), "os": os}
    code = compile(source, path, "exec")
    exec(code, namespace)  # noqa: S102 - config files are trusted project files
    return {
        k: v
        for k, v in namespace.items()
        if not k.startswith("__") and not callable(v) and k != "os"
    }


def load_config(path: str) -> Config:
    """Load a Python or JSON config file, resolving ``_base_`` chains."""
    path = os.path.abspath(path)
    if path.endswith(".json"):
        with open(path) as f:
            raw = json.load(f)
    elif path.endswith(".py"):
        raw = _exec_config_file(path)
    else:
        raise ValueError(f"unsupported config format: {path}")

    bases = raw.pop(_BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]
    cfg = Config()
    for base in bases:
        base_path = os.path.join(os.path.dirname(path), base)
        cfg = cfg.merge(load_config(base_path))
    cfg = cfg.merge(raw)
    return _interpolate(cfg)


_VAR_RE = re.compile(r"\$\{([\w.]+)\}")


def _interpolate(cfg: Config) -> Config:
    """Resolve ``${dotted.path}`` string references against the root config."""

    def resolve(value: Any) -> Any:
        if isinstance(value, str):
            m = _VAR_RE.fullmatch(value)
            if m:
                return cfg.get_path(m.group(1), value)
            return _VAR_RE.sub(
                lambda mm: str(cfg.get_path(mm.group(1), mm.group(0))), value
            )
        if isinstance(value, Mapping):
            return Config({k: resolve(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            return type(value)(resolve(v) for v in value)
        return value

    return resolve(cfg)


def parse_override(text: str) -> Any:
    """Parse a CLI override value: python literal if possible, else str."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def apply_overrides(cfg: Config, options: Mapping[str, Any] | list[str]) -> Config:
    """Apply dotted-path overrides.

    ``options`` is either a mapping {path: value} or a list of "path=value"
    strings (the CLI form, ref: tools/train.py:78-88).
    """
    out = cfg.copy()
    if isinstance(options, list):
        pairs: Iterator = (s.split("=", 1) for s in options)
        options = {k: parse_override(v) for k, v in pairs}
    for path, value in options.items():
        out.set_path(path, value)
    return out

"""Attribute-style JSON experiment configs.

A copy of ``gesture_diffusion_tpu/utils/json_config.py`` (numpy/json only),
kept here so the port never imports the JAX package.  Capability parity
with the reference's config system (``utils/json_config.py:6-125``): load a JSON file or dict,
access keys as attributes, recursively wrap nested dicts, default the
experiment name ``Meta.name`` from the file stem, merge two configs, and
dump back to JSON.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator, Mapping


class JsonConfig(Mapping):
    """Immutable-ish nested config with attribute access.

    Unlike the reference (a ``dict`` subclass), this wraps a plain dict and
    exposes a read-mostly mapping interface; mutation goes through
    ``set(path, value)`` so accidental attribute writes fail loudly.
    """

    __slots__ = ("_data",)

    def __init__(self, source: "str | Mapping[str, Any] | None" = None, **kwargs: Any):
        if source is not None and kwargs:
            raise ValueError("Pass either a source (path/dict) or kwargs, not both.")
        data: Mapping[str, Any]
        if source is None:
            data = kwargs
        elif isinstance(source, str):
            name = os.path.splitext(os.path.basename(source))[0]
            with open(source, "r") as f:
                try:
                    loaded = json.load(f)
                except json.JSONDecodeError as e:
                    # name the file — the CLI surfaces this directly and a
                    # bare 'Expecting value: line 1' is unplaceable
                    raise ValueError(f"{source}: invalid JSON ({e})") from e
            if not isinstance(loaded, dict):
                raise ValueError(
                    f"{source}: config root must be a JSON object, "
                    f"got {type(loaded).__name__}")
            loaded.setdefault("Meta", {})
            loaded["Meta"].setdefault("name", name)
            data = loaded
        elif isinstance(source, Mapping):
            data = source
        else:
            raise TypeError(f"Unsupported config source type: {type(source)}")
        # re-wrap EVERY mapping child — including ones that are already
        # JsonConfig — so nested nodes are never shared by reference: with
        # aliased children, set() on a merged config (c1 + c2) mutated the
        # source configs too, despite the immutability contract below
        object.__setattr__(self, "_data", {
            k: JsonConfig(v) if isinstance(v, Mapping) else v
            for k, v in data.items()
        })

    # -- mapping interface -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __getattr__(self, attr: str) -> Any:
        try:
            return self._data[attr]
        except KeyError as e:
            raise AttributeError(f"Config has no key {attr!r}") from e

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    # -- mutation ----------------------------------------------------------
    def set(self, path: str, value: Any) -> None:
        """Set a (possibly dotted) key path, wrapping dict values."""
        keys = path.split(".")
        node = self
        for k in keys[:-1]:
            child = node._data.get(k)
            if not isinstance(child, JsonConfig):
                child = JsonConfig({})
                node._data[k] = child
            node = child
        if isinstance(value, Mapping) and not isinstance(value, JsonConfig):
            value = JsonConfig(value)
        node._data[keys[-1]] = value

    def update(self, other: Mapping[str, Any]) -> None:
        for k, v in other.items():
            self.set(k, v)

    # -- merge -------------------------------------------------------------
    def merged(self, other: "JsonConfig") -> "JsonConfig":
        """Recursive merge; conflicting scalar values must be equal."""
        out = dict(self._data)
        for k, v in other._data.items():
            if k in out:
                mine = out[k]
                if isinstance(mine, JsonConfig) and isinstance(v, JsonConfig):
                    out[k] = mine.merged(v)
                elif mine != v:
                    raise ValueError(f"Config conflict at {k!r}: {mine!r} != {v!r}")
            else:
                out[k] = v
        return JsonConfig(out)

    def __add__(self, other: "JsonConfig") -> "JsonConfig":
        return self.merged(other)

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, JsonConfig) else v
            for k, v in self._data.items()
        }

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=4)

    def __repr__(self) -> str:
        return f"JsonConfig({json.dumps(self.to_dict(), indent=2)})"

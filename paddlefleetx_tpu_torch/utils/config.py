"""Config system: YAML + ``_base_`` inheritance + dot-path CLI overrides.

Copy of the user-facing part of ``paddlefleetx_tpu/utils/config.py``
(``AttrDict``, ``parse_config`` with ``_base_`` includes and
``_inherited_: False``, the ``-o key.sub=value`` override grammar), so the
repo's YAML configs load unchanged.  ``process_configs`` keeps only what
the serving path reads: the seed, the mixed-precision section that picks
the model dtype, and a check that the config asks for one device — the
port has no multi-device layout yet.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional

import yaml


class AttrDict(dict):
    """Recursive attribute-style dict."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __deepcopy__(self, memo: Dict[int, Any]) -> "AttrDict":
        return AttrDict(
            {copy.deepcopy(k, memo): copy.deepcopy(v, memo) for k, v in self.items()}
        )

    @staticmethod
    def from_nested(d: Any) -> Any:
        if isinstance(d, dict):
            return AttrDict({k: AttrDict.from_nested(v) for k, v in d.items()})
        if isinstance(d, (list, tuple)):
            return type(d)(AttrDict.from_nested(v) for v in d)
        return d

    def to_dict(self) -> Dict[str, Any]:
        def conv(v: Any) -> Any:
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v

        return conv(self)


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Merge ``override`` into ``base`` recursively (override wins)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def parse_config(path: str) -> AttrDict:
    """Load a YAML config, resolving ``_base_`` includes relative to the
    file.  ``_base_`` may be a string or a list; later bases and the file
    itself override earlier ones.  A section holding ``_inherited_: False``
    drops the inherited section entirely."""
    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}

    bases = raw.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for base in bases:
        base_path = os.path.join(os.path.dirname(path), base)
        merged = _deep_merge(merged, parse_config(base_path).to_dict())
    merged = _deep_merge(merged, raw)

    def drop_non_inherited(d: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                if v.get("_inherited_", True) is False:
                    continue
                out[k] = drop_non_inherited(v)
            else:
                out[k] = v
        return out

    return AttrDict.from_nested(drop_non_inherited(merged))


def _parse_value(text: str) -> Any:
    """Parse an override value with YAML semantics (``'True'`` -> bool)."""
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def override_config(cfg: AttrDict, overrides: Optional[List[str]]) -> AttrDict:
    """Apply ``key.sub.path=value`` overrides in order."""
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        key, value = item.split("=", 1)
        parts = key.split(".")
        node: Any = cfg
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = AttrDict()
            node = node[p]
        node[parts[-1]] = AttrDict.from_nested(_parse_value(value))
    return cfg


def process_configs(cfg: AttrDict) -> AttrDict:
    """Fill the defaults serving reads and reject multi-device layouts.

    Any parallel degree above 1 (model, pipeline, sharding, sequence, or
    an explicit data-parallel degree) raises: the port serves on one card
    and its parallel layouts come in a later slice."""
    dist = cfg.setdefault("Distributed", AttrDict())
    degrees = {
        "dp_degree": dist.get("dp_degree"),
        "mp_degree": dist.get("mp_degree"),
        "pp_degree": dist.get("pp_degree"),
        "sep_degree": dist.get("sep_degree"),
        "sharding_degree": (dist.get("sharding") or {}).get("sharding_degree"),
    }
    wide = {k: v for k, v in degrees.items() if int(v or 1) != 1}
    if wide:
        raise NotImplementedError(
            f"parallel degrees {wide}: the PyTorch port runs on one device; "
            "multi-device layouts are a later slice of the port"
        )
    g = cfg.setdefault("Global", AttrDict())
    g.setdefault("seed", 1024)
    eng = cfg.setdefault("Engine", AttrDict())
    mix = eng.setdefault("mix_precision", AttrDict())
    mix.setdefault("enable", True)
    mix.setdefault("dtype", "bfloat16")
    return cfg


def get_config(path: str, overrides: Optional[List[str]] = None) -> AttrDict:
    """Load + override + process a config file."""
    cfg = parse_config(path)
    cfg = override_config(cfg, overrides)
    return process_configs(cfg)

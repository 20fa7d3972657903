"""One config and instantiation system (counterpart of
seed_tpu/utils/registry.py).

The reference has three (hydra ``_target_`` instantiation,
HfArgumentParser dataclasses and the LAVIS registry); this module keeps one
small mechanism in their place:

- ``register(name)``: a decorator that adds a class or function to the
  registry;
- ``instantiate(cfg, **overrides)``: builds the object a dict with a
  ``_target_`` key describes. ``_target_`` is a registry name or a dotted
  import path (``pkg.mod.Class``); ``_recursive_: false`` leaves nested
  dicts for the target to build, hydra's semantics in
  MultiModalLLM/configs/data/*.yaml.

The port keeps a registry of its own; importing
``seed_tpu_torch.registry_defs`` registers the names of ``configs/*.json``,
which build the port's objects.
"""
from __future__ import annotations

import importlib
import json
from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Any] = {}


def register(name: str) -> Callable:
    def deco(obj):
        if name in _REGISTRY and _REGISTRY[name] is not obj:
            raise KeyError(f"registry name {name!r} already taken")
        _REGISTRY[name] = obj
        return obj

    return deco


def lookup(name: str) -> Any:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if "." in name:  # dotted import path
        mod, _, attr = name.rpartition(".")
        return getattr(importlib.import_module(mod), attr)
    raise KeyError(f"unknown registry name {name!r}")


def instantiate(cfg: Any, **overrides) -> Any:
    """Build the object described by ``cfg`` (hydra-style ``_target_``
    dicts); ``overrides`` replace or add keyword arguments."""
    if not isinstance(cfg, dict) or "_target_" not in cfg:
        return cfg
    cfg = dict(cfg)
    target = lookup(cfg.pop("_target_"))
    recursive = cfg.pop("_recursive_", True)
    kwargs = {}
    for k, v in cfg.items():
        if recursive and isinstance(v, dict) and "_target_" in v:
            kwargs[k] = instantiate(v)
        else:
            kwargs[k] = v
    kwargs.update(overrides)
    return target(**kwargs)


def load_config(path: str) -> dict:
    """A JSON or YAML config file as a plain dict (YAML needs pyyaml; without
    it, a .yaml file must be JSON, YAML's subset)."""
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return json.loads(text)
    try:
        import yaml
    except ImportError:
        return json.loads(text)
    return yaml.safe_load(text)

"""YAML config loading with ``BASE`` inheritance (counterpart of
``empanada_tpu/api/config.py``): a config may name a parent file, relative
to its own directory, under ``BASE``; parents load recursively and each
child is merged over its parent, dicts recursively."""

from __future__ import annotations

import os

import yaml

__all__ = ["read_yaml", "load_config", "merge_dicts"]


def read_yaml(path: str) -> dict:
    with open(path) as handle:
        return yaml.load(handle, Loader=yaml.FullLoader)


def merge_dicts(dict1: dict, dict2: dict) -> dict:
    """Merge ``dict2`` into ``dict1`` in place, recursively; ``dict2`` wins."""
    for k, v in dict2.items():
        if isinstance(v, dict) and isinstance(dict1.get(k), dict):
            merge_dicts(dict1[k], v)
        else:
            dict1[k] = v
    return dict1


def load_config(config_file: str, base_kw: str = "BASE") -> dict:
    """The config at ``config_file`` with its chain of ``BASE`` parents
    applied, children over parents; a cycle raises."""
    config = read_yaml(config_file)
    chain = [config]
    seen = {os.path.abspath(config_file)}
    while base_kw in config:
        base_path = os.path.abspath(os.path.join(
            os.path.dirname(os.path.abspath(config_file)), config[base_kw]))
        if base_path in seen:
            raise ValueError(f"BASE inheritance cycle: {base_path!r} reached twice "
                             f"(chain of {len(chain)} configs)")
        seen.add(base_path)
        config = read_yaml(base_path)
        chain.append(config)
        config_file = base_path
    inherited = chain[-1]
    for child in reversed(chain[:-1]):
        inherited = merge_dicts(inherited, child)
    inherited.pop(base_kw, None)
    return inherited

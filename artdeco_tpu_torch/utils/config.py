"""YAML config loader with recursive ``inherit`` merge.

Port (a copy) of ``artdeco_tpu/utils/config.py``, including the
SafeLoader float resolver that makes ``1e-6``-style scalars floats.
"""

from __future__ import annotations

import re

import yaml

_FLOAT_RESOLVER = re.compile(
    """^(?:
        [-+]?(?:[0-9][0-9_]*)\\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\\.[0-9_]*
        |[-+]?\\.(?:inf|Inf|INF)
        |\\.(?:nan|NaN|NAN))$""",
    re.X,
)


class _Loader(yaml.SafeLoader):
    pass


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float", _FLOAT_RESOLVER, list("-+0123456789.")
)


def merge_config(dict1: dict, dict2: dict) -> dict:
    """Deep-merge dict2 into dict1 (dict2 wins on leaves)."""
    for k, v in dict2.items():
        if isinstance(v, dict):
            if not isinstance(dict1.get(k), dict):
                dict1[k] = {}
            merge_config(dict1[k], v)
        else:
            dict1[k] = v
    return dict1


def load_config(path: str = "config/base.yaml") -> dict:
    with open(path, "r", encoding="utf-8") as f:
        cfg = yaml.load(f, Loader=_Loader)
    inherit = cfg.get("inherit")
    parent = load_config(inherit) if inherit is not None else {}
    return merge_config(parent, cfg)

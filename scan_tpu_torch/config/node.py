"""A minimal yacs-compatible configuration node (a copy of
``scan_tpu/config/node.py``, kept here so the port imports nothing of it).

The reference framework configures everything through a yacs ``CfgNode``
singleton (see reference ``fcos_core/config/defaults.py:21``).  We reimplement
the small subset of yacs semantics the reference relies on so that the
reference's YAML files under ``configs/`` load unchanged:

* attribute access (``cfg.MODEL.FCOS.NUM_CLASSES``)
* ``merge_from_file`` / ``merge_from_list`` / ``merge_from_other_cfg``
* string values that look like Python literals (``"('NODES', 'ADJ')"``) are
  decoded with ``ast.literal_eval`` (yacs ``_decode_cfg_value`` behaviour)
* permissive type coercion between tuple/list and int/float
* ``freeze`` / ``defrost`` / ``clone`` / ``dump``
"""

from __future__ import annotations

import ast
import copy
from typing import Any

import yaml

_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))


class ConfigNode(dict):
    """Dict subclass with attribute access and yacs merge semantics."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, ConfigNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = ConfigNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, ConfigNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name} to {value}, but ConfigNode is immutable"
            )
        self[name] = value

    def __setitem__(self, name, value):
        if object.__getattribute__(self, ConfigNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name}, but ConfigNode is immutable"
            )
        dict.__setitem__(self, name, value)

    # -- freezing ----------------------------------------------------------
    def freeze(self):
        self._set_immutable(True)

    def defrost(self):
        self._set_immutable(False)

    def is_frozen(self):
        return object.__getattribute__(self, ConfigNode.IMMUTABLE)

    def _set_immutable(self, flag: bool):
        object.__setattr__(self, ConfigNode.IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v._set_immutable(flag)

    # -- clone / dump --------------------------------------------------------
    def clone(self) -> "ConfigNode":
        frozen = self.is_frozen()
        self._set_immutable(False)
        out = copy.deepcopy(self)
        self._set_immutable(frozen)
        out._set_immutable(False)
        return out

    def dump(self) -> str:
        def convert(node):
            if isinstance(node, ConfigNode):
                return {k: convert(v) for k, v in node.items()}
            if isinstance(node, tuple):
                return list(node)
            return node

        return yaml.safe_dump(convert(self))

    # -- merging -----------------------------------------------------------
    def merge_from_file(self, filename: str):
        with open(filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self._merge_dict(loaded, [])

    def merge_from_other_cfg(self, other: "ConfigNode"):
        self._merge_dict(other, [])

    def merge_from_list(self, opts):
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for full_key, v in zip(opts[0::2], opts[1::2]):
            keys = full_key.split(".")
            node = self
            for sub in keys[:-1]:
                assert sub in node, f"Non-existent key: {full_key}"
                node = node[sub]
            leaf = keys[-1]
            assert leaf in node, f"Non-existent key: {full_key}"
            value = _decode_value(v)
            dict.__setitem__(
                node, leaf, _coerce(value, node[leaf], full_key)
            )

    def _merge_dict(self, src: dict, key_path):
        for k, v in src.items():
            full_key = ".".join(key_path + [k])
            if k not in self:
                raise KeyError(f"Non-existent config key: {full_key}")
            current = self[k]
            if isinstance(current, ConfigNode):
                if not isinstance(v, dict):
                    raise ValueError(
                        f"Cannot merge non-dict into config section {full_key}"
                    )
                current._merge_dict(v, key_path + [k])
            else:
                value = _decode_value(v)
                dict.__setitem__(self, k, _coerce(value, current, full_key))

    def __repr__(self):
        return f"ConfigNode({dict.__repr__(self)})"

    def __str__(self):
        lines = []
        for k in sorted(self.keys()):
            v = self[k]
            if isinstance(v, ConfigNode):
                body = str(v)
                body = "\n".join("  " + line for line in body.split("\n"))
                lines.append(f"{k}:\n{body}")
            else:
                lines.append(f"{k}: {v}")
        return "\n".join(lines)

    def __reduce__(self):
        # deepcopy/pickle support: rebuild from a plain dict
        return (ConfigNode, ({k: v for k, v in self.items()},))


def _decode_value(value: Any) -> Any:
    """yacs-style decoding: strings that parse as Python literals become them."""
    if isinstance(value, dict):
        return ConfigNode(value)
    if not isinstance(value, str):
        return value
    try:
        value = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    return value


def _coerce(replacement: Any, original: Any, full_key: str) -> Any:
    """Permissively cast the replacement to the original's type (yacs rules)."""
    original_type = type(original)
    replacement_type = type(replacement)
    if replacement_type == original_type or original is None or replacement is None:
        return replacement

    casts = [(tuple, list), (list, tuple), (int, float), (float, int), (bool, int)]
    for from_type, to_type in casts:
        if replacement_type == from_type and original_type == to_type:
            return to_type(replacement)

    raise ValueError(
        f"Type mismatch ({original_type} vs {replacement_type}) for key {full_key}: "
        f"{original} vs {replacement}"
    )

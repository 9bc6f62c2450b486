"""Hydra-style config: YAML groups + dotted CLI overrides, without PyYAML
(port of gigapose_tpu/utils/config.py).

`load_config(name, overrides, groups)` reads `configs/<name>.yaml` of this
package, resolves its `defaults` list of group files (`groups` picks
another file of a group: the CLI's `model=small`), deep-merges them, then
applies `key.path=value` overrides. The JAX test.py merges the selected
model file over the overrides, which drops `model.*` overrides given beside
`model=...`; here the overrides come last, as in Hydra. The port keeps its
own copies of the JAX package's config files (`configs/test.yaml`,
`model/{large,small}.yaml`, `data/bop.yaml`, `machine/local.yaml`).

`load_yaml` reads the subset of YAML those files use: block mappings nested
by indentation, block sequences (the `defaults` list, whose items are
scalars or one-key mappings), scalars and comments. Flow collections,
anchors, tags and multi-line scalars raise ValueError. `parse_scalar`
resolves a scalar as PyYAML's safe loader does (YAML 1.1): null, booleans
(including yes / no / on / off), ints (decimal, 0x, 0b, leading-0 octal,
base 60, `_` separators), floats (a dot is required, and an exponent needs
its sign: `1.0e-5` is a float, `1e-5` a string), .inf / .nan, and plain or
quoted strings. Dates stay strings.
"""

from __future__ import annotations

import copy
import json
import math
import os.path as osp
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

CONFIG_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "configs")

# PyYAML's implicit resolvers (resolver.py), in the order it tries them
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TRUE = ("yes", "true", "on")


class Config(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, k, v):
        self[k] = v


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_dotted(cfg: Dict, dotted: str, value: Any):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _sexagesimal(body: str) -> float:
    value = 0.0
    for part in body.split(":"):
        value = value * 60 + float(part)
    return value


def parse_scalar(text: str) -> Any:
    """One YAML scalar (an override's value or a value in a config file),
    resolved as yaml.safe_load resolves it."""
    s = _strip_comment(text).strip()
    if s[:1] == "'":
        if len(s) < 2 or s[-1] != "'":
            raise ValueError(f"unterminated quoted scalar: {text!r}")
        return s[1:-1].replace("''", "'")
    if s[:1] == '"':
        try:
            return json.loads(s)
        except json.JSONDecodeError as e:
            raise ValueError(f"unsupported double-quoted scalar: {text!r}") from e
    if s[:1] in ("[", "{", "&", "*", "!", "|", ">", "@", "`") or s.startswith("- ") \
            or re.search(r":(\s|$)", s):
        raise ValueError(f"not a plain YAML scalar (unsupported here): {text!r}")
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in _TRUE
    if _FLOAT.match(s):
        body = s.replace("_", "").lower()
        sign = -1.0 if body[:1] == "-" else 1.0
        body = body.lstrip("+-")
        if body == ".inf":
            return sign * math.inf
        if body == ".nan":
            return math.nan
        return sign * (_sexagesimal(body) if ":" in body else float(body))
    if _INT.match(s):
        body = s.replace("_", "")
        sign = -1 if body[:1] == "-" else 1
        body = body.lstrip("+-")
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if ":" in body:
            return sign * int(_sexagesimal(body))
        if len(body) > 1 and body[0] == "0":
            return sign * int(body, 8)
        return sign * int(body)
    return s


def _strip_comment(text: str) -> str:
    """Drop a `#` comment: at the start, or after whitespace outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"') and (i == 0 or text[i - 1] in " \t:-"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _lines(text: str) -> List[Tuple[int, str]]:
    """(indent, content) of every line that holds more than a comment."""
    out = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"tab in indentation: {raw!r}")
        content = _strip_comment(raw).rstrip()
        if content.strip():
            out.append((len(content) - len(content.lstrip(" ")), content.strip()))
    return out


def _split_key(content: str) -> Tuple[str, str]:
    m = re.match(r"^([^\s'\"#:][^:#]*?|'[^']*'|\"[^\"]*\")\s*:(?:\s+(.*)|$)", content)
    if not m:
        raise ValueError(f"expected `key: value`: {content!r}")
    key = m.group(1)
    if key[:1] in ("'", '"'):
        key = parse_scalar(key)
    return key, (m.group(2) or "")


def _parse_block(lines, i: int, indent: int):
    """The block node starting at lines[i] with this indentation -> (node,
    index of the first line after it)."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        items = []
        while i < len(lines) and lines[i][0] == indent and lines[i][1][:1] == "-":
            rest = lines[i][1][1:].strip()
            if not rest:
                raise ValueError(f"empty or nested sequence item: {lines[i][1]!r}")
            if re.match(r"^[^'\"]*?:(\s|$)", rest):  # one-key mapping item
                key, value = _split_key(rest)
                if not value:
                    raise ValueError(f"nested mapping in a sequence item: {rest!r}")
                items.append({key: parse_scalar(value)})
            else:
                items.append(parse_scalar(rest))
            i += 1
        return items, i
    node: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        key, value = _split_key(lines[i][1])
        if key in node:
            raise ValueError(f"duplicate key {key!r}")
        i += 1
        if value:
            node[key] = parse_scalar(value)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1][:1] == "-")):
            node[key], i = _parse_block(lines, i, lines[i][0])
        else:
            node[key] = None
    return node, i


def load_yaml(path: str) -> Any:
    """A config file of the supported subset -> dict (None when empty)."""
    with open(path) as f:
        lines = _lines(f.read())
    if not lines:
        return None
    node, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"{path}: bad indentation at {lines[i][1]!r}")
    return node


def load_config(
    name: str,
    overrides: Optional[Sequence[str]] = None,
    config_dir: str = CONFIG_DIR,
    groups: Optional[Dict[str, str]] = None,
) -> Config:
    """Load configs/<name>.yaml, resolve its `defaults` group list (with
    `groups`, e.g. {"model": "small"}, choosing another file of a group, as
    Hydra's `model=small` does), apply `key=value` overrides last."""
    groups = dict(groups or {})
    root = load_yaml(osp.join(config_dir, f"{name}.yaml")) or {}
    cfg: Dict = {}
    for entry in root.pop("defaults", []):
        # entry like "model/large" (merged at the top) or {"model": "large"}
        if isinstance(entry, dict):
            ((group, fname),) = entry.items()
            fname = groups.pop(group, fname)
            sub = load_yaml(osp.join(config_dir, group, f"{fname}.yaml")) or {}
            cfg = _deep_merge(cfg, {group: sub})
        else:
            cfg = _deep_merge(cfg, load_yaml(osp.join(config_dir, f"{entry}.yaml")) or {})
    if groups:
        raise ValueError(f"{name}.yaml has no defaults entry for the groups {sorted(groups)}")
    cfg = _deep_merge(cfg, root)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value: {ov}")
        k, v = ov.split("=", 1)
        _set_dotted(cfg, k, parse_scalar(v))
    return Config(cfg)

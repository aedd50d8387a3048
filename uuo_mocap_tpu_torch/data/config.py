"""YAML configs with single-parent inheritance (counterpart of
``uuo_mocap_tpu/data/config.py``).

A config may name a ``parent:`` file whose keys it deep-merges over.  The
files are read with a small parser for the subset of YAML that
``configs/*.yaml`` use — nested block mappings, plain and quoted scalars,
inline ``[a, b]`` lists and ``#`` comments — resolving scalars as PyYAML's
``safe_load`` does, so the port needs no PyYAML.  Other syntax raises.
"""
from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Tuple

_INT = re.compile(r"^[-+]?[0-9]+$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)(?:[eE][-+][0-9]+)?$")
_BOOL = {"true": True, "false": False, "yes": True, "no": False, "on": True, "off": False}
_NULL = {"", "~", "null"}


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str) -> Any:
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        return [_scalar(v) for v in inner.split(",")] if inner else []
    low = t.lower()
    if low in _NULL:
        return None
    if low in _BOOL and t in (low, low.capitalize(), low.upper()):
        return _BOOL[low]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    if low in (".inf", "+.inf"):
        return float("inf")
    if low == "-.inf":
        return float("-inf")
    if low == ".nan":
        return float("nan")
    return t


def parse_yaml(text: str) -> Dict[str, Any]:
    """Parse the block-mapping subset of YAML used by the config files."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        body = _strip_comment(raw).rstrip()
        if body.strip():
            if "\t" in body[: len(body) - len(body.lstrip())]:
                raise ValueError(f"tab indentation is not supported: {raw!r}")
            lines.append((len(body) - len(body.lstrip(" ")), body.strip()))

    def block(i: int, indent: int) -> Tuple[Dict[str, Any], int]:
        out: Dict[str, Any] = {}
        while i < len(lines) and lines[i][0] == indent:
            content = lines[i][1]
            if content.startswith("- ") or content == "-" or ":" not in content:
                raise ValueError(f"unsupported YAML line: {content!r}")
            key, _, rest = content.partition(":")
            key = _scalar(key)
            i += 1
            if rest.strip():
                out[key] = _scalar(rest)
            elif i < len(lines) and lines[i][0] > indent:
                out[key], i = block(i, lines[i][0])
            else:
                out[key] = None
        if i < len(lines) and lines[i][0] > indent:
            raise ValueError(f"bad indentation at {lines[i][1]!r}")
        return out, i

    if not lines:
        return {}
    out, i = block(0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"bad indentation at {lines[i][1]!r}")
    return out


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def load_config(filename: str, _depth: int = 0) -> Optional[Dict[str, Any]]:
    """Load a config, recursively merging its ``parent`` chain.  A relative
    parent path resolves against the working directory, then the child's
    directory, then this repository's ``configs/``."""
    if _depth > 16:
        raise RecursionError(f"config parent chain too deep at {filename}")
    with open(filename, "r") as stream:
        output = parse_yaml(stream.read())

    parent = output.get("parent")
    if parent:
        candidates = [
            parent,
            os.path.join(os.path.dirname(os.path.abspath(filename)), os.path.basename(parent)),
            os.path.join(default_config_dir(), os.path.basename(parent)),
        ]
        parent_path = next((c for c in candidates if os.path.exists(c)), None)
        if parent_path is None:
            raise FileNotFoundError(f"parent config {parent!r} (from {filename}) not found")
        output = _deep_merge(load_config(parent_path, _depth + 1), output)
    return output


def default_config_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                        "configs")

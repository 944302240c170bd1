"""Tiny fire-like CLI (counterpart of ``pips_tpu/utils/cli.py``): map
``--key value`` / ``--key=value`` args onto a function's keyword parameters
with type coercion from defaults."""

from __future__ import annotations

import inspect
import sys
from typing import Callable, Optional, Sequence


def _coerce(value: str, default):
    if isinstance(default, bool):
        return value.lower() in ("1", "true", "yes", "y")
    if isinstance(default, int):
        return int(value)
    if isinstance(default, float):
        return float(value)
    if isinstance(default, (tuple, list)):
        parts = [p for p in value.strip("()[] ").split(",") if p]
        elem = default[0] if default else "0"
        return type(default)(type(elem)(p) for p in parts)
    return value


def auto_cli(fn: Callable, argv: Optional[Sequence[str]] = None):
    """Call ``fn`` with kwargs parsed from argv. Returns fn's result."""
    argv = list(sys.argv[1:] if argv is None else argv)
    sig = inspect.signature(fn)
    kwargs = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected argument: {arg}")
        key = arg[2:]
        if "=" in key:
            key, value = key.split("=", 1)
        elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            value = argv[i + 1]
            i += 1
        else:
            value = "true"
        key = key.replace("-", "_")
        if key not in sig.parameters:
            raise SystemExit(f"unknown option --{key}; valid: {list(sig.parameters)}")
        default = sig.parameters[key].default
        kwargs[key] = _coerce(value, default)
        i += 1
    return fn(**kwargs)

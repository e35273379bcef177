"""Shared env-knob parsing (a copy of the JAX package's ``telemetry/env.py``).

Malformed values fall back to the default — several of these run at
import time or per-processor construction,
and a typo'd manifest must not keep the service from starting (the
convention every env knob in this codebase follows).
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["env_int", "env_float", "env_int_tuple", "env_str", "env_flag"]


def env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """Raw string knob.  ``default=None`` preserves set-vs-unset
    distinctions (several knobs auto-tune only while unset)."""
    return os.environ.get(name, default)


_FLAG_OFF = ("0", "false", "no", "off")
_FLAG_ON = ("1", "true", "yes", "on")


def env_flag(name: str, default: bool) -> bool:
    """Boolean knob.  ``0/false/no/off`` disable, ``1/true/yes/on``
    enable, anything else (including unset) keeps the default — the
    fail-to-default convention, applied to booleans."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    raw = raw.strip().lower()
    if raw in _FLAG_OFF:
        return False
    if raw in _FLAG_ON:
        return True
    return default


def env_int_tuple(name: str, default: str) -> tuple:
    """Comma-separated int list knob (e.g. DEVICE_QUERY_BUCKETS).  ONE
    copy of the parse + default so every consumer (the device matcher's
    ladder, the ingest scheduler's jax-less fallback) stays in sync."""
    raw = os.environ.get(name) or default
    try:
        return tuple(int(b) for b in raw.split(","))
    except ValueError:
        return tuple(int(b) for b in default.split(","))


def env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default

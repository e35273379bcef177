"""The telemetry layer's env-knob parsers (the JAX package's
``telemetry/env.py``): the port keeps one copy of them, in the package's
``env.py``, and re-exports it here so the copied telemetry modules keep
their imports."""

from ..env import (  # noqa: F401
    env_flag,
    env_float,
    env_int,
    env_int_tuple,
    env_str,
)

__all__ = ["env_int", "env_float", "env_int_tuple", "env_str", "env_flag"]

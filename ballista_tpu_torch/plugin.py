"""UDF plugin registry: the name-resolution surface the front end needs.

The reference's plugin loader (``ballista_tpu/plugin.py``) runs UDF bodies
written against jax; loading plugins is not ported yet (ROADMAP queue 1,
item 10a), and ``load_plugins`` raises for a plugin directory. The SQL
parser and the logical expressions resolve function names against this
registry, which stays empty, so an unknown function raises exactly as it
does in the reference with no plugin directory.
"""

from __future__ import annotations

import os

from ballista_tpu_torch.errors import ConfigError, PlanError

PLUGIN_DIR_ENV = "BALLISTA_PLUGIN_DIR"


class UdfRegistry:
    """An empty registry with the reference's lookup surface."""

    def get(self, name: str):
        return None

    def get_udaf(self, name: str):
        return None


global_registry = UdfRegistry()


_NOT_PORTED = "UDF plugins are not ported yet (ROADMAP queue 1, item 10a)"


def lookup_udf(name: str):
    raise PlanError(f"unknown scalar function {name!r}; {_NOT_PORTED}")


def lookup_udaf(name: str):
    raise PlanError(f"unknown aggregate function {name!r}; {_NOT_PORTED}")


def load_plugins(plugin_dir: str | None = None) -> list[str]:
    """The reference's loader entry (an explicit dir and/or
    ``$BALLISTA_PLUGIN_DIR``): either one raises ``ConfigError``, since
    loading plugins is not ported; with neither it loads nothing."""
    for d in (plugin_dir, os.environ.get(PLUGIN_DIR_ENV)):
        if d:
            raise ConfigError(f"plugin dir {d!r}: {_NOT_PORTED}")
    return []

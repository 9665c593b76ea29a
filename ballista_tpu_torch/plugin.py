"""UDF plugin system (port of ``ballista_tpu/plugin.py``).

ref ballista/rust/core/src/plugin/{mod.rs:36-127, plugin_manager.rs, udf.rs}:
a global PluginManager scans a plugin directory (env
``BALLISTA_PLUGIN_DIR`` or the ``ballista.plugin_dir`` config key) and loads
every plugin it finds. The reference loads ``.so`` cdylibs exposing a
registrar symbol; this package loads ``.py`` modules exposing
``register(register_udf)`` or ``register(register_udf, register_udaf)``.

A port plugin imports ``torch`` and ``ballista_tpu_torch.datatypes``. Its
bodies take and return torch tensors on the batch's device: each argument
is a padded column of the batch's capacity, dead rows included, and a body
works elementwise and returns one tensor of that length on that device
(anything else raises ``ExecutionError`` naming the function). A plugin
file looks like::

    # my_udfs.py, dropped into the plugin dir
    import torch
    from ballista_tpu_torch.datatypes import DataType

    def register(register_udf):
        register_udf("clamp01", lambda x: torch.clamp(x, 0.0, 1.0),
                     DataType.FLOAT64)

The client or context, the scheduler (planning: name resolution and
return types) and every executor task (execution) load the same plugin
dir; the wire format carries only the function name (serde.py
ScalarFunctionNode), exactly like the reference's UDF serde. A module is
imported as ``ballista_torch_plugin_<stem>``, apart from the reference's
``ballista_plugin_<stem>``, so that one process can load both packages'
plugins of one name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import inspect
import logging
import os
import sys
import threading

from ballista_tpu_torch.datatypes import DataType
from ballista_tpu_torch.errors import PlanError

log = logging.getLogger(__name__)

PLUGIN_DIR_ENV = "BALLISTA_PLUGIN_DIR"  # ref plugin/mod.rs:36-44
MODULE_PREFIX = "ballista_torch_plugin_"


@dataclasses.dataclass(frozen=True)
class AggregateUdf:
    """One registered aggregate UDF (ref python/src/udaf.rs:28-90: the
    Accumulator's state/update/merge/evaluate contract, recast for a
    vectorized engine).

    A UDAF here is ALGEBRAIC: it declares state slots, each an engine
    reduce op (sum/count/min/max) over a torch per-row transform of the
    argument, plus a torch ``finalize`` over the merged slot values. That
    maps 1:1 onto the partial/merge/final split the distributed plan
    already runs for built-ins (partials fold per partition, states merge
    by the slot op, finalize runs once).

    ``states``: (suffix, op, has_transform) with op in {"sum", "count",
    "min", "max"}; a transform is registered as the hidden scalar UDF
    ``__udaf_<name>_<suffix>``. ``finalize(*slot_values) -> tensor``.
    """

    name: str
    states: tuple
    finalize: object
    return_type: object = DataType.FLOAT64


@dataclasses.dataclass(frozen=True)
class ScalarUdf:
    """One registered scalar UDF.

    ``fn`` maps torch value tensors -> a torch value tensor (nulls are
    propagated outside the fn as the union of argument nulls, SQL semantics
    for a null-strict function). ``return_type`` is a DataType, or "same" to
    inherit argument 0's type."""

    name: str
    fn: object
    return_type: object = "same"
    min_args: int = 1
    max_args: int = 1


class UdfRegistry:
    """Process-global UDF table (ref plugin_manager.rs global manager)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._udfs: dict[str, ScalarUdf] = {}
        self._udafs: dict[str, AggregateUdf] = {}
        # dir -> Event set once its plugins are fully registered; a second
        # loader of the same dir blocks until then (concurrent push-mode
        # task threads must not see a half-loaded registry)
        self._dir_loads: dict[str, threading.Event] = {}
        # bumped by every change of the table: a compiled expression
        # captures the UDF body it resolved, so the shared callable cache
        # keys on this (compilecache/tracecache.py)
        self._generation = 0

    def generation(self) -> int:
        """How many times the table changed; part of every shared
        callable's key."""
        with self._lock:
            return self._generation

    def register(
        self,
        name: str,
        fn,
        return_type=DataType.FLOAT64,
        min_args: int = 1,
        max_args: int | None = None,
    ) -> None:
        name = name.lower()
        with self._lock:
            self._udfs[name] = ScalarUdf(
                name, fn, return_type, min_args, max_args or min_args
            )
            self._generation += 1

    def register_udaf(
        self,
        name: str,
        states: list,
        finalize,
        return_type=DataType.FLOAT64,
    ) -> None:
        """Register an aggregate UDF (see AggregateUdf). Each state's
        transform is ALSO registered as a hidden scalar UDF so the
        decomposition can reference it as an ordinary pre-projection
        expression that serializes by name."""
        name = name.lower()
        norm = []
        for state in states:
            suffix, op, transform = state[:3]
            # transform output dtype: explicit 4th element, else FLOAT64
            # ("same" would silently truncate float-producing transforms
            # over integer columns: log, sqrt, reciprocals)
            rtype = state[3] if len(state) > 3 else DataType.FLOAT64
            if op not in ("sum", "count", "min", "max"):
                raise PlanError(
                    f"UDAF {name!r} state {suffix!r}: bad op {op!r}"
                )
            if transform is not None:
                self.register(f"__udaf_{name}_{suffix}", transform, rtype)
            norm.append((suffix, op, transform is not None))
        with self._lock:
            self._udafs[name] = AggregateUdf(
                name, tuple(norm), finalize, return_type
            )
            self._generation += 1

    def get(self, name: str) -> ScalarUdf | None:
        with self._lock:
            return self._udfs.get(name.lower())

    def get_udaf(self, name: str) -> AggregateUdf | None:
        with self._lock:
            return self._udafs.get(name.lower())

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._udfs)

    def udaf_names(self) -> list[str]:
        with self._lock:
            return sorted(self._udafs)

    def clear(self) -> None:
        with self._lock:
            self._udfs.clear()
            self._udafs.clear()
            self._dir_loads.clear()
            self._generation += 1

    def load_dir(self, plugin_dir: str) -> list[str]:
        """Import every ``*.py`` in ``plugin_dir`` and call its
        ``register`` hook (ref mod.rs load loop :87-127). Idempotent per
        directory; concurrent callers block until the first load completes.
        Returns the module names loaded."""
        plugin_dir = os.path.abspath(plugin_dir)
        with self._lock:
            done = self._dir_loads.get(plugin_dir)
            if done is not None:
                first = False
            else:
                done = threading.Event()
                self._dir_loads[plugin_dir] = done
                first = True
        if not first:
            done.wait()
            return []
        retry = False
        try:
            loaded = []
            if not os.path.isdir(plugin_dir):
                # do NOT cache the miss: the dir may appear later (a volume
                # mount racing pod start), and per-task load_plugins exists
                # precisely to re-resolve then
                log.warning("plugin dir %s does not exist", plugin_dir)
                retry = True
                return loaded
            for fname in sorted(os.listdir(plugin_dir)):
                if not fname.endswith(".py") or fname.startswith("_"):
                    continue
                mod_name = f"{MODULE_PREFIX}{fname[:-3]}"
                path = os.path.join(plugin_dir, fname)
                try:
                    spec = importlib.util.spec_from_file_location(mod_name, path)
                    module = importlib.util.module_from_spec(spec)
                    sys.modules[mod_name] = module
                    spec.loader.exec_module(module)
                    hook = getattr(module, "register", None)
                    if hook is None:
                        log.warning("plugin %s has no register() hook", path)
                        continue
                    if len(inspect.signature(hook).parameters) >= 2:
                        # register(register_udf, register_udaf)
                        hook(self.register, self.register_udaf)
                    else:
                        hook(self.register)
                    loaded.append(mod_name)
                except Exception:  # noqa: BLE001 (one bad plugin can't
                    # kill boot, but its failure must not be cached as
                    # success: the next load_dir retries the whole dir;
                    # register() overwrites, so a re-import is safe)
                    log.exception("failed to load plugin %s", path)
                    retry = True
            if loaded:
                log.info("loaded %d UDF plugins from %s", len(loaded), plugin_dir)
            return loaded
        finally:
            if retry:
                with self._lock:
                    self._dir_loads.pop(plugin_dir, None)
            done.set()


# The process-global registry. Planning (expr/logical.py) and execution
# (expr/physical.py) resolve unknown function names against it.
global_registry = UdfRegistry()


def load_plugins(plugin_dir: str | None = None) -> list[str]:
    """Load plugins from an explicit dir and/or $BALLISTA_PLUGIN_DIR."""
    loaded: list[str] = []
    for d in (plugin_dir, os.environ.get(PLUGIN_DIR_ENV)):
        if d:
            loaded += global_registry.load_dir(d)
    return loaded


def lookup_udf(name: str) -> ScalarUdf:
    udf = global_registry.get(name)
    if udf is None:
        raise PlanError(f"unknown scalar function {name!r}")
    return udf


def lookup_udaf(name: str) -> AggregateUdf:
    udaf = global_registry.get_udaf(name)
    if udaf is None:
        raise PlanError(f"unknown aggregate function {name!r}")
    return udaf

"""Session configuration: the keys the port reads, with the reference's
names and defaults (``ballista_tpu/config.py``).

An unknown key or an unparsable value raises :class:`ConfigError`, the same
contract as the reference's ``BallistaConfig``. Keys the reference has and
the port does not read yet are unknown here rather than silently ignored.
"""

from __future__ import annotations

from ballista_tpu_torch.errors import ConfigError

BALLISTA_DEFAULT_SHUFFLE_PARTITIONS = "ballista.shuffle.partitions"
BALLISTA_AGG_CAPACITY = "ballista.tpu.agg_capacity"
BALLISTA_TPU_BATCH_ROWS = "ballista.tpu.batch_rows"
BALLISTA_JOIN_EXPANSION = "ballista.tpu.join_expansion"
BALLISTA_REPARTITION_JOINS = "ballista.repartition.joins"
BALLISTA_REPARTITION_AGGREGATIONS = "ballista.repartition.aggregations"
BALLISTA_HBM_BUDGET_MB = "ballista.tpu.hbm_budget_mb"  # grace-hash trigger
BALLISTA_SPILL_BUDGET_MB = "ballista.tpu.spill_budget_mb"  # host spill ceiling
BALLISTA_SPILL_DIR = "ballista.tpu.spill_dir"  # grace-hash spill location


def _parse_bool(s: str) -> bool:
    if s.lower() in ("true", "1", "yes"):
        return True
    if s.lower() in ("false", "0", "no"):
        return False
    raise ValueError(f"not a boolean: {s!r}")


# key -> (default, parser)
_ENTRIES: dict[str, tuple[str, object]] = {
    BALLISTA_DEFAULT_SHUFFLE_PARTITIONS: ("2", int),
    BALLISTA_AGG_CAPACITY: (str(1 << 16), int),
    BALLISTA_TPU_BATCH_ROWS: (str(1 << 21), int),
    # output rows per probe row that a join's m:n expansion allocates
    # before it overflows and the run is retried with more
    BALLISTA_JOIN_EXPANSION: ("4", int),
    # hash-exchange the inputs of joins and aggregations in a distributed
    # plan (PhysicalPlanner(distributed=True))
    BALLISTA_REPARTITION_JOINS: ("true", _parse_bool),
    BALLISTA_REPARTITION_AGGREGATIONS: ("true", _parse_bool),
    # device bytes (MB) a join build side or a final aggregate's states may
    # hold before they go grace-hash through host Arrow IPC buckets; 0 = off
    BALLISTA_HBM_BUDGET_MB: ("0", int),
    # host bytes (MB) of spill files a task attempt may write; 0 = no limit
    BALLISTA_SPILL_BUDGET_MB: (str(1 << 16), int),
    # where spill files go; empty = the system temp directory
    BALLISTA_SPILL_DIR: ("", str),
}


class BallistaConfig:
    """Validated string-keyed settings with typed getters."""

    def __init__(self, settings: dict[str, str] | None = None):
        self._settings: dict[str, str] = {}
        for k, v in (settings or {}).items():
            self._validate(k, v)
            self._settings[k] = v

    @staticmethod
    def _validate(key: str, value: str) -> None:
        entry = _ENTRIES.get(key)
        if entry is None:
            raise ConfigError(f"unknown configuration key: {key!r}")
        try:
            entry[1](value)
        except Exception as e:
            raise ConfigError(
                f"invalid value {value!r} for {key!r}: {e}"
            ) from e

    def settings(self) -> dict[str, str]:
        return dict(self._settings)

    def _get(self, key: str):
        default, parse = _ENTRIES[key]
        return parse(self._settings.get(key, default))

    def default_shuffle_partitions(self) -> int:
        return self._get(BALLISTA_DEFAULT_SHUFFLE_PARTITIONS)

    def tpu_batch_rows(self) -> int:
        return self._get(BALLISTA_TPU_BATCH_ROWS)

    def agg_capacity(self) -> int:
        return self._get(BALLISTA_AGG_CAPACITY)

    def join_expansion(self) -> int:
        return self._get(BALLISTA_JOIN_EXPANSION)

    def repartition_joins(self) -> bool:
        return self._get(BALLISTA_REPARTITION_JOINS)

    def repartition_aggregations(self) -> bool:
        return self._get(BALLISTA_REPARTITION_AGGREGATIONS)

    def hbm_budget_mb(self) -> int:
        return self._get(BALLISTA_HBM_BUDGET_MB)

    def spill_budget_mb(self) -> int:
        return self._get(BALLISTA_SPILL_BUDGET_MB)

    def spill_dir(self) -> str:
        return self._get(BALLISTA_SPILL_DIR)

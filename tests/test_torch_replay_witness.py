"""The port's replay witness (``ballista_tpu_torch/analysis/replay.py``,
``BALLISTA_REPLAY_WITNESS``), the cases of ``tests/test_replay_witness.py``.

Unit tier: the port's ``canonical_hash`` and ``hash_file`` give the
reference's digests bit for bit on the same tables and files, and are
invariant under row order, chunking and IPC compression while catching any
value-level change; the record/mismatch ledger, held against the
reference's on the same records, behaves like the other witnesses
(zero traffic cannot pass for success). Property tier: a two-executor query
on the port's standalone cluster records one key set with identical
hashes under ``shuffle_fetch_concurrency`` 1 and 4, eager and barriered
shuffle, and no and zstd compression, and that key set is the one the
reference's cluster records for the same script."""

import json
import pathlib
import subprocess
import sys

import pyarrow as pa
import pyarrow.ipc as paipc
import pytest

from ballista_tpu.analysis import replay as ref_replay
from ballista_tpu_torch.analysis import replay

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_witness():
    for w in (replay, ref_replay):
        w.reset()
    yield
    for w in (replay, ref_replay):
        w.reset()
        w.enable(False)


def _table(rows=None):
    rows = rows or [(1, 1.5, "a"), (2, 2.5, "b"), (3, 3.5, "c")]
    k, v, s = zip(*rows)
    return pa.table({"k": list(k), "v": list(v), "s": list(s)})


def _digest(t) -> str:
    """The port's canonical hash of ``t``, held equal to the reference's."""
    h = replay.canonical_hash(t)
    assert h == ref_replay.canonical_hash(t)
    return h


def test_canonical_hash_order_and_chunking_invariant():
    t = _table()
    perm = _table([(3, 3.5, "c"), (1, 1.5, "a"), (2, 2.5, "b")])
    chunked = pa.concat_tables([t.slice(0, 1), t.slice(1)])
    assert _digest(t) == _digest(perm) == _digest(chunked)


def test_canonical_hash_catches_value_changes():
    t = _table()
    h = _digest(t)
    assert h != _digest(_table([(1, 1.5, "a")]))  # lost rows
    assert h != _digest(  # duplicated row
        _table([(1, 1.5, "a"), (1, 1.5, "a"), (2, 2.5, "b"), (3, 3.5, "c")])
    )
    ulp = _table([(1, 1.5, "a"), (2, 2.5 + 1e-13, "b"), (3, 3.5, "c")])
    assert h != _digest(ulp)  # last-ULP float drift
    assert h != _digest(t.rename_columns(["k", "w", "s"]))  # schema drift
    nulls = pa.table({"k": [1, None, 3], "v": [1.5, 2.5, None], "s": ["a", None, "c"]})
    assert h != _digest(nulls)


def test_hash_file_codec_invariant(tmp_path):
    t = _table()
    digests = set()
    for codec in (None, "lz4", "zstd"):
        p = tmp_path / f"f-{codec}.arrow"
        opts = paipc.IpcWriteOptions(compression=codec) if codec else None
        with paipc.new_file(str(p), t.schema, options=opts) if opts else paipc.new_file(str(p), t.schema) as w:
            w.write_table(t)
        got = replay.hash_file(str(p))
        assert got == ref_replay.hash_file(str(p))
        digests.add(got)
    assert digests == {_digest(t)}
    # a never-created file (zero-row partition) hashes as the stable empty
    # marker, not an error
    absent = str(tmp_path / "absent.arrow")
    assert replay.hash_file(absent) == ref_replay.hash_file(absent) == "empty"


def test_record_mismatch_and_ledger():
    def scenario(w):
        w.enable()
        w.record("shuffle", ("j", 2, 0, 1), "aaa")
        w.record("shuffle", ("j", 2, 0, 1), "aaa")  # retry, equal
        first = (list(w.mismatches()), w.rehash_count())
        w.record("shuffle", ("j", 2, 0, 1), "bbb")  # divergent recompute
        with pytest.raises(AssertionError, match="mismatch") as e:
            w.assert_clean()
        return first, w.mismatches(), w.record_counts(), w.summary(), str(e.value)

    got = scenario(replay)
    assert got == scenario(ref_replay)
    (clean, rehashes), mismatches, _, summary, _ = got
    assert clean == [] and rehashes == 1
    assert len(mismatches) == 1
    assert "MISMATCH" in summary


def test_zero_records_is_not_clean():
    for w in (replay, ref_replay):
        w.enable()
        with pytest.raises(AssertionError, match="recorded nothing"):
            w.assert_clean()
        w.assert_clean(require_records=False)


def test_forget_stage_scopes_to_one_stage():
    def scenario(w):
        w.enable()
        w.record("shuffle", ("j", 2, 0, 0), "aaa")
        w.record("shuffle", ("j", 3, 0, 0), "ccc")
        w.record("result", ("j", 7, 0), "rrr")
        w.forget_stage("j", 2)
        w.record("shuffle", ("j", 2, 0, 0), "bbb")  # re-bucketed: fine
        w.record("shuffle", ("j", 3, 0, 0), "ccc")
        return w.mismatches(), w.snapshot(strip_job=True)

    mismatches, snap = scenario(replay)
    assert (mismatches, snap) == scenario(ref_replay)
    assert mismatches == []
    assert ("result", 7, 0) in snap


# The property script, for either package: ``PKG`` is ``ballista_tpu`` or
# ``ballista_tpu_torch``; ``CONFIGS`` the settings to run under. It prints
# the witness key set of the first configuration.
PROPERTY_SCRIPT = r"""
import importlib
import json
import os

import numpy as np
import pyarrow as pa

PKG = os.environ["REPLAY_PROPERTY_PKG"]
CONFIGS = json.loads(os.environ["REPLAY_PROPERTY_CONFIGS"])
replay = importlib.import_module(PKG + ".analysis.replay")
BallistaContext = importlib.import_module(PKG + ".client.context").BallistaContext
BallistaConfig = importlib.import_module(PKG + ".config").BallistaConfig
kw = {"device": "cpu"} if PKG == "ballista_tpu_torch" else {}

n = 4000
r = np.random.default_rng(7)
fact = pa.table({
    "k": pa.array((np.arange(n) % 97).astype(np.int64)),
    "v": pa.array(r.uniform(0, 100, n)),
})
dim = pa.table({
    "k": pa.array(np.arange(97).astype(np.int64)),
    "name": pa.array([f"g{i%5}" for i in range(97)]),
})
SQL = (
    "select name, count(*) as n, sum(v) as sv "
    "from fact join dim on fact.k = dim.k "
    "group by name order by name"
)

replay.enable()
snapshots = []
for settings in CONFIGS:
    cfg = BallistaConfig({"ballista.shuffle.partitions": "2", **settings})
    ctx = BallistaContext.standalone(cfg, n_executors=2, **kw)
    ctx.register_table("fact", fact)
    ctx.register_table("dim", dim)
    out = ctx.sql(SQL).collect()
    assert out.num_rows == 5, out
    replay.assert_clean()  # within-run: no divergent re-records
    counts = replay.record_counts()
    assert counts.get("shuffle", 0) > 0 and counts.get("result", 0) > 0, counts
    snapshots.append((settings, replay.snapshot(strip_job=True)))
    replay.reset()
    ctx.close()

base_settings, base = snapshots[0]
for settings, snap in snapshots[1:]:
    assert set(snap) == set(base), (
        f"{settings}: key sets differ: {sorted(set(snap) ^ set(base))[:6]}"
    )
    diff = [k for k in base if snap[k] != base[k]]
    assert not diff, f"{settings}: hashes differ at {diff[:6]}"
print("REPLAY-PROPERTY-OK", len(base), "keys x", len(snapshots), "configs")
print("KEYS " + json.dumps(sorted(repr(k) for k in base)))
"""

CONFIGS = [
    {"ballista.tpu.shuffle_fetch_concurrency": "1"},
    {"ballista.tpu.shuffle_fetch_concurrency": "4"},
    {"ballista.tpu.eager_shuffle": "false"},
    {"ballista.tpu.eager_shuffle": "true"},
    {"ballista.tpu.shuffle_compression": "none"},
    {"ballista.tpu.shuffle_compression": "zstd"},
]


def _start(pkg: str, configs: list, env: dict) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", PROPERTY_SCRIPT],
        env={**env, "REPLAY_PROPERTY_PKG": pkg, "REPLAY_PROPERTY_CONFIGS": json.dumps(configs)},
        cwd=str(ROOT),
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )


def _keys(proc: subprocess.Popen, timeout: float) -> list:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-4000:]}"
    assert "REPLAY-PROPERTY-OK" in out, out
    (line,) = [ln for ln in out.splitlines() if ln.startswith("KEYS ")]
    return json.loads(line[len("KEYS "):])


def test_hashes_invariant_across_concurrency_eager_and_codecs(cpu_mesh_env):
    """The port's cluster under the six configurations: one witness key
    set, identical hashes everywhere; the key set is the reference's
    (whose own test holds its six configurations to one key set, so one
    configuration of it runs here, beside the port's six)."""
    env = {k: v for k, v in cpu_mesh_env.items() if k != "XLA_FLAGS"}
    port = _start("ballista_tpu_torch", CONFIGS, env)
    ref = _start("ballista_tpu", CONFIGS[:1], env)
    keys = _keys(port, timeout=240)
    assert keys and keys == _keys(ref, timeout=240)
    assert any(k.startswith("('shuffle'") for k in keys) and any(k.startswith("('result'") for k in keys)

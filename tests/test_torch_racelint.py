"""racelint of the port (``ballista_tpu_torch/analysis/racelint.py``), the
cases of ``tests/test_racelint.py``: the port's concurrent control plane
and its kernel builder and wrappers lint clean within the suppression
budget, every fixture gives the reference lint's findings, the lock-order
graph is acyclic and exported, the canonical state-machine tables govern
the runtime validator, and the port's combined gate aggregates its
analyzers into one exit code. Below them, the fixes of the lint's
findings: the partition-hash launcher set once under a lock, and a kernel
build that holds no lock while nvcc runs."""

import pathlib
import re
import sys
import textwrap
import threading
import time

import pytest

from ballista_tpu.analysis import racelint as ref_racelint
from ballista_tpu_torch.analysis import racelint as port_racelint
from ballista_tpu_torch.analysis import witness
from ballista_tpu_torch.analysis.statemachine import (
    JOB_TRANSITIONS,
    STAGE_TRANSITIONS,
    TASK_TRANSITIONS,
    render_tables,
)

_PKG = re.compile(r"\bballista_tpu\b(?!\.proto)")
_PORT_PKG = re.compile(r"\bballista_tpu_torch\b")


def _port(text: str) -> str:
    return _PKG.sub("ballista_tpu_torch", text)


def _ref(text: str) -> str:
    return _PORT_PKG.sub("ballista_tpu", text)


class _HeldAgainstReference:
    """The port's analyzer module. Its ``lint_source`` also runs each
    fixture through the reference's analyzer (under the reference's file
    name) and asserts the same (file, line, rule), with messages equal up
    to the package name."""

    def __init__(self, port, ref):
        self._port, self._ref = port, ref

    def __getattr__(self, name):
        return getattr(self._port, name)

    def lint_source(self, source, *args):
        got = self._port.lint_source(source, *args)
        want = self._ref.lint_source(source, *(_ref(a) for a in args))
        assert [(d.file, d.line, d.rule) for d in got] == [
            (_port(d.file), d.line, d.rule) for d in want
        ]
        assert [d.message for d in got] == [_port(d.message) for d in want]
        return got


racelint = _HeldAgainstReference(port_racelint, ref_racelint)

_HEADER = "import threading\nimport time\n"


def _lint(body: str):
    return racelint.lint_source(_HEADER + textwrap.dedent(body), "synth.py")


# ------------------------------------------------------------ tier-1 gate --


def test_control_plane_lints_clean():
    """The shipped control plane has zero racelint findings (tier-1)."""
    root = pathlib.Path(port_racelint.__file__).resolve().parents[1]
    files = port_racelint._target_files()
    assert root.name == "ballista_tpu_torch" and all(f.is_relative_to(root) for f in files)
    names = {f.relative_to(root).as_posix() for f in files}
    assert {"scheduler/server.py", "executor/executor.py", "client/flight.py",
            "event_loop.py", "standalone.py", "testing/faults.py",
            "exec/pipeline.py", "obs/trace.py", "ops/cuda_build.py",
            "ops/onehot_agg.py", "ops/partition.py", "ops/prefix_sum.py"} <= names
    diags = racelint.lint_paths()
    assert diags == [], "\n".join(str(d) for d in diags)


def test_targets_are_the_references_plus_the_kernel_wrappers():
    assert port_racelint._DEFAULT_TARGETS == ref_racelint._DEFAULT_TARGETS + (
        "ops/cuda_build.py", "ops/onehot_agg.py", "ops/partition.py", "ops/prefix_sum.py",
    )
    assert set(port_racelint.RULES) == set(ref_racelint.RULES)


# (the per-analyzer suppression-budget assertion moved to the single
# shared ledger test: tests/test_budget.py over analysis/budget.py)


def test_rule_catalog_documented():
    assert set(racelint.RULES) == {
        "unguarded-field", "lock-order-cycle", "blocking-under-lock",
        "undeclared-transition",
    }
    assert all(len(v) > 20 for v in racelint.RULES.values())


def test_lock_order_graph_exported_and_acyclic():
    edges = racelint.lock_order_graph()
    # the known inter-class orders of the control plane
    assert ("SchedulerServer._lock", "StageManager._lock") in edges
    assert ("SchedulerServer._lock", "ExecutorManager._lock") in edges
    # no reverse edges (acyclicity is also what rule 2 enforces)
    for (a, b) in edges:
        assert (b, a) not in edges, (a, b)
    dot = racelint.lock_order_dot()
    assert dot.startswith("digraph") and "SchedulerServer._lock" in dot


# ------------------------------------------- rule 1: unguarded-field -------


def test_unguarded_field_rejects_and_accepts():
    bad = _lint(
        """
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.x = 0
            def set(self, v):
                with self._lock:
                    self.x = v
            def peek(self):
                return self.x
        """
    )
    assert [d.rule for d in bad] == ["unguarded-field"]
    assert "C.x" in bad[0].message and bad[0].function == "peek"
    ok = _lint(
        """
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.x = 0
            def set(self, v):
                with self._lock:
                    self.x = v
            def peek(self):
                with self._lock:
                    return self.x
        """
    )
    assert ok == []


def test_unguarded_module_global():
    bad = _lint(
        """
        _LOCK = threading.Lock()
        _STATE = {}
        def put(k, v):
            with _LOCK:
                _STATE[k] = v
        def peek(k):
            return _STATE.get(k)
        """
    )
    assert [d.rule for d in bad] == ["unguarded-field"]
    assert "_STATE" in bad[0].message


def test_init_is_exempt():
    ok = _lint(
        """
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.x = 0  # construction is single-threaded
            def bump(self):
                with self._lock:
                    self.x += 1
        """
    )
    assert ok == []


# ---------------------------------------- rule 2: lock-order cycles --------


_CYCLE = """
class A:
    def __init__(self):
        self._lock = threading.Lock()
        self.b = B()
    def m1(self):
        with self._lock:
            self.b.m2()
class B:
    def __init__(self):
        self._lock = threading.Lock()
        self.a = A()
    def m2(self):
        with self._lock:
            pass
    def m3(self):
        with self._lock:
            self.a.m1()
"""


def test_lock_order_cycle_rejected_and_acyclic_accepted():
    bad = _lint(_CYCLE)
    assert any(d.rule == "lock-order-cycle" for d in bad), bad
    ok = _lint(_CYCLE.replace(
        "    def m3(self):\n        with self._lock:\n            self.a.m1()\n",
        "",
    ))
    assert [d for d in ok if d.rule == "lock-order-cycle"] == []


def test_non_reentrant_reacquire_flagged():
    bad = _lint(
        """
        class C:
            def __init__(self):
                self._lock = threading.Lock()
            def outer(self):
                with self._lock:
                    self.inner()
            def inner(self):
                with self._lock:
                    pass
        """
    )
    assert any(
        d.rule == "lock-order-cycle" and "non-reentrant" in d.message
        for d in bad
    ), bad
    # the same shape on an RLock is legal re-entrancy
    ok = _lint(
        """
        class C:
            def __init__(self):
                self._lock = threading.RLock()
            def outer(self):
                with self._lock:
                    self.inner()
            def inner(self):
                with self._lock:
                    pass
        """
    )
    assert [d for d in ok if d.rule == "lock-order-cycle"] == []


# -------------------------------------- rule 3: blocking under lock --------


def test_blocking_under_lock_direct_and_transitive():
    bad = _lint(
        """
        class C:
            def __init__(self):
                self._lock = threading.Lock()
            def direct(self):
                with self._lock:
                    time.sleep(0.1)
            def helper(self):
                time.sleep(0.1)
            def transitive(self):
                with self._lock:
                    self.helper()
        """
    )
    rules = [d.rule for d in bad]
    assert rules.count("blocking-under-lock") == 2, bad
    ok = _lint(
        """
        class C:
            def __init__(self):
                self._lock = threading.Lock()
            def fine(self):
                with self._lock:
                    x = 1
                time.sleep(0.1)
        """
    )
    assert ok == []


def test_blocking_queue_put_under_lock_flagged():
    """The EventLoop.stop() deadlock shape: a bounded-queue put while holding a lock
    the consumer thread needs."""
    bad = _lint(
        """
        import queue
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue(maxsize=10)
            def post(self, event):
                with self._lock:
                    self._q.put(event)
        """
    )
    assert [d.rule for d in bad] == ["blocking-under-lock"]
    # KV-store put(key, value) is NOT a queue put
    ok = _lint(
        """
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.backend = None
            def save(self, k, v):
                with self._lock:
                    self.backend.put(k, v)
        """
    )
    assert ok == []


# ------------------------------------ rule 4: undeclared transitions -------


def test_undeclared_task_transition_rejected():
    bad = _lint(
        """
        class TaskState:
            pass
        def f(t):
            if t.state == TaskState.PENDING:
                t.state = TaskState.COMPLETED
        """
    )
    assert [d.rule for d in bad] == ["undeclared-transition"]
    assert "pending -> completed" in bad[0].message


def test_declared_task_transition_accepted():
    ok = _lint(
        """
        class TaskState:
            pass
        def f(t):
            if t.state == TaskState.RUNNING:
                t.state = TaskState.PENDING
        """
    )
    assert ok == []


def test_dynamic_assignment_requires_table_guard():
    bad = _lint(
        """
        class TaskState:
            pass
        def f(t, new_state):
            t.state = new_state
        """
    )
    assert [d.rule for d in bad] == ["undeclared-transition"]
    ok = _lint(
        """
        class TaskState:
            pass
        _LEGAL = set()
        def f(t, new_state):
            if (t.state, new_state) not in _LEGAL:
                return
            t.state = new_state
        """
    )
    assert ok == []


def test_undeclared_job_state_rejected():
    bad = _lint(
        """
        def f(job):
            job.status = "zombie"
        """
    )
    assert [d.rule for d in bad] == ["undeclared-transition"]
    ok = _lint(
        """
        def f(job):
            job.status = "failed"
        """
    )
    assert ok == []


# ------------------------------------------------------- suppression -------


def test_suppression_line_and_function_scope():
    ok = _lint(
        """
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.x = 0
            def set(self, v):
                with self._lock:
                    self.x = v
            def peek(self):
                return self.x  # racelint: disable=unguarded-field
        """
    )
    assert ok == []
    ok2 = _lint(
        """
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.x = 0
            def set(self, v):
                with self._lock:
                    self.x = v
            def peek(self):  # racelint: disable=all
                return self.x
        """
    )
    assert ok2 == []


# --------------------------------------------------- state machine ---------


def test_tables_govern_runtime_validator():
    """stage_manager._LEGAL is DERIVED from the declared table — code and
    spec cannot drift."""
    from ballista_tpu_torch.scheduler.stage_manager import _LEGAL

    assert {(a.value, b.value) for a, b in _LEGAL} == set(TASK_TRANSITIONS)


def test_tables_render_and_cover_states():
    text = render_tables()
    assert "task transitions" in text and "job transitions" in text
    assert ("completed", "pending") in TASK_TRANSITIONS  # lost-shuffle
    assert ("completed", "running") in STAGE_TRANSITIONS  # rollback
    assert ("running", "failed") in JOB_TRANSITIONS


# ------------------------------------------------------ runtime witness ----


def test_witness_records_orders_and_flags_inversion():
    witness.reset()
    witness.enable(True)
    try:
        a = witness.make_lock("T.A")
        b = witness.make_lock("T.B")
        with a:
            with b:
                pass
        assert ("T.A", "T.B") in witness.edges()
        assert witness.violations() == []
        witness.assert_consistent([("T.A", "T.B")])
        # the static graph ordering B before A would be an inversion
        with pytest.raises(AssertionError):
            witness.assert_consistent([("T.B", "T.A")])

        # live inversion from another thread
        def invert():
            with b:
                with a:
                    pass

        t = threading.Thread(target=invert)
        t.start()
        t.join()
        assert witness.violations(), "B->A after A->B must be flagged"
    finally:
        witness.enable(False)
        witness.reset()


def test_witness_reentrant_lock_records_no_self_edge():
    witness.reset()
    witness.enable(True)
    try:
        a = witness.make_lock("T.R", reentrant=True)
        with a:
            with a:
                pass
        assert ("T.R", "T.R") not in witness.edges()
        assert witness.violations() == []
    finally:
        witness.enable(False)
        witness.reset()


def test_witness_disabled_returns_plain_locks():
    assert not witness.enabled()
    lk = witness.make_lock("T.plain")
    assert not isinstance(lk, witness.TracedLock)


# ------------------------------------------------------ combined gate ------


def test_combined_analysis_gate_is_clean():
    """`python -m ballista_tpu_torch.analysis` aggregates its analyzers
    into one exit code, with a summary line per analyzer (the whole gate,
    the corpus analyzers with it, runs in tests/test_torch_analysis_cli.py)."""
    from ballista_tpu_torch.analysis.__main__ import run_all

    names = ("serde-audit", "racelint", "lifelint", "proto-drift", "config-registry")
    lines: list[str] = []
    rc = run_all(only=names, out=lines.append, device="cpu")
    assert rc == 0, "\n".join(lines)
    for name in names:
        assert any(ln.startswith(f"{name}: OK") for ln in lines), lines


def test_cli_dot_and_tables_flags(capsys):
    from ballista_tpu_torch.analysis.__main__ import main

    assert main(["--dot"]) == 0
    assert "digraph lock_order" in capsys.readouterr().out
    assert main(["--tables"]) == 0
    assert "task transitions" in capsys.readouterr().out


# ---------------------------------------- a seeded fault in a port module --


@pytest.mark.parametrize("rel", ["ops/partition.py", "ops/cuda_build.py"])
def test_a_seeded_unguarded_read_in_a_port_module_is_found(rel, tmp_path):
    """The lint reads the port's own modules: a lock-free read of the
    state each wrapper sets under its lock, appended to a copy of the
    module, is its one finding."""
    root = pathlib.Path(port_racelint.__file__).resolve().parents[1]
    src = (root / rel).read_text()
    field = {"ops/partition.py": "_launcher", "ops/cuda_build.py": "_libs"}[rel]
    seeded = src + f"\n\ndef _seeded():\n    return {field}\n"
    f = tmp_path / pathlib.Path(rel).name
    f.write_text(seeded)
    diags = port_racelint.lint_paths([f])
    assert [(d.rule, d.line) for d in diags] == [("unguarded-field", len(seeded.splitlines()))]


# ------------------------------------------------- fixes of its findings --


def test_partition_launcher_is_set_once_under_concurrent_first_use(monkeypatch):
    """Task threads that ask for the partition-hash launcher at once all
    get the one launcher: it is set once, under its lock (it was set
    without one, and two first launches could each make their own)."""
    from ballista_tpu_torch.ops import partition

    made = []

    class FakeLauncher:
        def __init__(self, lib):
            made.append(self)
            time.sleep(0.05)  # widen the window a lock-free set would race in

    monkeypatch.setattr(partition, "_launcher", None)
    monkeypatch.setattr(partition, "_Launcher", FakeLauncher)
    monkeypatch.setattr(partition.cuda_build, "load", lambda source, configure: object())
    barrier = threading.Barrier(8)
    got = []

    def first_launch():
        barrier.wait()
        got.append(partition._lib())

    threads = [threading.Thread(target=first_launch) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(made) == 1 and len(got) == 8 and all(g is made[0] for g in got)


def test_kernel_build_holds_no_lock_and_runs_once(monkeypatch, tmp_path):
    """``cuda_build.load``: one thread builds a source while the others
    that ask for it wait without holding the module lock, so a thread
    that loads another, built kernel is not held behind nvcc; the source
    builds once."""
    from ballista_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "_building", {})
    slow, built = tmp_path / "slow.cu", tmp_path / "built.cu"
    cuda_build._libs[built] = "built-lib"
    release = threading.Event()
    builds = []

    def fake_build(source, verbose=False):
        builds.append(source)
        assert not cuda_build._lock.locked(), "nvcc must run outside the lock"
        release.wait(10)
        return tmp_path / "slow.so", 0.0, ""

    monkeypatch.setattr(cuda_build, "build", fake_build)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: f"lib:{pathlib.Path(path).name}")
    configured = []
    results = []

    def load_slow():
        results.append(cuda_build.load(slow, configured.append))

    threads = [threading.Thread(target=load_slow) for _ in range(4)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 10
    while not builds and time.monotonic() < deadline:
        time.sleep(0.01)
    # while the slow source builds, a built library loads at once
    assert cuda_build.load(built, configured.append) == "built-lib"
    release.set()
    for th in threads:
        th.join()
    assert builds == [slow] and configured == ["lib:slow.so"]
    assert results == ["lib:slow.so"] * 4
    assert cuda_build._building == {}


def _waits_in_load(thread) -> bool:
    """Is ``thread`` blocked in ``cuda_build.load``, waiting for another
    thread's build?"""
    frame = sys._current_frames().get(thread.ident)
    while frame is not None:
        caller = frame.f_back
        if frame.f_code.co_name == "wait" and caller is not None and caller.f_code.co_name == "load":
            return True
        frame = caller
    return False


def test_a_failed_build_fails_the_waiting_threads_too(monkeypatch, tmp_path):
    from ballista_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "_building", {})
    started = threading.Event()
    release = threading.Event()

    def failing_build(source, verbose=False):
        started.set()
        release.wait(10)
        raise RuntimeError("nvcc failed on bad.cu")

    monkeypatch.setattr(cuda_build, "build", failing_build)
    errors = []

    def load():
        try:
            cuda_build.load(tmp_path / "bad.cu", lambda lib: None)
        except RuntimeError as e:
            errors.append(str(e))

    owner = threading.Thread(target=load)
    owner.start()
    started.wait(10)
    waiter = threading.Thread(target=load)
    waiter.start()
    # release the build only once the second thread waits for it
    deadline = time.monotonic() + 10
    while not _waits_in_load(waiter) and time.monotonic() < deadline:
        time.sleep(0.005)
    assert _waits_in_load(waiter)
    release.set()
    owner.join()
    waiter.join()
    assert sorted(errors) == ["building bad.cu failed in another thread", "nvcc failed on bad.cu"]
    assert cuda_build._building == {}

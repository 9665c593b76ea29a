"""lifelint of the port (``ballista_tpu_torch/analysis/lifelint.py``), the
cases of ``tests/test_lifelint.py``: the port's control and data planes
lint clean, every fixture gives the reference lint's findings, declared
ownership transfers are enumerable, and the port's error taxonomy
(``errors.py``) is closed over every exception type its task-boundary
surfaces raise."""

import pathlib
import re
import textwrap

import pytest

from ballista_tpu.analysis import lifelint as ref_lifelint
from ballista_tpu_torch.analysis import lifelint as port_lifelint
from ballista_tpu_torch.errors import (
    NON_RETRYABLE_ERROR_TYPES,
    RETRYABLE_ERROR_TYPES,
    error_is_retryable,
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


lifelint = _HeldAgainstReference(port_lifelint, ref_lifelint)


def _lint(body: str):
    return lifelint.lint_source(textwrap.dedent(body), "synth.py")


def _rules(body: str):
    return [d.rule for d in _lint(body)]


# ------------------------------------------------------------ tier-1 gate --


def test_control_and_data_planes_lint_clean():
    root = pathlib.Path(port_lifelint.__file__).resolve().parents[1]
    assert port_lifelint._RESOURCE_TARGETS == ref_lifelint._RESOURCE_TARGETS
    assert port_lifelint._TAXONOMY_TARGETS == ref_lifelint._TAXONOMY_TARGETS
    files = port_lifelint._target_files(port_lifelint._RESOURCE_TARGETS)
    assert root.name == "ballista_tpu_torch" and all(f.is_relative_to(root) for f in files)
    assert {"exec/spill.py", "executor/push.py", "scheduler/server.py", "client/flight.py"} <= {
        f.relative_to(root).as_posix() for f in files
    }
    diags = lifelint.lint_paths()
    assert diags == [], "\n".join(str(d) for d in diags)


@pytest.mark.parametrize("rel,seed,rule", [
    ("executor/shuffle.py", "def _seeded(path):\n    f = open(path)\n    return 1\n",
     "leaked-resource"),
    ("scheduler/server.py", "def _seeded():\n    raise FrobnicationError('x')\n",
     "unclassified-raise"),
])
def test_a_seeded_fault_in_a_port_module_is_found(rel, seed, rule, tmp_path):
    """The lint reads the port's own modules: a fault appended to a copy
    of one is its one finding."""
    root = pathlib.Path(port_lifelint.__file__).resolve().parents[1]
    seeded = (root / rel).read_text() + "\n\n" + seed
    f = tmp_path / pathlib.Path(rel).name
    f.write_text(seeded)
    diags = port_lifelint.lint_paths([f])
    assert [d.rule for d in diags] == [rule]


# (the per-analyzer suppression-budget assertion moved to the single
# shared ledger test: tests/test_budget.py over analysis/budget.py)


def test_transfer_sites_are_declared_and_audited():
    sites = lifelint.transfer_sites()
    # the audited hand-offs: fire-and-forget task runners (semaphore-
    # bounded), etcd stream-bounded pumps, the Flight stream generator,
    # the push registry's streams, the job-completion thread: the
    # reference's six
    assert 1 <= len(sites) <= 10, sites
    assert sorted(n for _, _, n in sites) == sorted(n for _, _, n in ref_lifelint.transfer_sites())
    for _file, _line, note in sites:
        assert note, sites


def test_rule_catalog_documented():
    assert set(lifelint.RULES) == {
        "leaked-resource", "leak-on-error", "unclassified-raise",
        "swallowed-error", "untyped-injection",
    }
    assert all(len(v) > 20 for v in lifelint.RULES.values())


# ------------------------------------------------- rule: leaked-resource --


def test_leaked_channel_rejected_and_released_accepted():
    bad = """
    import grpc
    def dial():
        ch = grpc.insecure_channel("a:1")
        return 1
    """
    assert _rules(bad) == ["leaked-resource"]
    good = """
    import grpc
    def dial():
        ch = grpc.insecure_channel("a:1")
        try:
            return 1
        finally:
            ch.close()
    """
    assert _rules(good) == []


def test_with_managed_and_returned_resources_accepted():
    src = """
    def read(p):
        with open(p) as fh:
            return fh.read()
    def make(p):
        return open(p)  # factory: the caller owns it
    def use(p):
        with make(p) as fh:
            return fh.read()
    """
    assert _rules(src) == []


def test_anonymous_resource_dropped_on_the_spot_rejected():
    src = """
    import threading
    def fire(work):
        threading.Thread(target=work, daemon=True).start()
    """
    assert _rules(src) == ["leaked-resource"]


def test_transfer_annotation_declares_handoff():
    src = """
    import threading
    def fire(work):
        threading.Thread(  # lifelint: transfer=bounded-elsewhere
            target=work, daemon=True
        ).start()
    """
    assert _rules(src) == []


def test_class_held_resource_needs_release_method():
    bad = """
    import grpc
    class C:
        def start(self):
            self._ch = grpc.insecure_channel("a:1")
    """
    assert _rules(bad) == ["leaked-resource"]
    good = """
    import grpc
    class D:
        def start(self):
            self._ch = grpc.insecure_channel("a:1")
        def stop(self):
            self._ch.close()
    """
    assert _rules(good) == []
    # two attrs, one released: only the unreleased one flags
    mixed = """
    import grpc
    class M:
        def start(self):
            self._ok = grpc.insecure_channel("a:1")
            self._leaky = grpc.insecure_channel("b:2")
        def stop(self):
            self._ok.close()
    """
    diags = _lint(mixed)
    assert [d.rule for d in diags] == ["leaked-resource"]
    assert "_leaky" in diags[0].message


def test_release_via_local_alias_and_tuple_swap_accepted():
    src = """
    from concurrent.futures import ThreadPoolExecutor
    class H:
        def start(self):
            self._pool = ThreadPoolExecutor(max_workers=2)
        def stop(self):
            pool, self._pool = self._pool, None
            pool.shutdown()
    """
    assert _rules(src) == []


def test_container_store_is_ownership_transfer():
    src = """
    import threading
    class S:
        def start(self):
            self._threads = []
            t = threading.Thread(target=self.run)
            t.start()
            self._threads.append(t)
        def stop(self):
            for t in self._threads:
                t.join()
        def run(self):
            pass
    """
    assert _rules(src) == []


def test_sink_class_ctor_takes_ownership():
    src = """
    from concurrent.futures import ThreadPoolExecutor
    class Handle:
        def __init__(self, pool):
            self._pool = pool
        def stop(self):
            self._pool.shutdown()
    def start():
        pool = ThreadPoolExecutor(max_workers=2)
        return Handle(pool)
    """
    assert _rules(src) == []


def test_ipc_reader_over_owned_source_is_a_view():
    """pyarrow readers have no close(); the obligation lives on the
    source — the reader.py mmap leak shape."""
    bad = """
    import pyarrow as pa
    import pyarrow.ipc as paipc
    def load(p):
        return paipc.open_file(pa.memory_map(p))
    """
    assert _rules(bad) == ["leaked-resource"]
    good = """
    import pyarrow as pa
    import pyarrow.ipc as paipc
    def load(p, use):
        src = pa.memory_map(p)
        try:
            return use(paipc.open_file(src))
        finally:
            src.close()
    """
    assert _rules(good) == []


# -------------------------------------------------- rule: leak-on-error --


def test_release_skipped_by_exception_edge_rejected():
    bad = """
    import grpc
    def dial(rpc):
        ch = grpc.insecure_channel("a:1")
        rpc.PollWork()
        ch.close()
    """
    assert _rules(bad) == ["leak-on-error"]


def test_generator_holding_resource_across_yield_needs_finally():
    bad = """
    def stream(p):
        fh = open(p)
        yield fh.read()
        fh.close()
    """
    assert _rules(bad) == ["leak-on-error"]
    good = """
    def stream(p):
        fh = open(p)
        try:
            yield fh.read()
        finally:
            fh.close()
    """
    assert _rules(good) == []


# ---------------------------------------------- rule: unclassified-raise --


def test_unclassified_raise_rejected_and_taxonomy_accepted():
    assert _rules("def f():\n    raise FrobnicationError('x')\n") == [
        "unclassified-raise"
    ]
    assert _rules(
        "from ballista_tpu_torch.errors import ExecutionError\n"
        "def f():\n    raise ExecutionError('x')\n"
    ) == []
    # re-raise of a caught exception is never flagged
    assert _rules(
        "def f(w):\n"
        "    try:\n        w()\n"
        "    except FrobnicationError as e:\n        raise e\n"
    ) == []


def test_exception_factory_raises_resolve_to_their_return_type():
    src = """
    from ballista_tpu_torch.errors import ShuffleFetchError
    def _lost(msg):
        return ShuffleFetchError(msg)
    def f():
        raise _lost("gone")
    """
    assert _rules(src) == []


# ------------------------------------------------- rule: swallowed-error --


def test_silent_broad_except_rejected():
    assert _rules(
        "def f(w):\n    try:\n        w()\n"
        "    except Exception:\n        pass\n"
    ) == ["swallowed-error"]


def test_handled_broad_excepts_accepted():
    src = """
    import logging
    log = logging.getLogger(__name__)
    def logged(w):
        try:
            w()
        except Exception as e:
            log.warning("failed: %s", e)
    def fallback(w):
        try:
            w()
        except Exception:
            return 1
    def relay(w, sink):
        try:
            w()
        except Exception as e:
            sink(e)
    def close_suppress(ch):
        try:
            ch.close()
        except Exception:
            pass
    """
    assert _rules(src) == []


# ----------------------------------------------- rule: untyped-injection --


def test_injection_handler_must_reraise_typed():
    bad = """
    def f(w):
        try:
            w()
        except InjectedFault:
            pass
    """
    assert _rules(bad) == ["untyped-injection"]
    good = """
    from ballista_tpu_torch.errors import ShuffleFetchError
    def f(w):
        try:
            w()
        except InjectedFault as e:
            raise ShuffleFetchError(str(e))
    """
    assert _rules(good) == []


# --------------------------------------------------------- suppressions --


def test_suppression_line_and_def_scope():
    line = """
    import grpc
    def f():
        ch = grpc.insecure_channel("a")  # lifelint: disable=leaked-resource
    """
    assert _rules(line) == []
    fn = """
    import grpc
    def f():  # lifelint: disable=all
        ch = grpc.insecure_channel("a")
    """
    assert _rules(fn) == []


# ------------------------------------------------- error-taxonomy closure --


def test_taxonomy_lists_are_disjoint_and_nonempty():
    assert NON_RETRYABLE_ERROR_TYPES
    assert RETRYABLE_ERROR_TYPES
    assert not (NON_RETRYABLE_ERROR_TYPES & RETRYABLE_ERROR_TYPES)


def test_every_raised_type_in_task_boundary_dirs_classifies():
    """The closure the unclassified-raise rule enforces, asserted
    directly: zero findings over executor/, exec/, client/, scheduler/
    means every raise maps into exactly one taxonomy list."""
    diags = [
        d for d in lifelint.lint_paths()
        if d.rule == "unclassified-raise"
    ]
    assert diags == [], "\n".join(str(d) for d in diags)


def test_deterministic_builtins_no_longer_default_to_retryable():
    """Pre-PR-8 misclassification (fixed): a task failing with a
    deterministic bug type burned every bounded retry before failing
    the job, because unlisted types silently default to retryable."""
    for t in ("ValueError", "KeyError", "AssertionError", "TypeError"):
        assert not error_is_retryable(f"{t}: boom"), t
    for t in ("ShuffleFetchError", "CapacityError", "GrpcError",
              "InjectedFault"):
        assert error_is_retryable(f"{t}: transient"), t
    # unknown third-party types keep the safe default
    assert error_is_retryable("SomeVendorError: glitch")

"""Runs a script of the reference's mesh tier in a subprocess with the
8-device virtual CPU mesh (``conftest.CPU_MESH_ENV``), for the port's mesh
tests to hold their results against.

XLA's CPU collectives abort the process when the eight device threads of
an all-reduce do not all arrive within its 40 s rendezvous timeout, which
a loaded host can cause (ROADMAP queue 3). Such an abort is a fault of the
reference's harness, not a result: the script then runs once more. Any
other failure, or a second abort, fails the caller.
"""

from __future__ import annotations

import subprocess
import sys

from tests.conftest import CPU_MESH_ENV

_RENDEZVOUS_ABORT = "Termination timeout for `all reduce RendezvousKey"


def run_reference(script: str, *args: str, timeout: int = 300) -> str:
    """Runs ``script`` with ``args``; returns its standard output."""
    for attempt in range(2):
        proc = subprocess.run(
            [sys.executable, "-c", script, *args],
            env=CPU_MESH_ENV, capture_output=True, text=True, timeout=timeout,
        )
        if proc.returncode == 0:
            return proc.stdout
        if attempt or _RENDEZVOUS_ABORT not in proc.stderr:
            break
    raise AssertionError(f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")

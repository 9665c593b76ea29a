"""Interactive SQL shell — the ballista-cli equivalent.

ref ballista-cli/src/main.rs:33-110 (flags: host/port picks remote vs local
mode, --format, --quiet, -f script files), exec.rs:40-121 (the REPL loop:
statements end at ';', backslash commands handled inline), command.rs:35-183
(\\q \\d \\d name \\? \\h \\quiet \\pset) and print_format.rs (table / csv /
tsv / json / ndjson output). Run with ``python -m ballista_tpu_torch.cli``.

The reference links rustyline for history/editing; here stdlib ``readline``
provides the same when available. Scriptable via ``-f file`` or piped stdin,
which the tests use.

Port of ``ballista_tpu/cli.py``. The local context is a ``TorchContext``
and a remote one a ``BallistaContext`` client; both take ``--device``, by
default ``cuda``: without a card the shell exits before it reads a
statement unless started with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ballista_tpu_torch.errors import BallistaError

PRINT_FORMATS = ("table", "csv", "tsv", "json", "ndjson")

BANNER = "ballista-tpu SQL shell — \\? for help, \\q to quit"

HELP = """\
\\q             quit
\\d             list tables
\\d NAME        describe table
\\?             help
\\h             list functions
\\h NAME        search functions
\\quiet [on|off] print or set quiet mode
\\pset format F  set output format (table|csv|tsv|json|ndjson)
statements end with ';'
EXPLAIN [VERBOSE] VERIFY <query>;  static plan verification report
EXPLAIN ANALYZE <query>;  execute + print measured rows/bytes/elapsed
                          per physical operator (docs/observability.md)
"""


def format_batch(table, fmt: str) -> str:
    """Render a pyarrow Table in one of the reference's print formats
    (ref print_format.rs:48-130)."""
    import pyarrow.csv as pacsv

    if fmt == "table":
        df = table.to_pandas()
        return df.to_string(index=False) if len(df) else "(empty)"
    if fmt in ("csv", "tsv"):
        import io

        buf = io.BytesIO()
        opts = pacsv.WriteOptions(
            delimiter="\t" if fmt == "tsv" else ",",
            include_header=True,
        )
        pacsv.write_csv(table, buf, opts)
        return buf.getvalue().decode().rstrip("\n")
    rows = table.to_pylist()
    if fmt == "json":
        return json.dumps(rows, default=str)
    if fmt == "ndjson":
        return "\n".join(json.dumps(r, default=str) for r in rows)
    raise BallistaError(f"unknown print format {fmt!r}")


def list_functions() -> str:
    from ballista_tpu_torch.expr.logical import _SCALAR_FUNCS
    from ballista_tpu_torch.plugin import global_registry

    aggs = [
        "count", "sum", "min", "max", "avg", "stddev", "stddev_pop",
        "variance", "var_pop", "corr",
    ]
    udfs = global_registry.names()
    return "\n".join(
        ["-- scalar --"]
        + sorted(_SCALAR_FUNCS)
        + ["-- aggregate --"]
        + aggs
        + (["-- udf --"] + udfs if udfs else [])
    )


class Shell:
    """REPL state: context + print options (ref exec.rs PrintOptions)."""

    def __init__(self, ctx, fmt: str = "table", quiet: bool = False):
        self.ctx = ctx
        self.format = fmt
        self.quiet = quiet

    # -- backslash commands (ref command.rs:35-183) --------------------------
    def run_command(self, line: str, out) -> bool:
        """Handle one ``\\``-command. Returns False on quit."""
        parts = line[1:].strip().split(None, 1)
        cmd = parts[0] if parts else ""
        arg = parts[1].strip() if len(parts) > 1 else None
        if cmd == "q":
            return False
        if cmd == "?":
            out.write(HELP)
        elif cmd == "d" and arg is None:
            self.run_sql("show tables", out)
        elif cmd == "d":
            self.run_sql(f"show columns from {arg}", out)
        elif cmd == "h":
            funcs = list_functions()
            if arg:
                funcs = "\n".join(
                    l for l in funcs.splitlines() if arg.lower() in l
                )
            out.write(funcs + "\n")
        elif cmd == "quiet":
            if arg is None:
                out.write(f"quiet is {'on' if self.quiet else 'off'}\n")
            else:
                self.quiet = arg.lower() in ("true", "t", "yes", "y", "on")
        elif cmd == "pset":
            sub = (arg or "").split(None, 1)
            if len(sub) == 2 and sub[0] == "format":
                if sub[1] not in PRINT_FORMATS:
                    out.write(f"invalid format {sub[1]!r}\n")
                else:
                    self.format = sub[1]
            else:
                out.write(f"format is {self.format}\n")
        else:
            out.write(f"unknown command \\{cmd} — \\? for help\n")
        return True

    def run_sql(self, sql: str, out) -> None:
        t0 = time.time()
        try:
            table = self.ctx.sql(sql).collect()
        except BallistaError as e:
            out.write(f"error: {e}\n")
            return
        except Exception as e:  # noqa: BLE001 — a scheduler restart or a
            # transport error must not kill the interactive session
            out.write(f"error: {type(e).__name__}: {e}\n")
            return
        elapsed = time.time() - t0
        if table.num_rows or table.num_columns:
            out.write(format_batch(table, self.format) + "\n")
        if not self.quiet:
            out.write(
                f"{table.num_rows} row(s) in set. "
                f"Query took {elapsed:.3f} seconds.\n"
            )

    def run_line(self, line: str, buffer: list[str], out) -> bool:
        """Feed one input line; statements execute at ';'
        (ref exec.rs:58-95). Returns False on quit."""
        stripped = line.strip()
        if not buffer and stripped.startswith("\\"):
            return self.run_command(stripped, out)
        if not stripped and not buffer:
            return True
        buffer.append(line)
        if stripped.endswith(";"):
            sql = "\n".join(buffer).strip().rstrip(";")
            buffer.clear()
            if sql:
                self.run_sql(sql, out)
        return True

    def run_stream(self, lines, out) -> None:
        buffer: list[str] = []
        for line in lines:
            if not self.run_line(line.rstrip("\n"), buffer, out):
                return
        # trailing statement without ';' still executes (script mode)
        sql = "\n".join(buffer).strip().rstrip(";")
        if sql:
            self.run_sql(sql, out)

    def run_interactive(self, out) -> None:
        try:
            import readline  # noqa: F401 — line editing + history
        except ImportError:
            pass
        out.write(BANNER + "\n")
        buffer: list[str] = []
        while True:
            try:
                line = input("❯ " if not buffer else "… ")
            except EOFError:
                break
            except KeyboardInterrupt:
                buffer.clear()
                out.write("\n")
                continue
            if not self.run_line(line, buffer, out):
                break


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.cli",
        description="ballista-tpu SQL shell",
    )
    p.add_argument("--host", help="scheduler host (remote mode)")
    p.add_argument("--port", type=int, help="scheduler port (remote mode)")
    p.add_argument(
        "--format", default="table", choices=PRINT_FORMATS,
        help="output print format",
    )
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument(
        "-f", "--file", action="append", default=[],
        help="run SQL from file(s) then exit",
    )
    p.add_argument(
        "--batch-size", type=int, default=0,
        help="session ballista.batch.size override",
    )
    p.add_argument(
        "--device", default="cuda",
        help="where queries run: cuda (default; the shell exits without a "
        "card) or cpu",
    )
    return p


def make_context(args):
    """host+port -> remote cluster; otherwise a local in-process context
    (ref main.rs:107-110)."""
    from ballista_tpu_torch.config import BallistaConfig

    config = BallistaConfig()
    if args.batch_size:
        config = config.with_setting(
            "ballista.batch.size", str(args.batch_size)
        )
    if args.host and args.port:
        from ballista_tpu_torch.client.context import BallistaContext

        return BallistaContext.remote(
            args.host, args.port, config, device=args.device
        )
    from ballista_tpu_torch.exec.context import TorchContext

    return TorchContext(config, device=args.device)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    ctx = make_context(args)
    shell = Shell(ctx, fmt=args.format, quiet=args.quiet)
    out = sys.stdout
    if args.file:
        for path in args.file:
            with open(path) as f:
                shell.run_stream(f, out)
        return 0
    if sys.stdin.isatty():
        shell.run_interactive(out)
    else:
        shell.run_stream(sys.stdin, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""SQL front end: tokenizer, parser and SQL -> logical-plan planner (a copy
of the reference's ``ballista_tpu.sql``)."""

from ballista_tpu_torch.sql.parser import parse_sql

__all__ = ["parse_sql"]

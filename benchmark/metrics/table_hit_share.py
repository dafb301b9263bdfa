"""table_hit_share: the program's keyed table lookups that found their
table, over all lookups (counters `table.<cache>.hit` and
`table.<cache>.miss`), in both profiled windows of the traced run.
Layer: ops and routing (host)."""


def read(trace):
    from benchmark import spans
    c = spans.counters(trace)
    if not c:
        return None
    hits = sum(v for k, v in c.items()
               if k.startswith("table.") and k.endswith(".hit"))
    misses = sum(v for k, v in c.items()
                 if k.startswith("table.") and k.endswith(".miss"))
    return hits / (hits + misses) if hits + misses else None

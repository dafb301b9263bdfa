"""os_table_hit_share: path A's table lookups that found their table,
over all its lookups: the counters `table.osconv.hit`/`.miss` (K4's
twiddles) and `table.os_spec.hit`/`.miss` (the filter's spectrum), in
both profiled windows of the traced run. Layer: ops and routing
(host)."""

CACHES = ("table.osconv.", "table.os_spec.")


def read(trace):
    from benchmark import spans
    c = spans.counters(trace)
    if not c:
        return None
    mine = {k: v for k, v in c.items() if k.startswith(CACHES)}
    hits = sum(v for k, v in mine.items() if k.endswith(".hit"))
    misses = sum(v for k, v in mine.items() if k.endswith(".miss"))
    return hits / (hits + misses) if hits + misses else None

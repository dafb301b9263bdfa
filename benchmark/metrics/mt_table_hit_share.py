"""mt_table_hit_share: path D's lookups of the tapers, weights and K3's
stack kept on its configurations (`MTConfig.const`) that found their
table, over all of them: the counters `table.mt_const.hit` and
`table.mt_const.miss`, in both profiled windows of the traced run. None
where the program counts no such lookup. Layer: ops and routing
(host)."""

PREFIX = "table.mt_const."


def read(trace):
    from benchmark import spans
    c = spans.counters(trace)
    if not c:
        return None
    hits = c.get(PREFIX + "hit", 0)
    misses = c.get(PREFIX + "miss", 0)
    return hits / (hits + misses) if hits + misses else None

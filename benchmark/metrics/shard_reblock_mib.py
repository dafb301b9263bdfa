"""shard_reblock_mib: the bytes _reblock builds a call (its blocks with
halos: the rows a rank copies of its own and those it receives), in
MiB: the counter `shard.reblock.bytes` over the calls it covers, both
profiled windows of the traced run (2 x trace.calls). None where the
program counts no such bytes. Layer: ops and routing (host)."""

NAME = "shard.reblock.bytes"


def read(trace):
    from benchmark import spans
    c = spans.counters(trace)
    if not c or NAME not in c:
        return None
    return c[NAME] / (2 * trace.calls) / float(1 << 20)

"""shard_host_ms: the host's self time a call, in ms, in the spans of
the sharded chain's call, `entry`, `shard_fir`, `shard_sosfilt`,
`shard_welch`, `shard.reblock` and `kernel.biir`, over the calls of the
device-alone profile (dsptpu_torch.utils.profiling.self_times): the
host path of a call but the block's placement by shard_time, which
runs before the entry. A program without one of these spans leaves it
out; one with none of the shard_ spans reads None. Layer: ops and
routing (host)."""

SPANS = ("entry", "shard_fir", "shard_sosfilt", "shard_welch",
         "shard.reblock", "kernel.biir")


def read(trace):
    from benchmark import spans
    st = spans.self_times(trace)
    if not st or not any(k in st for k in SPANS if k.startswith("shard")):
        return None
    return 1e3 * sum(st.get(k, 0.0) for k in SPANS)

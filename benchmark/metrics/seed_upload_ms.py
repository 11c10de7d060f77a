"""Mean milliseconds a traced batch spends in `pack_seed_masks` and
`put_mask` (the benchmark's own host span around both, ended by a
device synchronise)."""


def read(ctx):
    spans = ctx.get("host_spans", {}).get("bench.seed_masks")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3

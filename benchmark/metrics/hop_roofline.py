"""The hop kernel's share of its roofline over the traced batches: the
least time of every hop (`reference/bounds.hop_bound`, fed with the
occupancy the reference computes for those batches' roots) over the
device time of the `bucket_hop` kernels in the trace, in %."""


def read(ctx):
    bound = ctx.get("hop_bound_s")
    busy = sum(b - a for name, a, b in ctx.get("device_events", ())
               if "bucket_hop" in name) / 1e6
    if not bound or busy <= 0:
        return None
    return 100.0 * bound / busy

"""The k-NN scan's share of its roofline over the traced window: the
scans served there (the program's `knn_route_total` counter, device and
fused routes) times one scan's least time (`reference/bounds.
knn_scan_bound`: the tablet read once) over the device time of the
matrix-vector and top-k kernels, in %."""

import re

SCAN = re.compile(r"gemv|gemm|topk", re.IGNORECASE)


def read(ctx):
    scans, bound = ctx.get("knn_scans"), ctx.get("knn_bound_s")
    busy = sum(b - a for name, a, b in ctx.get("device_events", ())
               if SCAN.search(name)) / 1e6
    if not scans or not bound or busy <= 0:
        return None
    return 100.0 * scans * bound / busy

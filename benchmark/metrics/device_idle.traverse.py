"""Share of the traced window in which no kernel, copy or fill ran on
the device (torch.profiler timeline), in %."""


def read(ctx):
    if ctx.get("window_s", 0) <= 0 or not ctx.get("device_events"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])

"""Mean duration of the port's `engine.render` span (utils/tracing.py) over
the requests of the traced window."""


def read(ctx):
    durs = ctx.get("program_spans", {}).get("engine.render")
    if not durs:
        return None
    return sum(durs) / len(durs) * 1e6

"""Share of the traced window in which no device operation ran: one less
the union of the profiler's device intervals over the window. Serves
every ``device_idle_pct.<cells>`` metric."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

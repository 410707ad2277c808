"""Milliseconds a request held the runner's device lock in the window: the
program's own counters, ``_ModelRunner.seconds / requests``, restarted at
the window's start."""


def read(ctx):
    if not ctx.get("requests"):
        return None
    return 1e3 * ctx["locked_s"] / ctx["requests"]

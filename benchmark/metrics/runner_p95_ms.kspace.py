"""The 95th percentile of every request's latency in the window, taken on
the client's side around ``_ModelRunner.segment_kspace``: the wait for the
runner's device lock behind the other clients and the request's own
time in it."""


def read(ctx):
    return ctx.get("p95_ms")

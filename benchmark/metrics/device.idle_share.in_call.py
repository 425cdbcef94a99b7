"""The share of the traced window, %, in which the device is idle while the
host is inside one of the program's calls (its `dogleg.call` span): the
part of device.idle_share.fleet that the per-call host path holds."""

from harness.spans import idle_in_call_share


def read(ctx):
    return idle_in_call_share(ctx.window)

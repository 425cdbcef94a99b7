"""The device's idle share of the traced window of a fleet cell, %."""

from harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)

"""The named K1's share of its roofline in the traced window, %."""

from harness.readers import k1_roofline


def read(ctx):
    return k1_roofline(ctx, "dogleg_mega_kernel")

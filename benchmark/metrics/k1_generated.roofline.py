"""The generated K1's share of its roofline in the traced window, %: the
same needed work as the named K1's."""

from harness.readers import k1_roofline


def read(ctx):
    return k1_roofline(ctx, "dogleg_auto_kernel")

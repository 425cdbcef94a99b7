"""Seconds auto-promotion spent tracing and generating code in the run
(mega_auto.trace_seconds at its end): set-up's share while auto.traces
reads 0, as the windows then trace nothing."""


def read(ctx):
    from libdogleg_tpu_torch.parallel import mega_auto
    value = getattr(mega_auto, "trace_seconds", None)
    return None if value is None else float(value)

"""Seconds the program spent building and loading its native libraries in
the run (loader.native_seconds at its end: nvcc where a build is missing,
and ctypes' load); a loaded library's lookup adds nothing. A run that
loaded no library (the plain path on the CPU) has nothing to read."""


def read(ctx):
    from libdogleg_tpu_torch.native import loader
    value = getattr(loader, "native_seconds", None)
    return float(value) if value else None

"""The reference's global-parameter interface (counterpart of
libdogleg_tpu/legacy.py).

The reference keeps two parameter APIs: the reentrant per-call
`dogleg_parameters2_t`, its own recommendation (dogleg.h:108-111), and the
older process-global `dogleg_set*()` setters (dogleg.c:131-181) read by
the entry points without the 2 suffix. This package is per-call; code
ported from the setters keeps its shape with this module, which mirrors
them onto a module-level parameter set.

Not thread-safe and not for new code, exactly like the original
(dogleg.h:108-111).
"""

from __future__ import annotations

from libdogleg_tpu_torch.params import DoglegParameters
from libdogleg_tpu_torch.problems import optimize as _optimize

_global_parameters = DoglegParameters()

# debug bits (reference dogleg.h:221-227): bit 30 selects the vnlog stream
DOGLEG_DEBUG_VNLOG = 1 << 30
_debug_bits = 0


def get_global_parameters() -> DoglegParameters:
    """The current global parameter set (a frozen snapshot)."""
    return _global_parameters


def set_max_iterations(n: int) -> None:
    """Reference dogleg_setMaxIterations (dogleg.c:170-173)."""
    global _global_parameters
    _global_parameters = _global_parameters.replace(max_iterations=int(n))


def set_initial_trustregion(t: float) -> None:
    """Reference dogleg_setInitialTrustregion (dogleg.c:158-161)."""
    global _global_parameters
    _global_parameters = _global_parameters.replace(trustregion0=float(t))


def set_thresholds(Jt_x: float, update: float, trustregion: float) -> None:
    """Reference dogleg_setThresholds (dogleg.c:162-169): a value <= 0
    leaves that threshold unchanged."""
    global _global_parameters
    kw = {}
    if Jt_x > 0:
        kw["Jt_x_threshold"] = float(Jt_x)
    if update > 0:
        kw["update_threshold"] = float(update)
    if trustregion > 0:
        kw["trustregion_threshold"] = float(trustregion)
    _global_parameters = _global_parameters.replace(**kw)


def set_trustregion_update_parameters(down_factor: float,
                                      down_threshold: float,
                                      up_factor: float,
                                      up_threshold: float) -> None:
    """Reference dogleg_setTrustregionUpdateParameters (dogleg.c:174-181)."""
    global _global_parameters
    _global_parameters = _global_parameters.replace(
        trustregion_decrease_factor=float(down_factor),
        trustregion_decrease_threshold=float(down_threshold),
        trustregion_increase_factor=float(up_factor),
        trustregion_increase_threshold=float(up_threshold))


def set_debug(debug: int) -> None:
    """Reference dogleg_setDebug (dogleg.c:140-157): a bit-mapped integer;
    bit 30 selects the vnlog stream, any other bit the human stream. Read
    by optimize() below (record_history, debug)."""
    global _debug_bits
    _debug_bits = int(debug)


def optimize(problem, p0, **kwargs):
    """The entry point without the 2 suffix: libdogleg_tpu_torch.optimize
    with the module's global parameters and debug bits (reference
    dogleg_optimize / dogleg_optimize_dense, dogleg.c:1755-1790)."""
    kwargs.setdefault("record_history",
                      bool(_debug_bits & DOGLEG_DEBUG_VNLOG))
    kwargs.setdefault("debug", bool(_debug_bits & ~DOGLEG_DEBUG_VNLOG))
    return _optimize(problem, p0, _global_parameters, **kwargs)

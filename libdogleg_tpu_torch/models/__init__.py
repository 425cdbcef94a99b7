"""Problem-family models. Ported so far: quadratic_surface, the reference
sample.c problem, and grid_mrf, the large block-sparse grid model."""

from libdogleg_tpu_torch.models import grid_mrf, quadratic_surface

__all__ = ["grid_mrf", "quadratic_surface"]

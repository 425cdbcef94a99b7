"""Problem-family models: quadratic_surface, the reference sample.c
problem; curve_fit, the small nonlinear dense fit; grid_mrf, the large
block-sparse grid model; and the bundle-adjustment families,
bundle_adjustment (linear, arrow-structured) and pinhole_ba (nonlinear
pinhole cameras, dense and sparse visibility)."""

from libdogleg_tpu_torch.models import (bundle_adjustment, curve_fit,
                                        grid_mrf, pinhole_ba,
                                        quadratic_surface)

__all__ = ["bundle_adjustment", "curve_fit", "grid_mrf", "pinhole_ba",
           "quadratic_surface"]

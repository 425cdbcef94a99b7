"""Alias: the reference's sample.c demo problem lives in
libdogleg_tpu_torch.models.quadratic_surface."""

from libdogleg_tpu_torch.models.quadratic_surface import (  # noqa: F401
    GRID_DELTA,
    GRID_MIN,
    GRID_WIDTH,
    NMEAS,
    NSTATE,
    P_TRUE,
    initial_state,
    jacobian,
    make_dense_problem,
    make_grid,
    make_products_problem,
    make_residual_problem,
    make_sparse_problem,
    model,
    products,
    products_minor,
    residuals,
    simulate,
)

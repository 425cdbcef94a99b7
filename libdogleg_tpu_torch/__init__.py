"""libdogleg_tpu_torch: the dog-leg least-squares solver in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The port of libdogleg_tpu (JAX on a TPU), which stays the reference each
module is tested against. Importing this package imports torch and numpy
only: never jax, never libdogleg_tpu, and it compiles nothing (the CUDA
kernels are built at their first launch).
"""

from libdogleg_tpu_torch.params import (
    DoglegParameters,
    get_default_parameters,
)
from libdogleg_tpu_torch.solver import (
    Products,
    SolveResult,
    StopReason,
    StepType,
    init_solver_state,
    result_from_state,
    run_solver,
    solve_products,
    solve_products_batched,
)
from libdogleg_tpu_torch.ops.newton import (
    BlockedDenseNewtonSolver,
    DenseNewtonSolver,
    SparseNewtonSolver,
)
from libdogleg_tpu_torch.problems import (
    DenseProblem,
    ProductsProblem,
    ResidualProblem,
    SparseProblem,
    optimize,
)
from libdogleg_tpu_torch.ops.mega import megakernel_optimize

__all__ = [
    "DoglegParameters",
    "get_default_parameters",
    "Products",
    "SolveResult",
    "StopReason",
    "StepType",
    "solve_products",
    "solve_products_batched",
    "init_solver_state",
    "run_solver",
    "result_from_state",
    "BlockedDenseNewtonSolver",
    "DenseNewtonSolver",
    "SparseNewtonSolver",
    "DenseProblem",
    "ProductsProblem",
    "ResidualProblem",
    "SparseProblem",
    "optimize",
    "megakernel_optimize",
]

__version__ = "0.1.0"

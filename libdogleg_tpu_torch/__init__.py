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
    BatchedSolverState,
    Products,
    SolveResult,
    StopReason,
    StepType,
    init_batched_state,
    init_solver_state,
    result_from_batched_state,
    result_from_state,
    run_batched_solver,
    run_solver,
    solve_products,
    solve_products_batched,
)
from libdogleg_tpu_torch.ops.newton import (
    BlockedDenseNewtonSolver,
    DenseNewtonSolver,
    SchurJtJ,
    SchurNewtonSolver,
    SparseNewtonSolver,
)
from libdogleg_tpu_torch.problems import (
    DenseProblem,
    FactoredBasisProblem,
    ProductsProblem,
    ResidualProblem,
    SparseProblem,
    optimize,
)
from libdogleg_tpu_torch.ops.bcsr import BCSRJacobian, BCSRStructure
from libdogleg_tpu_torch.ops.mega import megakernel_optimize
from libdogleg_tpu_torch.sparsity import bcsr_from_scalar_csr

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
    "BatchedSolverState",
    "init_batched_state",
    "run_batched_solver",
    "result_from_batched_state",
    "BlockedDenseNewtonSolver",
    "DenseNewtonSolver",
    "SchurJtJ",
    "SchurNewtonSolver",
    "SparseNewtonSolver",
    "DenseProblem",
    "FactoredBasisProblem",
    "ProductsProblem",
    "ResidualProblem",
    "SparseProblem",
    "optimize",
    "BCSRStructure",
    "BCSRJacobian",
    "bcsr_from_scalar_csr",
    "megakernel_optimize",
]

__version__ = "0.1.0"

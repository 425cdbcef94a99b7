"""The work a batch of sample problems needs from K1, the whole-solve
kernel, counted from the problem and the result rather than from any
kernel's code, so the named and the generated K1 are held to the same
count (chip_smoke.py's K1 bound, copied): one products evaluation at the
start and one an attempt, each 83 operations a measurement (16 for the
residual, 11 for the Jacobian, 2 for norm2, 12 for J^T x, 42 for the 21
entries of J^T J's lower triangle); an attempt's step math (Cholesky
n^3/3, two substitutions and two quadratic forms 6 n^2, about 10 n
besides); bytes: the starts, the measurements and the grid in, the nine
result fields out, each once."""

OPS_PER_MEASUREMENT = 83


def work(batch: int, nstate: int, nmeas: int, attempts: int,
         itemsize: int) -> tuple:
    """(operations, bytes) of one call of `batch` problems whose attempts
    total `attempts`."""
    n = nstate
    evals = attempts + batch
    flops = (evals * nmeas * OPS_PER_MEASUREMENT
             + attempts * (n ** 3 / 3 + 6 * n * n + 10 * n))
    floats_in = batch * n + batch * nmeas + 2 * nmeas
    floats_out = batch * (n + n + n * n + 3)
    ints_out = 3 * batch
    return flops, (floats_in + floats_out) * itemsize + ints_out * 4

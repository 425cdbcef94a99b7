"""The benchmark's own tests: CPU tests at small sizes, and tests marked
`cuda` that skip where torch finds no card. They import neither JAX nor
the JAX package."""

import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch.cuda "
        "finds none")

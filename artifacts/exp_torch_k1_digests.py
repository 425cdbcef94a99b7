#!/usr/bin/env python3
"""SHA-256 digests of kernel K1's named instances (general and factored) in
one tree of the repository, on one GPU: every field of each instance's
result in float32 at B=8192 under the benchmark rule and in float64 at
B=1024 under the defaults, on chip_smoke.py's inputs (chip_smoke.k1_digests
of this tree, run against the other tree's package).

Run from the repository root on a machine with a CUDA card and nvcc, once
for this tree and once for a parent unpacked into an ignored directory:

    mkdir -p _smoke_tree/parent
    git archive <commit> | tar -x -C _smoke_tree/parent
    python3 artifacts/exp_torch_k1_digests.py _smoke_tree/parent
    python3 artifacts/exp_torch_k1_digests.py

Each run builds that tree's kernel library and prints one JSON object:
the tree, the card, and the digests by instance, type and batch. Two trees
whose K1 gives the same bits print the same digests; chip_smoke.py's
K1_DIGESTS holds the parent's.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    tree = pathlib.Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("smoke_of_this_tree",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import libdogleg_tpu_torch
    package = pathlib.Path(libdogleg_tpu_torch.__file__).resolve()
    if tree not in package.parents:
        print(f"the package came from {package}, not {tree}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"tree": str(tree), "card": card,
                      "digests": smoke.k1_digests(torch.device("cuda"))}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

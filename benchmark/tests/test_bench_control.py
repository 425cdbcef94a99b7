"""The comparison that decides `correct`, held to its control and to
planted faults, on the CPU at small sizes: a sound run reads correct, the
control (the reference module's control_answers: the reference in
bfloat16 for the float32 fleet) fails a limit, and a run with the timed
path broken underneath (harness/faults.py) comes out not correct.
calibrate.py takes the same readings on the card at the cells' own
sizes.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import time

import pytest
import torch

from harness import cell as hc
from harness.faults import FAULTS

CPU = torch.device("cpu")
CELLS = [w["name"] for w in hc.benchmark()["workloads"]]


def small(kind, name):
    d = hc.read_json(kind, name)
    if kind == "mixes":
        d.update(batch=1024, frames=2)
        if "checked" in d:
            d.update(checked=512)
    return d


def entry(cell):
    return next(w for w in hc.benchmark()["workloads"] if w["name"] == cell)


def run_small(cell, seed):
    e = entry(cell)
    return hc.run_cell(cell, seed, 0.2, False, CPU, started=time.time(),
                       cfg=small("configs", e["config"]),
                       mix=small("mixes", e["traffic"]))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run_small(cell, 2 ** 31 + 3)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, seed):
    e = entry(cell)
    cfg, mix = small("configs", e["config"]), small("mixes", e["traffic"])
    ref = hc.load("reference", e["config"])
    inputs = hc.load("inputs", e["config"]).make(cfg, mix, seed, CPU)
    checks, _ = ref.judge(cfg, mix, inputs,
                          ref.control_answers(cfg, mix, inputs))
    assert any(value > limit for _, value, limit in checks), checks


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    with FAULTS[fault]():
        out = run_small(cell, 7)
    assert not out["correct"], (fault, out["checks"])

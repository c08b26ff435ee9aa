"""The benchmark on the card: each cell's run at its own size, held to the
reference, and the control (the reference in TF32 in the program's place)
failing a number the program passes. Skips on a host without a card.

    PYTHONPATH=src python -m pytest -q -m cuda portbench/test_portbench_chip.py
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402
from tinycells import BENCH  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_on_card(cuda_device, name):
    cell = harness.Cell(name, BENCH)
    res = harness.run_cell(cell, 2 ** 31 + 99, 4.0, False,
                           device=cuda_device, control=True)
    assert res["correct"], res["checks"]
    limits = cell.config["limits"]
    assert any(v > limits[k.split(".")[0]]
               for k, v in res["control"].items()), \
        res["control"]

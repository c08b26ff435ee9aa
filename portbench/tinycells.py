"""The cells at a tiny size, for the CPU tests that run them."""
import copy
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import harness  # noqa: E402

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())

# a tiny window: the harness holds it open for the three rounds the check
# samples from however short it is
TINY_CELLS = {w["name"]: 0.1 for w in BENCH["workloads"]}


def tiny(name: str) -> harness.Cell:
    """``name`` at 8 clients, 4 a round, 1 local epoch, a mean of 10
    samples a client (each client holds 20 or more, so every lane takes
    two steps or more) and a 50-image evaluation set; every other setting
    as the cell's."""
    cell = harness.Cell(name, BENCH)
    cfg = copy.deepcopy(cell.config)
    cfg["fl"].update(n_clients=8, clients_per_round=4, local_epochs=1)
    cfg["dataset"].update(samples_per_client=10, n_eval=50)
    cell.config = cfg
    return cell

"""The slice as a whole for the MoE + MLA family: DeepSeek-V2-Lite's
four cell kinds at its smoke config against the reference's, run (see
``test_torch_launch_cells.py``)."""
import pytest

from test_torch_launch_cells import SHAPES, check_cell
from test_torch_launch_specs import cached_reference_axes  # noqa: F401


@pytest.mark.parametrize("kind", list(SHAPES))
def test_moe_cell_runs_as_the_references(kind):
    check_cell("deepseek-v2-lite-16b", kind)

"""The port's example twins (``examples/torch_*.py``) run end to end on the
CPU at a reduced size, through the ``main`` a user calls, and print what
their reference examples print."""
import importlib.util
from pathlib import Path

import pytest

from test_torch_client_store import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _main(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_quickstart_twin(capsys):
    _main("torch_quickstart")(["--device", "cpu", "--rounds", "2"])
    out = capsys.readouterr().out
    assert "fedavg: sim_time=" in out and "apodotiko: sim_time=" in out
    assert out.count("device=cpu") == 2
    assert "time to acc" in out


def test_heterogeneous_cohort_twin_trains_proxy_lstm(capsys):
    _main("torch_heterogeneous_cohort")(["--device", "cpu", "--rounds", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 + 3 * 3                 # header, 3 x 3 rows
    assert {l.split()[0] for l in lines[1:]} == {
        "homogeneous", "two-tier", "heterogeneous"}


def test_sweep_paper_tables_twin(capsys):
    _main("torch_sweep_paper_tables")(["smoke", "--device", "cpu",
                                       "--workers", "2"])
    out = capsys.readouterr().out
    assert "sweep smoke: 2 runs" in out and "FAILED" not in out
    for table in ("Table IV", "Table V", "Table VI"):
        assert f"== {table}" in out
    assert "mean speedup vs fedavg [apodotiko]:" in out


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_heterogeneous_cohort",
                                  "torch_sweep_paper_tables"])
def test_twins_take_the_card_by_default(monkeypatch, name):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["smoke"] if name == "torch_sweep_paper_tables" else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _main(name)(argv)

"""CPU tests of the benchmark's yardstick: every cell's files found by
name, the FLOP and byte counts, the import rules, TF32 rounding and the
seeded client sizes.

    PYTHONPATH=src python -m pytest -q portbench/test_portbench_cpu.py
"""
import ast
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import harness  # noqa: E402
import reference  # noqa: E402
import roofline  # noqa: E402

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    spec = {w["name"]: w for w in BENCH["workloads"]}[name]
    cell = harness.Cell(name, BENCH)
    assert cell.config["name"] == spec["config"]
    assert cell.mix["name"] == spec["traffic"]
    assert set(cell.model_ref.LEAVES)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        reader = harness.load_module(HERE / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_matches_benchmark(name):
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    cfg = json.loads((HERE.parent / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"]
    ref = harness.load_module(HERE / "configs" / f"{name}.py")
    assert sum(math.prod(s) for s, _ in ref.LEAVES.values()) \
        == cfg["n_params"]


def test_flops_per_sample():
    ref = harness.load_module(HERE / "configs" / "femnist_cnn.py")
    assert roofline.flops_per_sample(ref, (28, 28, 1)) == (34_423_808,
                                                           102_017_024)


def test_byte_counts():
    # 100 active lanes of FemnistCNN's row (6,603,776 values) for one
    # step: 18.5 GB, 5.52 ms at 3.35 TB/s
    nbytes = roofline.adam_bytes(100, 6_603_776)
    assert nbytes == 18_490_572_800
    assert roofline.bound_s(nbytes=nbytes) == pytest.approx(5.52e-3,
                                                            rel=1e-3)
    # 30 rows aggregated at the same width: 31 rows of traffic
    assert roofline.aggregation_bytes(30, 6_603_776) == 818_868_224
    assert roofline.bound_s(flops=67e12) == 1.0


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_imports(path):
    """No file of the benchmark imports JAX or the JAX package (top-level
    names compared whole: ``repro_torch`` begins with ``repro``); the
    reference and the configurations' plain models import nothing of the
    program either."""
    names = _imports(path)
    assert not names & {"jax", "jaxlib", "flax", "repro"}
    if path.name == "reference.py" or path.parent.name == "configs":
        assert "repro_torch" not in names
        assert not names & {"harness", "generate"}


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -10])
    got = reference.tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -9]


def test_seed_keeps_the_work():
    """A seed changes the images and labels, not the clients' sizes or
    hardware: every seed runs the same schedule."""
    import generate
    spec = json.loads((HERE / "configs" / "femnist_cnn.json").read_text())
    a = generate.make_dataset(spec["dataset"], 40, 1)
    b = generate.make_dataset(spec["dataset"], 40, 2 ** 40 + 3)
    assert np.array_equal(a.n, b.n) and not np.array_equal(a.y, b.y)
    fleet = generate.make_fleet(spec["fleet"], 200, 0)
    assert fleet == generate.make_fleet(spec["fleet"], 200, 0)
    assert [p[0] for p in fleet].count("gpu") == 20


def test_adam_step_matches_torch_adam():
    """The reference's Adam step, its parameters and both moments, against
    ``torch.optim.Adam`` over three steps."""
    torch.manual_seed(0)
    adam = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}
    p = torch.randn(257, dtype=torch.float64)
    q = p.clone().requires_grad_(True)
    opt = torch.optim.Adam([q], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    m = v = torch.zeros_like(p)
    for t in (1, 2, 3):
        g = torch.randn_like(p)
        q.grad = g.clone()
        opt.step()
        p, m, v = reference.adam_step(p, m, v, g, t, 1e-3, adam)
        state = opt.state[q]
        # float64 both; torch forms m and v by ``lerp`` and ``addcmul``,
        # so they agree to rounding, not to the bit
        assert torch.allclose(p, q.detach(), rtol=0, atol=1e-14)
        assert torch.allclose(m, state["exp_avg"], rtol=1e-12, atol=1e-15)
        assert torch.allclose(v, state["exp_avg_sq"], rtol=1e-12, atol=1e-15)


def test_moment_gap_reads_bf16_storage():
    """Moments stored in bf16 read about bf16's rounding, 2**-9 of each
    leaf; exact ones read nought."""
    leaves = {"a": ((64, 32), "normal"), "b": ((32,), "zeros")}
    m, v = torch.randn(64 * 32 + 32), torch.rand(64 * 32 + 32)
    assert reference.moment_gap(m, v, m.double(), v.double(), leaves) == 0
    gap = reference.moment_gap(m.bfloat16(), v.bfloat16(), m.double(),
                               v.double(), leaves)
    assert 2 ** -12 < gap < 2 ** -8


@pytest.mark.parametrize("gaps,want", [([], 1.0), ([0.3], 0.3),
                                       ([0.1, 0.9, 0.2], 0.2)])
def test_second_largest(gaps, want):
    assert harness.second_largest(gaps) == want


def test_host_record_reads_nvidia_smi(tmp_path, monkeypatch):
    """The card's clock, power and temperature come from ``nvidia-smi``
    sampled beside the window, and its process is stopped at the close."""
    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\ntrap 'exit 0' TERM\n"
                   "echo '1980, 500.5, 700.00, 49'\n"
                   "echo '1755, 480.5, 700.00, 51'\n"
                   "while :; do sleep 0.05; done\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    rec = harness.HostRecord(torch.device("cuda"))
    rec.start()
    time.sleep(0.5)
    out = rec.stop(0.5)
    assert rec.smi.poll() is not None
    assert out["samples"] == 2 and out["sm_mhz_min"] == 1755.0
    assert out["power_limit_w"] == 700.0 and out["temp_c_max"] == 51.0

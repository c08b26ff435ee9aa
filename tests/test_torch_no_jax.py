"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports ``jax`` or anything of the JAX package ``repro``, and its entry
points never fall back to the CPU on their own."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.controller import Controller, FLConfig
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.device import resolve_device
from repro_torch.faas.hardware import paper_fleet
from repro_torch.models.proxy_models import ProxyCNN

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$|,)",
                       re.MULTILINE)


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = _modules()
    assert "repro_torch.core.controller" in mods
    assert "repro_torch.kernels.staleness_agg" in mods
    assert "repro_torch.core.scheduler" in mods
    assert "repro_torch.kernels.topk" in mods
    assert "repro_torch.kernels.quant8" in mods
    assert "repro_torch.kernels.flash_attention" in mods
    assert "repro_torch.models.paper_models" in mods
    assert "repro_torch.models.proxy_models" in mods
    assert {"repro_torch.sweep", "repro_torch.sweep.engine",
            "repro_torch.sweep.grid", "repro_torch.sweep.presets",
            "repro_torch.sweep.results", "repro_torch.sweep.runner",
            "repro_torch.traffic.slo"} <= set(mods)
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_source_scan_finds_no_jax_or_repro_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): FORBIDDEN.findall(f.read_text())
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import jax.numpy",
                 "from repro.core import x", "import repro", "  from repro "):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "import jaxlib_free", "x = 'import jax'"):
        assert not FORBIDDEN.search(line), line


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")

    data = make_federated_dataset("mnist", n_clients=4, scale=0.05, seed=0)
    cfg = FLConfig(n_clients=4, clients_per_round=2, rounds=1,
                   local_epochs=1, batch_size=5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Controller(cfg, ProxyCNN(10), data, list(paper_fleet(4)))
    ctl = Controller(cfg, ProxyCNN(10), data, list(paper_fleet(4)),
                     device="cpu")
    assert ctl.store.buffer.device.type == "cpu"
    assert np.isfinite(ctl.run()["total_time"])


@pytest.mark.parametrize("kw, match", [
    (dict(update_plane="blob"), "update_plane"),
    (dict(data_plane="host"), "data_plane"),
    (dict(fault_profile="crash-heavy"), "fault_profile"),
    (dict(traffic_profile="diurnal"), "traffic_profile"),
    (dict(durability="journal"), "durability"),
    (dict(mesh="2x1"), "mesh"),
    (dict(checkpoint_every=1, checkpoint_dir="ckpt"), "checkpointing"),
    (dict(optimizer="adafactor"), "adafactor"),
])
def test_left_out_settings_raise_naming_a_later_slice(kw, match):
    data = make_federated_dataset("mnist", n_clients=4, scale=0.05, seed=0)
    cfg = FLConfig(n_clients=4, clients_per_round=2, rounds=1, **kw)
    with pytest.raises(NotImplementedError, match=match) as err:
        Controller(cfg, ProxyCNN(10), data, list(paper_fleet(4)),
                   device="cpu")
    assert "slice" in str(err.value)


@pytest.mark.parametrize("field", ["durability_sync"])
def test_tuning_fields_of_left_out_features_are_not_accepted(field):
    """The reference's knobs that only tune a feature this slice leaves
    out are not fields of the port's config: passing one is an error."""
    with pytest.raises(TypeError, match=field):
        FLConfig(**{field: 1})

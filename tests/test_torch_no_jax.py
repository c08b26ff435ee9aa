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
            "repro_torch.traffic.slo", "repro_torch.traffic.model",
            "repro_torch.traffic.schedule", "repro_torch.faas.faults",
            "repro_torch.core.data_plane", "repro_torch.core.journal",
            "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
            "repro_torch.durability", "repro_torch.durability.manager",
            "repro_torch.durability.snapshot"} <= set(mods)
    assert {"repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.qwen3_1p7b", "repro_torch.configs.granite_8b",
            "repro_torch.configs.yi_6b", "repro_torch.configs.qwen3_4b",
            "repro_torch.configs.arctic_480b", "repro_torch.models.api",
            "repro_torch.models.attention", "repro_torch.models.blocks",
            "repro_torch.models.lm", "repro_torch.launch",
            "repro_torch.launch.train", "repro_torch.models.moe",
            "repro_torch.models.ssm", "repro_torch.configs.mamba2_370m",
            "repro_torch.configs.zamba2_2p7b",
            "repro_torch.configs.deepseek_v2_lite_16b",
            "repro_torch.models.encdec",
            "repro_torch.configs.llama32_vision_11b",
            "repro_torch.configs.seamless_m4t_large_v2"} <= set(mods)
    assert {"repro_torch.launch.steps", "repro_torch.launch.dryrun",
            "repro_torch.launch.mesh", "repro_torch.launch.roofline",
            "repro_torch.sharding", "repro_torch.sharding.rules"} <= set(mods)
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
    files = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "examples").glob("torch_*.py")))
    assert len(files) > 20
    assert ROOT / "examples" / "torch_train_fl_lm.py" in files
    assert PKG / "models" / "encdec.py" in files
    for mod in ("launch/steps.py", "launch/dryrun.py", "launch/mesh.py",
                "launch/roofline.py", "sharding/rules.py",
                "sharding/__init__.py"):
        assert PKG / mod in files
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


def test_fp32_scope_is_reentrant_thread_safe_and_restores():
    """``fp32_exact`` sets only the two TF32 flags, the first entry saves
    and the last exit restores the caller's values, and while any thread
    is inside, no other thread's exit turns TF32 back on."""
    import threading

    from repro_torch.device import fp32_exact

    flags = lambda: (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    others = lambda: (torch.backends.cudnn.enabled,
                      torch.backends.cudnn.benchmark,
                      torch.backends.cudnn.deterministic)
    was, was_others = flags(), others()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with fp32_exact():
            assert flags() == (False, False) and others() == was_others
            with fp32_exact():
                assert flags() == (False, False)
            assert flags() == (False, False)
        assert flags() == (True, True)
        inside, leave, seen = threading.Event(), threading.Event(), []

        def worker():
            with fp32_exact():
                inside.set()
                leave.wait(10)
                seen.append(flags())

        t = threading.Thread(target=worker)
        t.start()
        inside.wait(10)
        with fp32_exact():
            pass                   # this exit must not restore the flags
        seen.append(flags())
        leave.set()
        t.join(10)
        assert seen == [(False, False), (False, False)]
        assert flags() == (True, True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = was


def test_fp32_scope_holds_under_many_threads():
    """More threads than cores entering and leaving the scope with the
    interpreter switching often: inside, every thread always sees TF32 off
    (a lost update of the count would let one exit restore it under
    another); after, the caller's flags are back."""
    import os
    import sys
    import threading

    from repro_torch.device import fp32_exact

    was = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    bad, threads = [], []
    try:
        def worker():
            for _ in range(300):
                with fp32_exact():
                    if torch.backends.cudnn.allow_tf32 or \
                            torch.backends.cuda.matmul.allow_tf32:
                        bad.append(1)

        threads = [threading.Thread(target=worker)
                   for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert not bad
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        sys.setswitchinterval(switch)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = was


def test_training_and_evaluation_run_inside_the_fp32_scope():
    """The trainer's step loop and the runtime's evaluation see TF32 off;
    the caller's flags are back after the run."""
    data = make_federated_dataset("mnist", n_clients=4, scale=0.05, seed=0)
    seen = []

    class Recording(ProxyCNN):
        def loss(self, params, batch):
            seen.append(("loss", torch.backends.cudnn.allow_tf32))
            return super().loss(params, batch)

        def predict(self, params, x):
            seen.append(("predict", torch.backends.cudnn.allow_tf32))
            return super().predict(params, x)

    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        cfg = FLConfig(n_clients=4, clients_per_round=2, rounds=1,
                       local_epochs=1, batch_size=5)
        Controller(cfg, Recording(10), data, list(paper_fleet(4)),
                   device="cpu").run()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = was
    assert {k for k, _ in seen} == {"loss", "predict"}
    assert not any(flag for _, flag in seen)


@pytest.mark.parametrize("kw, match", [
    (dict(mesh="2x1"), "mesh"),
    (dict(optimizer="momentum"), "momentum"),
])
def test_left_out_settings_raise_naming_a_later_slice(kw, match):
    """Meshes other than ``1x1`` raise naming their slice. ``momentum``
    raised too until the launch slice ported it: that case now asserts
    that its clients train."""
    data = make_federated_dataset("mnist", n_clients=4, scale=0.05, seed=0)
    cfg = FLConfig(n_clients=4, clients_per_round=2, rounds=1, **kw)
    if match == "momentum":
        ctl = Controller(cfg, ProxyCNN(10), data, list(paper_fleet(4)),
                         device="cpu")
        assert ctl.trainer.opt.name == "momentum"
        assert np.isfinite(ctl.run()["total_time"])
        assert all(torch.isfinite(p).all() for p in ctl.params.values())
        return
    with pytest.raises(NotImplementedError, match=match) as err:
        Controller(cfg, ProxyCNN(10), data, list(paper_fleet(4)),
                   device="cpu")
    assert "slice" in str(err.value)


def test_adafactor_clients_run():
    """``FLConfig(optimizer="adafactor")``, which raised before the MoE +
    MLA slice, trains the cohorts (the cohort form over the rows' leaf
    views) on the port's entry point."""
    data = make_federated_dataset("mnist", n_clients=4, scale=0.05, seed=0)
    cfg = FLConfig(n_clients=4, clients_per_round=2, rounds=1,
                   local_epochs=1, batch_size=5, optimizer="adafactor",
                   lr=1e-2)
    ctl = Controller(cfg, ProxyCNN(10), data, list(paper_fleet(4)),
                     device="cpu")
    assert ctl.trainer.opt.name == "adafactor"
    m = ctl.run()
    assert np.isfinite(m["total_time"]) and m["rounds"] == 1
    assert all(torch.isfinite(p).all() for p in ctl.params.values())


@pytest.mark.parametrize("kw", [
    dict(update_plane="blob"), dict(data_plane="host"),
    dict(fault_profile="crash-heavy"), dict(traffic_profile="diurnal"),
])
def test_settings_of_the_profiles_and_planes_slice_run(kw):
    """The oracle planes and the fault and traffic profiles run on the
    port's entry point (on the CPU here) and report themselves."""
    data = make_federated_dataset("mnist", n_clients=4, scale=0.05, seed=0)
    cfg = FLConfig(n_clients=4, clients_per_round=2, rounds=1,
                   local_epochs=1, batch_size=5, **kw)
    m = Controller(cfg, ProxyCNN(10), data, list(paper_fleet(4)),
                   device="cpu").run()
    for key, value in kw.items():
        assert m[key] == value
    assert np.isfinite(m["total_time"])


@pytest.mark.parametrize("kw", [
    dict(durability="journal"), dict(durability="journal",
                                     durability_sync="event",
                                     durability_snap_every=2),
    dict(checkpoint_every=1),
])
def test_settings_of_the_durability_slice_run(kw, tmp_path):
    """Durable runs and database checkpoints run on the port's entry point
    (on the CPU here): the journal, its snapshots and the checkpoint land
    in ``checkpoint_dir`` and the metrics report them."""
    data = make_federated_dataset("mnist", n_clients=4, scale=0.05, seed=0)
    cfg = FLConfig(n_clients=4, clients_per_round=2, rounds=2,
                   local_epochs=1, batch_size=5,
                   checkpoint_dir=str(tmp_path), **kw)
    m = Controller(cfg, ProxyCNN(10), data, list(paper_fleet(4)),
                   device="cpu").run()
    assert np.isfinite(m["total_time"])
    files = set(os.listdir(tmp_path))
    if "durability" in kw:
        assert m["durability"] == "journal"
        assert m["durability_sync"] == kw.get("durability_sync", "round")
        assert m["journal_records"] > 0
        assert m["n_snapshots"] == 2 // kw.get("durability_snap_every", 1)
        assert "journal.wal" in files and any(
            f.startswith("snap_") for f in files)
    else:
        assert m["durability"] == "off"
        assert {"db.json", "blobs.npz", "update_store"} <= files


def test_lm_entry_points_take_the_card_and_never_fall_back(monkeypatch):
    """The LM client on the ``Controller`` and the serving and training
    entry points raise without a card unless asked for the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.api import LMClientAdapter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = make_federated_dataset("shakespeare", n_clients=4, scale=0.05,
                                  seed=0)
    cfg = FLConfig(n_clients=4, clients_per_round=2, rounds=1)
    model = LMClientAdapter(get_config("qwen3-1.7b", smoke=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Controller(cfg, model, data, list(paper_fleet(4)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])

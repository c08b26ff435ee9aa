"""The port's example twins (``examples/torch_*.py``) and the training
driver (``python -m repro_torch.launch.train``) run end to end on the CPU
at a reduced size, through the ``main`` a user calls, and print what their
reference examples print."""
import importlib.util
import math
import shutil
from pathlib import Path

import pytest
import torch

from test_torch_client_store import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main(name):
    return _module(name).main


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
                                  "torch_sweep_paper_tables",
                                  "torch_serve_lm", "torch_train_fl_lm"])
def test_twins_take_the_card_by_default(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["smoke"] if name == "torch_sweep_paper_tables" else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _main(name)(argv)


def test_serve_lm_twin_decodes_the_full_forwards_argmax(capsys):
    """Prefill 2 prompts of 8 tokens, decode 4: each decoded token is the
    greedy pick of the full forward over the sequence so far."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model

    seqs = _main("torch_serve_lm")(["--device", "cpu", "--tokens", "5",
                                    "--batch", "2", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "prefill 2x8" in out and "2L smoke config, cpu" in out
    assert "decoded 4 steps x 2 seqs" in out and out.count("seq[") == 2
    assert seqs.shape == (2, 5)
    cfg = get_config("qwen3-1.7b", smoke=True)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    with torch.no_grad():
        logits, _, _ = model.apply(
            params, {"tokens": torch.cat([prompts, seqs[:, :-1]], dim=1)})
    assert torch.equal(torch.argmax(logits[:, 7:], dim=-1), seqs)


def test_train_fl_lm_twin(capsys):
    ctl, m = _main("torch_train_fl_lm")(["--device", "cpu", "--rounds", "2",
                                        "--clients", "6"])
    out = capsys.readouterr().out
    assert ("federating qwen3-1.7b (2L, 0.1M params) over 6 FaaS clients"
            in out)
    assert out.count("token_acc=") == 2 and "done: 2 rounds" in out
    assert m["rounds"] == 2 and m["device"] == "cpu"
    assert ctl.params["layers"]["first"] == []


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_serve_lm_twin_serves_the_moe_family(arch, capsys):
    """The MoE archs through the serving example: each decoded token the
    greedy pick of the full forward (the smoke configs route at capacity
    factor 8, so no token drops in either path)."""
    _serve_picks_the_full_forwards_argmax(arch, capsys)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_serve_lm_twin_serves_the_ssm_families(arch, capsys):
    """The SSM and hybrid archs through the serving example: each decoded
    token (the recurrent step from the prefill's state) the greedy pick of
    the full forward (the chunked scan)."""
    _serve_picks_the_full_forwards_argmax(arch, capsys)


def _serve_picks_the_full_forwards_argmax(arch, capsys):
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model

    seqs = _main("torch_serve_lm")(["--arch", arch, "--device", "cpu",
                                    "--tokens", "4", "--batch", "2",
                                    "--prompt-len", "6"])
    out = capsys.readouterr().out
    cfg = get_config(arch, smoke=True)
    assert f"prefill 2x6 in" in out and f"({arch}, {cfg.n_layers}L" in out
    assert seqs.shape == (2, 4)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    prompts = torch.randint(0, cfg.vocab_size, (2, 6), generator=gen)
    with torch.no_grad():
        logits, _, _ = model.apply(
            params, {"tokens": torch.cat([prompts, seqs[:, :-1]], dim=1)})
    assert torch.equal(torch.argmax(logits[:, 5:], dim=-1), seqs)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_train_fl_lm_twin_federates_the_moe_family(arch, capsys):
    """The federated example with ``--arch`` an MoE arch: its host trace
    (selections, invocation records, round boundaries, simulated clock)
    equal to the reference example's setup run through the reference's
    ``Controller``, the port's params finite."""
    _federated_trace_is_the_references(arch, capsys)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_train_fl_lm_twin_federates_the_ssm_families(arch, capsys):
    """The federated example with ``--arch`` the SSM or the hybrid arch:
    its host trace equal to the reference example's setup run through the
    reference's ``Controller``, the port's params finite."""
    _federated_trace_is_the_references(arch, capsys)


def _federated_trace_is_the_references(arch, capsys):
    import jax
    import numpy as np

    from repro.configs.base import get_config as jax_get_config
    from repro.core.controller import Controller as JaxController
    from repro.core.controller import FLConfig as JaxFLConfig
    from repro.faas.hardware import paper_fleet as jax_fleet
    from repro.models.api import LMClientAdapter as JaxLMClientAdapter
    from repro_torch.kernels.ops import tree_leaves
    from test_torch_controller import host_trace

    ctl, m = _main("torch_train_fl_lm")(["--arch", arch, "--device", "cpu",
                                        "--rounds", "2", "--clients", "6"])
    out = capsys.readouterr().out
    assert f"federating {arch} (" in out and "done: 2 rounds" in out
    ref_ex = _module("train_fl_lm")
    jcfg = jax_get_config(arch, smoke=True).with_(vocab_size=256)
    jdata = ref_ex.make_lm_federated_data(6, 256, seq_len=32,
                                          samples_per_client=24)
    jfl = JaxFLConfig(
        n_clients=6, clients_per_round=4, rounds=2, strategy="apodotiko",
        concurrency_ratio=0.5, local_epochs=1, batch_size=4,
        optimizer="adam", lr=3e-4, base_step_time=2.0, seed=0)
    ref = JaxController(jfl, JaxLMClientAdapter(jcfg), jdata,
                        list(jax_fleet(6)))
    m_ref = ref.run()
    assert host_trace(ctl) == host_trace(ref)
    for key in ("total_time", "total_cost_usd", "n_invocations"):
        assert m[key] == m_ref[key], key
    assert len(ctl.params["layers"].get("first", [])) == \
        jcfg.first_dense_layers
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(ctl.params))
    assert np.isfinite(m["final_accuracy"]) and jax is not None


def test_train_fl_lm_full_config_has_100m_params():
    """``--full``: 12 layers of d 768 over a 32,000-token vocabulary,
    100,094,208 params."""
    from repro_torch.models.api import LMClientAdapter
    from repro_torch.models.common import count_params

    cfg = _module("torch_train_fl_lm").lm_config("qwen3-1.7b", full=True)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (12, 768, 32_000)
    assert cfg.remat and cfg.param_dtype == "float32"
    n = count_params(LMClientAdapter(cfg).init(device="meta"))
    assert n == 100_094_208


def _train(*extra):
    from repro_torch.launch import train
    return train.main(["--smoke", "--steps", "4", "--batch", "2", "--seq",
                       "17", "--device", "cpu", *extra])


def test_launch_train_resumes_where_the_uninterrupted_run_ends(tmp_path,
                                                              capsys):
    """4 steps with a checkpoint every 2, the step-4 checkpoint removed,
    then ``--resume``: the run restarts from step 2 on the stream's third
    batch and ends on the uninterrupted run's losses, params and
    optimizer state, to the bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.ops import tree_leaves

    whole = _train()
    ck = str(tmp_path / "ck")
    _train("--ckpt-dir", ck, "--ckpt-every", "2")
    mgr = CheckpointManager(ck)
    assert mgr.steps() == [2, 4]
    shutil.rmtree(mgr._step_dir(4))
    resumed = _train("--ckpt-dir", ck, "--ckpt-every", "2", "--resume")
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "checkpointed at" in out
    assert "training qwen3-1.7b (0.1M params, adam) for 4 steps on cpu" in out
    assert resumed["start_step"] == 2
    assert resumed["losses"] == whole["losses"][2:]
    for a, b in zip(tree_leaves(resumed["params"]),
                    tree_leaves(whole["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert resumed["opt_state"]["t"] == whole["opt_state"]["t"] == 4
    assert torch.equal(resumed["opt_state"]["m"], whole["opt_state"]["m"])
    assert torch.equal(resumed["opt_state"]["v"], whole["opt_state"]["v"])
    assert mgr.latest_step() == 4


def test_launch_train_resumes_arctics_adafactor_state(tmp_path, capsys):
    """Arctic's smoke config trains with Adafactor (its config's
    optimizer); its factored state (a tree shaped as the params, ``row`` /
    ``col`` per matrix, ``v`` per vector; ``t`` an int) goes through the
    checkpoint and ``--resume`` to end on the uninterrupted run's losses,
    params and state, to the bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.ops import tree_leaves

    arch = ("--arch", "arctic-480b")
    whole = _train(*arch)
    ck = str(tmp_path / "ck")
    _train(*arch, "--ckpt-dir", ck, "--ckpt-every", "2")
    mgr = CheckpointManager(ck)
    shutil.rmtree(mgr._step_dir(4))
    resumed = _train(*arch, "--ckpt-dir", ck, "--ckpt-every", "2",
                     "--resume")
    out = capsys.readouterr().out
    assert "training arctic-480b (" in out and "adafactor) for 4 steps" in out
    assert "resumed from step 2" in out
    assert resumed["losses"] == whole["losses"][2:]
    state, want = resumed["opt_state"], whole["opt_state"]
    assert state["t"] == want["t"] == 4 and isinstance(state["t"], int)
    assert set(state["s"]["layers"]["stack"]["mlp"]["w_up"]) == \
        {"row", "col"}
    assert set(state["s"]["ln_f"]) == {"v"}
    for a, b in zip(tree_leaves(resumed["params"]) + tree_leaves(state["s"]),
                    tree_leaves(whole["params"]) + tree_leaves(want["s"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_launch_train_cuts_the_depth(capsys):
    """``--layers N`` keeps the config's widths and cuts its depth to N
    layers, DeepSeek-V2-Lite's dense first layer among them (its smoke
    config here, cut from 3 layers to 2)."""
    out = _train("--arch", "deepseek-v2-lite-16b", "--layers", "2")
    assert len(out["params"]["layers"]["first"]) == 1
    assert out["params"]["layers"]["stack"]["ln_attn"].shape[0] == 1
    assert "adam) for 4 steps" in capsys.readouterr().out


def test_launch_train_takes_the_card_by_default_and_raises_unported(
        monkeypatch, capsys):
    """The VLM's smoke config, which raised before the VLM + enc-dec
    slice, trains (the reference's zero patches a step); without a card
    the launcher still raises rather than fall back to the CPU."""
    from repro_torch.launch import train
    out = train.main(["--arch", "llama-3.2-vision-11b", "--smoke",
                      "--steps", "2", "--batch", "2", "--seq", "17",
                      "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(map(math.isfinite, out["losses"]))
    assert set(out["params"]["layers"]) == {"cross", "stack"}
    assert "training llama-3.2-vision-11b (" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])

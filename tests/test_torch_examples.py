"""The port's example twins (``examples/torch_*.py``) and the training
driver (``python -m repro_torch.launch.train``) run end to end on the CPU
at a reduced size, through the ``main`` a user calls, and print what their
reference examples print."""
import importlib.util
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


def test_launch_train_takes_the_card_by_default_and_raises_unported(
        monkeypatch):
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="SSM"):
        train.main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])

"""The control and each fault the cells can have, caught: the harness
driven to its end on the CPU at a tiny size with the timed path broken
underneath, and ``correct`` false.

    PYTHONPATH=src python -m pytest -q portbench/test_portbench_faults.py
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402
from tinycells import tiny  # noqa: E402


def test_control_fails():
    """The control, the reference in TF32 in the program's place, fails a
    number that the program passes (here at a tiny size on the CPU)."""
    cell = tiny("femnist_cnn.apodotiko")
    res = harness.run_cell(cell, 91, 0.1, False, device="cpu", control=True)
    limits = cell.config["limits"]
    assert res["correct"]
    assert any(v > limits[k.split(".")[0]]
               for k, v in res["control"].items())


def _no_step(monkeypatch):
    import repro_torch.kernels.ref as ref
    monkeypatch.setattr(ref, "fused_adam", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from repro_torch.core import client

    def make(self):
        model = self.model

        def lane_loss(params, x, y, params0):
            half = x.shape[0] // 2
            loss, _ = model.loss(params, {"x": x[:half], "y": y[:half]})
            return loss

        return torch.func.vmap(torch.func.grad_and_value(lane_loss),
                               in_dims=(0, 0, 0, None))
    monkeypatch.setattr(client.CohortTrainer, "_make_grad_fn", make)


def _moments_unwritten(monkeypatch):
    """The step writes the parameters from the new moments but stores the
    moments it read."""
    import repro_torch.kernels.ref as ref
    orig = ref.fused_adam

    def step(p, m, v, *args, **kw):
        m0, v0 = m.clone(), v.clone()
        orig(p, m, v, *args, **kw)
        m.copy_(m0)
        v.copy_(v0)
    monkeypatch.setattr(ref, "fused_adam", step)


def _bf16_moments(monkeypatch):
    """The moments stored in bf16, the parameters stepped in fp32."""
    import repro_torch.kernels.ref as ref
    orig = ref.fused_adam

    def step(p, m, v, *args, **kw):
        orig(p, m, v, *args, **kw)
        m.copy_(m.bfloat16().float())
        v.copy_(v.bfloat16().float())
    monkeypatch.setattr(ref, "fused_adam", step)


def _one_lane_half_batch(monkeypatch):
    """Lane 0's gradient taken over half its minibatch, its loss and every
    other lane sound: a backward fault the median gap lets through."""
    from repro_torch.core import client

    def make(self):
        model = self.model

        def lane_loss(params, x, y, params0, part=1):
            n = x.shape[0] // part
            loss, _ = model.loss(params, {"x": x[:n], "y": y[:n]})
            return loss

        full = torch.func.vmap(torch.func.grad_and_value(lane_loss),
                               in_dims=(0, 0, 0, None))
        half = torch.func.vmap(
            torch.func.grad(lambda *a: lane_loss(*a, part=2)),
            in_dims=(0, 0, 0, None))

        def grad_fn(params, x, y, params0):
            g, loss = full(params, x, y, params0)
            g_half = half(params, x, y, params0)
            return {k: torch.cat([g_half[k][:1], g[k][1:]]) for k in g}, loss
        return grad_fn
    monkeypatch.setattr(client.CohortTrainer, "_make_grad_fn", make)


def _altered_aggregate(monkeypatch):
    from repro_torch.core import services
    orig = services.weighted_aggregate_rows

    def altered(*args, **kw):
        out = orig(*args, **kw)
        out["fc2_b"] = out["fc2_b"] + 1e-3
        return out
    monkeypatch.setattr(services, "weighted_aggregate_rows", altered)


def _altered_selection(monkeypatch):
    from repro_torch.core.strategies import base
    orig = base.apodotiko_select

    def altered(db, k, rng, **kw):
        sel = orig(db, k, rng, **kw)
        others = [c for c in db.idle_client_ids() if c not in sel]
        return sel[:-1] + others[:1] if others else sel[::-1]
    monkeypatch.setattr(base, "apodotiko_select", altered)


@pytest.mark.parametrize("fault,check", [
    (_no_step, "opt_gap"), (_half_batch, "grad_gap"),
    (_moments_unwritten, "moment_gap"), (_bf16_moments, "moment_gap"),
    (_one_lane_half_batch, "grad_gap_2nd"),
    (_altered_aggregate, "agg_gap"), (_altered_selection, "select_mismatch")],
    ids=["state_unchanged", "half_batch", "moments_unwritten", "bf16_moments",
         "one_lane_half_batch", "aggregate_altered", "selection_altered"])
def test_fault_makes_run_incorrect(monkeypatch, fault, check):
    """The harness driven to its end with the timed path broken underneath
    (no chip needed): ``correct`` comes out false, by the check that the
    fault is that check's to catch. One card's cells have no exchange
    between chips to leave out."""
    fault(monkeypatch)
    res = harness.run_cell(tiny("femnist_cnn.apodotiko"), 4242, 0.1, False,
                           device="cpu")
    assert not res["correct"]
    c = res["checks"][check]
    assert c["value"] > c["limit"], res["checks"]



"""The port's ``momentum`` optimizer against the reference's: the pytree
form step by step, the cohort form lane by lane (masked lanes untouched),
and a federated run with ``optimizer="momentum"`` against the reference's
``Controller`` (host trace identical, params at rtol 1e-4 / atol 1e-5).
The optimizer steps compare at rtol 1e-5 / atol 1e-6 (elementwise, as
the other optimizers' tests)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as joptim
from repro_torch import optim
from repro_torch.kernels.ops import tree_leaves
from repro_torch.models.convert import params_from_numpy
from test_torch_controller import ATOL, RTOL, _run_both, host_trace
from trace_harness import base_cfg_kw

OPT_RTOL, OPT_ATOL = 1e-5, 1e-6


def _tree(rng):
    return {"b": rng.normal(size=(7,)).astype(np.float32),
            "w": rng.normal(size=(5, 6)).astype(np.float32),
            "first": [{"e": rng.normal(size=(3, 4)).astype(np.float32)}]}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=OPT_RTOL,
                               atol=OPT_ATOL)


@pytest.mark.parametrize("beta", [0.9, 0.5])
def test_momentum_pytree_form_matches_the_reference(beta):
    """Five steps from the same params and grads: the fp32 ``m``, the
    update ``-lr * m`` and the params after ``apply_updates``; a bf16
    leaf's grad is read in fp32, its param cast back."""
    rng = np.random.default_rng(3)
    p = params_from_numpy(_tree(rng), "cpu")
    p["w"] = p["w"].to(torch.bfloat16)
    jp = jax.tree.map(jnp.asarray, _tree(np.random.default_rng(3)))
    jp["w"] = jp["w"].astype(jnp.bfloat16)
    opt, jopt = optim.momentum(1e-2, beta), joptim.momentum(1e-2, beta)
    assert optim.build_optimizer("momentum", 1e-2).name == "momentum"
    state, jstate = opt.init(p), jopt.init(jp)
    assert state["m"]["w"].dtype == torch.float32
    for step in range(5):
        g = _tree(np.random.default_rng(50 + step))
        tg = params_from_numpy(g, "cpu")
        tg["w"] = tg["w"].to(torch.bfloat16)
        jg = jax.tree.map(jnp.asarray, g)
        jg["w"] = jg["w"].astype(jnp.bfloat16)
        upd, state = opt.update(tg, state, p)
        jupd, jstate = jopt.update(jg, jstate, jp)
        p, jp = optim.apply_updates(p, upd), joptim.apply_updates(jp, jupd)
        for a, b in zip(tree_leaves(upd), jax.tree.leaves(jupd)):
            assert a.dtype == torch.float32
            _close(a, b)
        for a, b in zip(tree_leaves(state["m"]), jax.tree.leaves(jstate["m"])):
            _close(a, b)
        for a, b in zip(tree_leaves(p), jax.tree.leaves(jp)):
            assert str(a.dtype).endswith(str(b.dtype))
            _close(a.float(), np.asarray(b, np.float32))


def test_momentum_cohort_form_follows_each_lane_of_the_reference():
    """The cohort form over ``[Kp, W]`` rows, lanes of 4, 1, 0 and 3
    steps: each active lane follows the pytree reference's trajectory; a
    lane past its budget keeps its params and its ``m`` as they are."""
    rng = np.random.default_rng(5)
    steps = np.array([4, 1, 0, 3], np.int32)
    flat0 = rng.normal(size=(4, 37)).astype(np.float32)
    opt, jopt = optim.build_optimizer("momentum", 5e-2), \
        joptim.momentum(5e-2)
    flat = torch.as_tensor(flat0.copy())
    state = opt.cohort_init(flat)
    lanes = [{"p": jnp.asarray(r)} for r in flat0]
    jstates = [jopt.init(l) for l in lanes]
    m_before = None
    for s in range(int(steps.max())):
        g = rng.normal(size=flat0.shape).astype(np.float32)
        opt.cohort_step(flat, state, torch.as_tensor(g),
                        torch.as_tensor(steps), s)
        for i in np.flatnonzero(steps > s):
            upd, jstates[i] = jopt.update({"p": jnp.asarray(g[i])},
                                          jstates[i], lanes[i])
            lanes[i] = joptim.apply_updates(lanes[i], upd)
        _close(flat.numpy(), np.stack([np.asarray(l["p"]) for l in lanes]))
        for i in np.flatnonzero(steps > s):
            _close(state["m"][i].numpy(), np.asarray(jstates[i]["m"]["p"]))
        if s == 1:
            m_before = state["m"][1].clone()
    assert np.array_equal(flat[2].numpy(), flat0[2])     # 0 steps
    assert float(state["m"][2].abs().max()) == 0.0
    assert torch.equal(state["m"][1], m_before)          # done after 1


def test_federated_run_with_momentum_matches_the_reference():
    """``FLConfig(optimizer="momentum")`` on the port's ``Controller``
    (the cohort trainer's cohort form) against the reference's from the
    same params and minibatch draws: the host trace identical, the final
    params within rtol 1e-4 / atol 1e-5."""
    kw = base_cfg_kw(strategy="apodotiko", rounds=1, optimizer="momentum",
                     lr=1e-2)
    port, m, ref, m_ref, _ = _run_both(kw)
    assert port.trainer.opt.name == "momentum"
    assert m["rounds"] == m_ref["rounds"] == 1
    assert host_trace(port) == host_trace(ref)
    for name, leaf in port.params.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref.params[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)

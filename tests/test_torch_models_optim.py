"""The port's models and optimizers against the reference's.

Both packages start from the reference-initialized params, carried over
as numpy. Logits, loss and grads compare at rtol 1e-4 / atol 1e-5: the
convolutions reduce in another order in the two frameworks. The optimizer
trajectories are elementwise and compare at rtol 1e-5 / atol 1e-6."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as joptim
from repro.models.paper_models import MnistCNN as JaxMnistCNN
from repro.models.proxy_models import ProxyCNN as JaxProxyCNN
from repro_torch import optim
from repro_torch.models.common import count_params
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.paper_models import MnistCNN
from repro_torch.models.proxy_models import ProxyCNN, build_bench_model

RTOL, ATOL = 1e-4, 1e-5
OPT_RTOL, OPT_ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("name, batch", [("mnist", 4), ("proxy", 6)])
def test_forward_loss_and_grads_match_reference(name, batch):
    jmodel, model = ((JaxMnistCNN(), MnistCNN()) if name == "mnist"
                     else (JaxProxyCNN(10), ProxyCNN(10)))
    jparams = jmodel.init(jax.random.PRNGKey(1))[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(batch,) + model.input_shape).astype(np.float32)
    y = rng.integers(0, 10, size=batch).astype(np.int32)

    np.testing.assert_allclose(
        model.predict(params, torch.as_tensor(x)).detach().numpy(),
        np.asarray(jmodel.predict(jparams, jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)

    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch)[0])(jparams)
    tbatch = {"x": torch.as_tensor(x), "y": torch.as_tensor(y).long()}
    grads, loss = torch.func.grad_and_value(
        lambda p: model.loss(p, tbatch)[0])(params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=ATOL)
    for k, g in params_to_numpy(grads).items():
        np.testing.assert_allclose(g, np.asarray(jgrads[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_mnist_cnn_has_the_paper_param_count():
    params = MnistCNN().init(torch.Generator().manual_seed(0))
    assert count_params(params) == 582_026
    jparams = JaxMnistCNN().init(jax.random.PRNGKey(0))[0]
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in jparams.items()}
    assert isinstance(build_bench_model("mnist", "paper"), MnistCNN)
    assert isinstance(build_bench_model("femnist"), ProxyCNN)


def _quadratic_grads(params, target):
    return {k: 2.0 * (p - target[k]) for k, p in params.items()}


@pytest.mark.parametrize("which", ["adam", "adam_fused"])
def test_adam_trajectory_matches_reference_over_eight_steps(which):
    rng = np.random.default_rng(4)
    init = {"w": rng.normal(size=(5, 3)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}
    target = {k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in init.items()}
    jopt = joptim.adam(1e-2)
    opt = getattr(optim, which)(1e-2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jt = {k: jnp.asarray(v) for k, v in target.items()}
    tp = params_from_numpy(init, "cpu")
    tt = params_from_numpy(target, "cpu")
    jstate, state = jopt.init(jp), opt.init(tp)
    for _ in range(8):
        jupd, jstate = jopt.update(_quadratic_grads(jp, jt), jstate, jp)
        jp = joptim.apply_updates(jp, jupd)
        upd, state = opt.update(_quadratic_grads(tp, tt), state, tp)
        tp = optim.apply_updates(tp, upd)
        for k in init:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=OPT_RTOL, atol=OPT_ATOL)


@pytest.mark.parametrize("name", ["adam", "adam-plain", "sgd"])
def test_cohort_step_matches_per_lane_reference(name):
    """The trainer's cohort form steps every active lane of a stacked
    [Kp, W] buffer in place and leaves finished lanes as they are; each
    active lane follows the reference optimizer's pytree trajectory."""
    rng = np.random.default_rng(5)
    steps = np.array([4, 1, 0, 3], np.int32)
    flat0 = rng.normal(size=(4, 16)).astype(np.float32)
    if name == "adam-plain":
        opt, jopt = optim.adam(1e-2), joptim.adam(1e-2)
    else:
        opt = optim.build_optimizer(name, 1e-2)
        jopt = joptim.build_optimizer(name, 1e-2)
    flat = torch.as_tensor(flat0.copy())
    state = opt.cohort_init(flat)
    lanes = [{"p": jnp.asarray(r)} for r in flat0]
    jstates = [jopt.init(l) for l in lanes]
    for s in range(int(steps.max())):
        g = rng.normal(size=flat0.shape).astype(np.float32)
        opt.cohort_step(flat, state, torch.as_tensor(g),
                        torch.as_tensor(steps), s)
        for i in np.flatnonzero(steps > s):
            upd, jstates[i] = jopt.update({"p": jnp.asarray(g[i])},
                                          jstates[i], lanes[i])
            lanes[i] = joptim.apply_updates(lanes[i], upd)
        want = np.stack([np.asarray(l["p"]) for l in lanes])
        np.testing.assert_allclose(flat.numpy(), want, rtol=OPT_RTOL,
                                   atol=OPT_ATOL)
    assert np.array_equal(flat[2].numpy(), flat0[2])   # 0 steps: untouched


def test_build_optimizer_sends_adam_to_the_fused_kernel():
    assert optim.build_optimizer("adam", 1e-3).name == "adam-fused"
    assert optim.build_optimizer("sgd", 1e-3).name == "sgd"
    # momentum raised until the launch slice; it builds now
    assert optim.build_optimizer("momentum", 1e-3).name == "momentum"
    with pytest.raises(ValueError):
        optim.build_optimizer("lion", 1e-3)

"""The paper's other three client models (FEMNIST, Speech, Shakespeare
LSTM) and ``ProxyLSTM`` against the reference's.

Both packages start from the reference-initialized params, carried over as
numpy. Logits, loss and every grad compare at rtol 1e-4 / atol 1e-5 (the
convolutions and the LSTM's products reduce in another order in the two
frameworks; the 80-step recurrence needs no wider tolerance at these
sizes). Param names and shapes equal the reference's ``init``, and the
counts its docstring gives."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import paper_models as jpaper
from repro.models.proxy_models import ProxyLSTM as JaxProxyLSTM
from repro_torch.models.common import ParamFactory, count_params
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.paper_models import (PAPER_MODELS, FemnistCNN,
                                             ShakespeareLSTM, SpeechCNN,
                                             build_paper_model)
from repro_torch.models.proxy_models import ProxyLSTM, build_bench_model
from test_torch_client_store import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
pytestmark = pytest.mark.usefixtures("one_torch_thread")

# name -> (port model, reference model, param count)
MODELS = {
    "paper-femnist": (FemnistCNN, jpaper.FemnistCNN, 6_603_710),
    "paper-speech": (SpeechCNN, jpaper.SpeechCNN, 67_267),
    "paper-shakespeare": (ShakespeareLSTM, jpaper.ShakespeareLSTM, 818_402),
    "proxy-lstm": (ProxyLSTM, JaxProxyLSTM, 82 * 8 + 8 * 256 + 64 * 256
                   + 256 + 64 * 82 + 82),
}


def _inputs(model, batch, seed):
    """Seeded numpy inputs: token ids [B, seq_len] for an LSTM, NHWC images
    otherwise; labels over the model's classes."""
    rng = np.random.default_rng(seed)
    if hasattr(model, "seq_len"):
        x = rng.integers(0, model.vocab, (batch, model.seq_len)).astype(np.int32)
    else:
        x = rng.normal(size=(batch,) + model.input_shape).astype(np.float32)
    y = rng.integers(0, model.n_classes, batch).astype(np.int32)
    return x, y


@pytest.mark.parametrize("name", list(MODELS))
def test_param_names_shapes_and_count_equal_the_reference(name):
    cls, jcls, count = MODELS[name]
    params = cls().init(torch.Generator().manual_seed(0))
    jparams = jcls().init(jax.random.PRNGKey(0))[0]
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in jparams.items()}
    assert count_params(params) == count
    assert all(v.dtype == torch.float32 for v in params.values())


@pytest.mark.parametrize("name, batch", [("paper-femnist", 2),
                                         ("paper-speech", 4),
                                         ("paper-shakespeare", 3),
                                         ("proxy-lstm", 4)])
def test_predict_loss_and_grads_match_reference(name, batch):
    cls, jcls, _ = MODELS[name]
    model, jmodel = cls(), jcls()
    jparams = jmodel.init(jax.random.PRNGKey(1))[0]
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    x, y = _inputs(model, batch, seed=2)

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
    got = params_to_numpy(grads)
    assert set(got) == set(jgrads)
    for k, g in got.items():
        np.testing.assert_allclose(g, np.asarray(jgrads[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    acc = model.accuracy(params, tbatch)
    assert float(acc) == float(jmodel.accuracy(jparams, jbatch))


@pytest.mark.parametrize("name", ["paper-shakespeare", "proxy-lstm"])
def test_lstm_takes_int32_int64_ids_alike(name):
    """``FLRuntime.evaluate`` feeds the dataset's int32 ids, the trainer
    gathers them out of the resident store: both types give one result."""
    model = MODELS[name][0]()
    params = model.init(torch.Generator().manual_seed(3))
    x, _ = _inputs(model, 3, seed=4)
    a = model.predict(params, torch.as_tensor(x))
    b = model.predict(params, torch.as_tensor(x).long())
    assert a.shape == (3, model.vocab) and torch.equal(a, b)


@pytest.mark.parametrize("name", ["paper-shakespeare", "proxy-lstm"])
def test_vmapped_lstm_grads_equal_the_unbatched_ones(name):
    """The trainer takes per-lane grads under ``torch.func.vmap`` with one
    params row a lane: the embedding lookup and the recurrence batch, and
    each lane's grads equal its own unbatched grads."""
    model = MODELS[name][0]()
    lanes = [model.init(torch.Generator().manual_seed(i)) for i in range(3)]
    stacked = {k: torch.stack([p[k] for p in lanes]) for k in lanes[0]}
    xs, ys = zip(*(_inputs(model, 4, seed=10 + i) for i in range(3)))
    x = torch.as_tensor(np.stack(xs))
    y = torch.as_tensor(np.stack(ys)).long()

    def loss(p, xb, yb):
        return model.loss(p, {"x": xb, "y": yb})[0]

    g, l = torch.func.vmap(torch.func.grad_and_value(loss))(stacked, x, y)
    for i, p in enumerate(lanes):
        gi, li = torch.func.grad_and_value(loss)(p, x[i], y[i])
        torch.testing.assert_close(l[i], li, rtol=1e-6, atol=1e-7)
        for k in gi:
            torch.testing.assert_close(g[k][i], gi[k], rtol=1e-6, atol=1e-8,
                                       msg=k)


def test_embed_init_is_a_plain_normal_of_std_0_02():
    """``init="embed"`` draws normal * 0.02 from the factory's generator
    (the reference's: not truncated, unlike ``normal``)."""
    pf = ParamFactory(torch.Generator().manual_seed(0))
    e = pf.param("embed", (400, 500), init="embed")
    assert e.shape == (400, 500) and e.dtype == torch.float32
    assert abs(float(e.std()) - 0.02) < 2e-4
    assert abs(float(e.mean())) < 2e-4
    assert float(e.abs().max()) > 0.08            # tails past 2 std: no cut
    again = ParamFactory(torch.Generator().manual_seed(0)).param(
        "embed", (400, 500), init="embed")
    assert torch.equal(e, again)
    assert float(pf.param("wide", (4, 4), init="embed", scale=1.0).std()) > 0.3


def test_builders_return_every_paper_model_and_proxy_lstm():
    assert set(PAPER_MODELS) == set(jpaper.PAPER_MODELS)
    for name, cls in PAPER_MODELS.items():
        assert isinstance(build_paper_model(name), cls)
        assert isinstance(build_bench_model(name.split("-")[1], "paper"), cls)
    lstm = build_bench_model("shakespeare")
    assert isinstance(lstm, ProxyLSTM)
    assert (lstm.vocab, lstm.seq_len, lstm.hidden) == (82, 20, 64)

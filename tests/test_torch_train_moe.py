"""Training through the mixture of experts on the CPU: the port's
``loss_and_grads`` and ``make_train_step`` against the reference's
``jax.value_and_grad(loss_fn)`` and jitted ``make_train_step``, at both MoE
smoke configs (qwen2-moe-a2.7b: 8 experts, top 2, 2 shared;
qwen3-moe-235b-a22b: 8 experts, top 2, none shared, 8 / 2 heads) under
both of the reference's dispatch lowerings.

The gradient reaches the router through the top k's values (a stable sort
in the port, ``jax.lax.top_k`` in the reference: the same VJP), their
renormalisation and the kept pairs' gates, and through the load-balance
loss's ``mean(probs)``; the experts' choice (``density``) carries none. At
the default capacity factor 1.25 a 32-token sequence gives an expert 10
slots, and the random-weight routers drop pairs (asserted), so the
dropped pairs' zero gradient is held too. The weights are drawn by the
port and carried to the reference by ``convert``; inputs come from numpy
seeds; everything is float32. Every tolerance is stated with its reason.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import model as ref_model
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro_torch import configs, convert
from repro_torch.models import model
from repro_torch.train.optimizer import AdamWConfig

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]
DISPATCHES = ["onehot", "sort"]
# one loss by two float32 paths: the logsumexp over 384 logits and the
# layers' sums rounded in other orders (measured 2.2e-7)
LOSS_TOL = 1e-6
# the load-balance loss a layer (the sum of the layers' is held to
# n_layers of it): the same float32 means in another order, each ~1 (an
# ulp 1.2e-7; measured 4.8e-7 on the sum of 2, about 2 ulps of 2.0)
AUX_TOL = 1e-6
# each gradient relative to its own largest entry, as in
# test_torch_train.py (MKL against XLA; the one-hot lowering's einsums
# against the port's gathers; measured 2.9e-6, on layers.0.moe.w_up)
GRAD_TOL = 1e-5
LR = 1e-3
B, S = 2, 32


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _model(arch, dispatch, tie=False):
    """(reference cfg, port cfg, the reference's params, the port's net):
    the weights drawn by the port and carried across. ``tie`` makes router
    columns 5, 6 and 7 copies of 2, 1 and 0 in every layer, so their
    probabilities tie exactly."""
    cfg_ref = dataclasses.replace(ref_smoke_config(arch), moe_dispatch=dispatch)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), moe_dispatch=dispatch)
    net = model.init_params(0, cfg, device="cpu")
    if tie:
        with torch.no_grad():
            for layer in net.layers:
                layer.moe.router[:, 5:] = layer.moe.router[:, [2, 1, 0]]
    return cfg_ref, cfg, convert.model_params_to_reference(net, cfg), net


def _tokens(cfg, seed, n=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (n, S)).astype(np.int32)


def _value_and_grad(params, tokens, cfg_ref):
    fn = jax.jit(jax.value_and_grad(ref_model.loss_fn, has_aux=True), static_argnums=(2,))
    return fn(params, {"tokens": jnp.asarray(tokens)}, cfg_ref)


def _check_loss_and_grads(cfg_ref, cfg, params, net, tokens):
    (ref_loss, ref_metrics), ref_grads = _value_and_grad(params, tokens, cfg_ref)
    loss, metrics, grads = model.loss_and_grads(net, {"tokens": torch.from_numpy(tokens)}, cfg)
    assert abs(float(loss) - float(ref_loss)) <= LOSS_TOL * abs(float(ref_loss))
    assert float(metrics["ce"]) == pytest.approx(float(ref_metrics["ce"]), rel=LOSS_TOL)
    assert float(ref_metrics["aux"]) > 0
    assert abs(float(metrics["aux"]) - float(ref_metrics["aux"])) <= cfg.n_layers * AUX_TOL
    want = convert.named_from_reference(jax.tree.map(np.asarray, ref_grads), cfg, "cpu")
    assert sorted(want) == sorted(grads)
    assert any(".moe.router" in name for name in grads)
    for name in want:
        assert grads[name].dtype == want[name].dtype, name
        assert _rel_err(grads[name], want[name]) <= GRAD_TOL, name
    return grads


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dispatch):
    """``loss_and_grads``: the loss, its cross entropy and load-balance
    terms, and every parameter's gradient by name against the reference's
    jitted ``jax.value_and_grad(loss_fn)``; the routers drop pairs."""
    cfg_ref, cfg, params, net = _model(arch, dispatch)
    tokens = _tokens(cfg, 1)
    with torch.no_grad():
        x = net.embed[torch.from_numpy(tokens).long()]
        dropped = int((~net.layers[0].moe.route(x).keep).sum())
    assert dropped > 0  # the first layer's router drops pairs of these tokens
    _check_loss_and_grads(cfg_ref, cfg, params, net, tokens)


def test_aux_gradient_reaches_the_router_through_mean_probs():
    """The load-balance term's own gradient: raising ``aux_weight`` from
    0.01 to 1 changes every gradient as it changes the reference's. The
    last layer's expert weights see no change (its one-hot choice carries
    no gradient, its aux reads the router's ``mean(probs)`` alone); its
    router does."""
    cfg_ref, cfg, params, net = _model(ARCHS[0], "sort")
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 2))}
    leaves = dict(net.named_parameters())
    grads = {}
    for w in (0.01, 1.0):
        loss, _ = model.loss_fn(net, batch, cfg, aux_weight=w)
        grads[w] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    fn = jax.jit(jax.grad(lambda p, t, w: ref_model.loss_fn(p, {"tokens": t}, cfg_ref,
                                                             aux_weight=w)[0]))
    ref = {w: convert.named_from_reference(jax.tree.map(np.asarray, fn(
        params, jnp.asarray(batch["tokens"].numpy()), w)), cfg, "cpu") for w in (0.01, 1.0)}
    last = f"layers.{cfg.n_layers - 1}.moe."
    for name in leaves:
        got, want = grads[1.0][name] - grads[0.01][name], ref[1.0][name] - ref[0.01][name]
        # a difference of two gradients: the limit is GRAD_TOL of the
        # larger gradient's max, not of the difference's
        scale = float(ref[1.0][name].abs().max())
        assert float((got - want).abs().max()) <= GRAD_TOL * scale, name
        if name.startswith(last):
            changed = float(got.abs().max()) > 0
            assert changed == (name == last + "router"), name


def test_tied_router_takes_the_lower_expert_and_its_gradient():
    """Router columns made equal give exact ties among the experts'
    probabilities: the port chooses the lower expert, as ``jax.lax.top_k``
    does, and the chosen and the unchosen copy's router columns get the
    reference's (different) gradients."""
    cfg_ref, cfg, params, net = _model(ARCHS[0], "onehot", tie=True)
    tokens = _tokens(cfg, 3)
    with torch.no_grad():
        x = net.embed[torch.from_numpy(tokens).long()]
        route = net.layers[0].moe.route(x)
        probs = torch.softmax(x.float() @ net.layers[0].moe.router, -1)
    assert bool((probs[..., 5] == probs[..., 2]).all())  # the ties are exact
    # where a token takes one of a tied pair it takes the lower; where it
    # takes both, the lower first
    for lo, hi in ((2, 5), (1, 6), (0, 7)):
        has_lo, has_hi = (route.experts == lo).any(-1), (route.experts == hi).any(-1)
        assert not bool((has_hi & ~has_lo).any())
        first = route.experts.tolist()
        assert all(row.index(lo) < row.index(hi) for seq in first for row in seq if hi in row)
    assert bool(((route.experts == 2).any(-1) & ~(route.experts == 5).any(-1)).any())
    grads = _check_loss_and_grads(cfg_ref, cfg, params, net, tokens)
    router = grads["layers.0.moe.router"]
    assert not torch.equal(router[:, 2], router[:, 5])


@pytest.mark.parametrize("arch,dispatch,grad_accum", [
    (ARCHS[0], "onehot", 1), (ARCHS[0], "sort", 2), (ARCHS[1], "sort", 1),
])
def test_train_steps_match_reference(arch, dispatch, grad_accum):
    """2 ``make_train_step`` steps (AdamW at lr 1e-3, clip 1.0, weight decay
    0.01) against the reference's jitted step on the same batches: loss,
    cross entropy, aux and grad norm a step, then every parameter."""
    cfg_ref, cfg, params, net = _model(arch, dispatch)
    ref_opt = RefAdamWConfig(lr=LR, clip_norm=1.0, weight_decay=0.01)
    opt = AdamWConfig(lr=LR, clip_norm=1.0, weight_decay=0.01)
    ref_state = ref_model.init_train_state(params, ref_opt)
    ref_step = jax.jit(ref_model.make_train_step(cfg_ref, ref_opt, grad_accum=grad_accum))
    state = model.init_train_state(net, opt)
    step = model.make_train_step(cfg, opt, grad_accum=grad_accum)
    for i in range(2):
        tokens = _tokens(cfg, 10 + i, n=4)
        ref_state, ref_metrics = ref_step(ref_state, {"tokens": jnp.asarray(tokens)})
        state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
        # the first step starts from the same weights (the limits of
        # test_loss_and_grads_match_reference; the grad norm sums gradients
        # within GRAD_TOL); the second from weights already apart within the
        # band below, which moves the loss and the norm by more
        loss_tol, gnorm_tol = (1e-6, 2e-5) if i == 0 else (1e-5, 1e-4)
        for key, tol in (("loss", loss_tol), ("ce", loss_tol), ("aux", loss_tol),
                         ("grad_norm", gnorm_tol)):
            assert float(metrics[key]) == pytest.approx(float(ref_metrics[key]), rel=tol), (i, key)
        assert int(state["step"]) == int(ref_state["step"]) == i + 1
    got = jax.tree.leaves(convert.model_params_to_reference(net, cfg))
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref_state["params"]))
    # AdamW moves an element by ~lr a step whatever its gradient's size:
    # every element within 2 lr, all but isolated ones within rtol 5e-3,
    # atol 2e-5 (the band and its reasons: test_torch_train.py)
    off = 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 2 * LR
        off += int((np.abs(a - b) > 2e-5 + 5e-3 * np.abs(b)).sum())
    assert off <= 1e-4 * sum(a.size for a in got)

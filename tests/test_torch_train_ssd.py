"""Training through SSD heads on the CPU: the gradient of ``ops.mlstm_chunk``
(the ``MlstmChunk`` Function, whose backward ``ref.mlstm_chunk_bwd`` the card
runs too) against ``jax.grad`` of the reference's cell, then hymba's
``loss_and_grads`` and ``make_train_step`` against the reference's.

Inputs come from numpy seeds; the reference's ``init_params`` draws the
weights and ``convert`` carries them across. Everything is float32, and
every tolerance is stated with its reason.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import ref as jref
from repro.kernels.mlstm_chunk import mlstm_chunk_xla
from repro.models import model as ref_model
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.models import blocks, model
from repro_torch.models.config import BlockKind
from repro_torch.train.optimizer import AdamWConfig

ARCH = "hymba-1.5b"
# one gradient by two float32 paths (MKL and the chunked recurrence against
# XLA), relative to the gradient's largest entry. The cell: measured 4.3e-6
CELL_GRAD_TOL = 1e-5
# the model's gradients, as in test_torch_train.py (measured 7.8e-6 on the
# mixed pattern, 8.5e-6 on hymba's w_B at S 32) ...
GRAD_TOL = 1e-5
# ... except where float32 roundoff of long sums shows: the per-head gate
# vectors (mamba.a_log, mamba.b_dt, each one number a head summed over
# every position and channel) at any S, and every gradient at S 300. Runs
# of both packages with every float32 cast made float64 agree within 4.3e-8
# there, and each float32 side lies up to 1.7e-5 (reference) and 3.1e-5
# (port) from that float64 result: the gap is both sides' roundoff
# (measured against the jitted reference: 3.0e-5 on layers.0.mamba.a_log
# at S 300, 1.3e-5 on layers.1.mamba.a_log at S 32, 1.2e-5 on
# layers.2.mamba.w_B at S 300)
F32_SUM_TOL = 5e-5
LR = 1e-3

# test_torch_models.py's mixed-kind pattern: every block kind the port has,
# a pattern of 5 and a tail layer
_MIXED = dict(block_pattern=(BlockKind.ATTN_LOCAL, BlockKind.MAMBA, BlockKind.HYMBA,
                             BlockKind.HYMBA_LOCAL, BlockKind.ATTN), n_layers=6)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cell_inputs(S, normalize, seed, B=2, H=3, Dk=16, Dv=32):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, S, H, Dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((B, S, H, Dv)).astype(np.float32)
    if normalize:  # xLSTM: input-gate and forget-gate pre-activations
        ig = rng.standard_normal((B, S, H)).astype(np.float32)
        fg = (rng.standard_normal((B, S, H)) + 3.0).astype(np.float32)
    else:  # SSD, as hymba's mamba heads make them: log(dt), -dt
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2.0))
        ig = np.log(dt + 1e-9).astype(np.float32)
        fg = (-dt).astype(np.float32)
    dout = rng.standard_normal((B, S, H, Dv)).astype(np.float32)
    return (q, k, v, ig, fg), dout


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("S", [200, 300])
@pytest.mark.parametrize("normalize", [True, False])
def test_mlstm_chunk_grads_match_reference(normalize, S, chunk):
    """``torch.autograd.grad`` through ``ops.mlstm_chunk`` in all five inputs
    against ``jax.vjp`` of the cell the reference's CPU path differentiates:
    its parallel ``ref.mlstm_chunk`` at S 200, ``mlstm_chunk_xla`` at S 300
    (the port's backward is the chunked form's VJP either way)."""
    xs, dout = _cell_inputs(S, normalize, seed=S + chunk + normalize)
    leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = ops.mlstm_chunk(*leaves, chunk=chunk, normalize=normalize)
    assert out.grad_fn is not None and out.grad_fn.name() == "MlstmChunkBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    if S <= 256:
        fn = lambda *a: jref.mlstm_chunk(*a, normalize=normalize)
    else:
        fn = lambda *a: mlstm_chunk_xla(*a, chunk=chunk, normalize=normalize)
    _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in xs))
    want = vjp(jnp.asarray(dout))
    for name, g, w in zip(("q", "k", "v", "i_gate", "f_gate"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel_err(g, w) <= CELL_GRAD_TOL, name


@pytest.mark.parametrize("S,chunk,mu", [(300, 128, -2.0), (700, 64, -4.0), (1000, 32, -8.0)])
def test_ssd_backward_matches_the_chunked_loop(S, chunk, mu):
    """The SSD backward recomputes the cell with every chunk at once (the
    state recurrence in closed form): its gradients against autograd
    through the loop over chunks that the kernel runs
    (``ref.mlstm_chunk_chunked``), with decays slow enough (dt around
    exp(mu)) that many earlier chunks reach each one. Both lie within 1e-6
    of a float64 run (measured): CELL_GRAD_TOL holds them to each other."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(S)
    (q, k, v, _, _), dout = _cell_inputs(S, False, seed=S)
    dt = np.log1p(np.exp(rng.standard_normal(q.shape[:3]) + mu))
    xs = [torch.from_numpy(a) for a in (q, k, v, np.log(dt + 1e-9).astype(np.float32),
                                        (-dt).astype(np.float32))]
    d = torch.from_numpy(dout)
    leaves = [x.clone().requires_grad_() for x in xs]
    want = torch.autograd.grad(
        ref.mlstm_chunk_chunked(*leaves, chunk=chunk, normalize=False), leaves, d)
    got = ref.mlstm_chunk_bwd(*xs, d, chunk=chunk, normalize=False)
    for name, g, w in zip(("q", "k", "v", "i_gate", "f_gate"), got, want):
        assert _rel_err(g, w) <= CELL_GRAD_TOL, name


def test_mlstm_chunk_saves_nothing_without_grad():
    """Without an input that requires grad (or under ``torch.no_grad()``)
    the Function records no graph; the values are the forward's either way."""
    xs, _ = _cell_inputs(40, False, seed=1)
    ts = [torch.from_numpy(x) for x in xs]
    plain = ops.mlstm_chunk(*ts, normalize=False)
    assert plain.grad_fn is None and not plain.requires_grad
    with torch.no_grad():
        none = ops.mlstm_chunk(*(t.clone().requires_grad_() for t in ts), normalize=False)
    assert none.grad_fn is None
    graph = ops.mlstm_chunk(ts[0], ts[1], ts[2].clone().requires_grad_(), ts[3], ts[4],
                            normalize=False)
    assert torch.equal(plain, none) and torch.equal(plain, graph.detach())


def _configs(arch):
    if arch == "mixed":
        return (dataclasses.replace(ref_smoke_config(ARCH), **_MIXED),
                dataclasses.replace(configs.get_smoke_config(ARCH), **_MIXED))
    return ref_smoke_config(arch), configs.get_smoke_config(arch)


def _reference_model(arch=ARCH, seed=0):
    cfg_ref, cfg = _configs(arch)
    params = ref_model.init_params(jax.random.PRNGKey(seed), cfg_ref)
    net = convert.model_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg_ref, cfg, params, net


def _grad_tol(name: str, S: int) -> float:
    gate = name.endswith(("mamba.a_log", "mamba.b_dt"))
    return F32_SUM_TOL if gate or S > 256 else GRAD_TOL


@pytest.mark.parametrize("arch,S", [(ARCH, 32), (ARCH, 300), ("mixed", 32)])
def test_loss_and_grads_match_reference(arch, S):
    """``loss_and_grads`` against the reference's
    ``jax.value_and_grad(loss_fn)``, jitted (its CPU path: the parallel cell
    up to S 256, ``mlstm_chunk_xla`` above), every parameter by name."""
    cfg_ref, cfg, params, net = _reference_model(arch)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    value_and_grad = jax.jit(jax.value_and_grad(ref_model.loss_fn, has_aux=True),
                             static_argnums=(2,))
    (ref_loss, _), ref_grads = value_and_grad(params, {"tokens": jnp.asarray(tokens)}, cfg_ref)
    loss, _, grads = model.loss_and_grads(net, {"tokens": torch.from_numpy(tokens)}, cfg)
    # one loss by two float32 paths: rounding of the logsumexp over 384
    # logits and of the layers' sums (measured 1.5e-7)
    assert abs(float(loss) - float(ref_loss)) <= 1e-6 * abs(float(ref_loss))
    want = convert.named_from_reference(jax.tree.map(np.asarray, ref_grads), cfg, "cpu")
    assert sorted(want) == sorted(grads)
    assert any(".mamba." in name for name in grads)
    for name in want:
        assert grads[name].dtype == want[name].dtype, name
        assert _rel_err(grads[name], want[name]) <= _grad_tol(name, S), name


def test_train_steps_match_reference():
    """3 ``make_train_step`` steps on hymba's smoke config (AdamW at lr
    1e-3, clip 1.0, weight decay 0.01) against the reference's jitted step
    on the same batches, in the band of test_torch_train.py's
    ``test_train_steps_match_reference``."""
    cfg_ref, cfg, params, net = _reference_model()
    ref_opt = RefAdamWConfig(lr=LR, clip_norm=1.0, weight_decay=0.01)
    opt = AdamWConfig(lr=LR, clip_norm=1.0, weight_decay=0.01)
    ref_state = ref_model.init_train_state(params, ref_opt)
    ref_step = jax.jit(ref_model.make_train_step(cfg_ref, ref_opt))
    state = model.init_train_state(net, opt)
    step = model.make_train_step(cfg, opt)
    rng = np.random.default_rng(2)
    for i in range(3):
        tokens = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
        ref_state, ref_metrics = ref_step(ref_state, {"tokens": jnp.asarray(tokens)})
        state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
        # the first step starts from the same weights: loss and grad norm as
        # in test_torch_train.py. The weights entering a later step already
        # differ within the band below (a few elements up to 2 lr apart), and
        # hymba's loss feels that: measured 2.4e-6 (loss) and 4.3e-5 (grad
        # norm) at steps 2-3, while the reference's loss_fn at the port's
        # weights after step 1 gives the port's step-2 loss (6.427701 both)
        loss_tol, gnorm_tol = (1e-6, 2e-5) if i == 0 else (1e-5, 1e-4)
        assert float(metrics["loss"]) == pytest.approx(
            float(ref_metrics["loss"]), rel=loss_tol), i
        assert float(metrics["grad_norm"]) == pytest.approx(
            float(ref_metrics["grad_norm"]), rel=gnorm_tol), i
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


def test_training_forward_computes_no_state(monkeypatch):
    """The training forward no longer computes the SSD state at the
    sequence's end; its loss and gradients are bitwise those of a forward
    that still computes it (and throws it away), at S 300 past the chunk."""
    _, cfg, _, net = _reference_model()
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 300)).astype(np.int32))
    calls = []
    state_fn = blocks.final_linear_state
    monkeypatch.setattr(blocks, "final_linear_state",
                        lambda *a, **kw: calls.append(1) or state_fn(*a, **kw))
    # the embedding's backward (an accumulating index_put_) adds its rows in
    # no fixed order on the CPU past a few hundred tokens unless told to
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        loss, _, grads = model.loss_and_grads(net, {"tokens": tokens}, cfg)
        assert not calls
        monkeypatch.setattr(blocks.Mamba, "forward", lambda self, x: self.prefill(x)[0])
        loss2, _, grads2 = model.loss_and_grads(net, {"tokens": tokens}, cfg)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    assert len(calls) == 2 * cfg.n_layers  # the forward and its remat replay
    assert float(loss) == float(loss2)
    for name in grads:
        assert torch.equal(grads[name], grads2[name]), name

"""The port's training path against the reference's, on the CPU: the plain
flash-attention backward, autograd through ``ops.flash_attention``,
``loss_fn`` and its gradients, and ``make_train_step`` over gradient
accumulation and compression.

The reference's ``init_params`` draws the weights; ``convert`` carries them
across (and the reference's gradients back by parameter name), so both
packages compute the same model. Inputs come from numpy seeds. Everything is
float32, and every tolerance below is stated with its reason.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import _flash_fwd, flash_attention_bwd_pallas
from repro.models import model as ref_model
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro_torch import configs, convert
from repro_torch.kernels import ops, ref
from repro_torch.models import model
from repro_torch.train.optimizer import AdamWConfig

ARCH = "tinyllama-1.1b"
# gradients of one function by two float32 paths (other summation orders:
# MKL against XLA, the Pallas kernels' blocks against whole products),
# relative to the largest entry of each gradient; measured ~2e-6
GRAD_TOL = 1e-5
LR = 1e-3


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# the reference test's cases (tests/test_kernels.py, the backward kernels
# against autodiff: GQA, a window, a q_offset), plus a tile with dead and
# live rows (window 8, q_offset 10) and one whose every row is dead
FLASH_CASES = [
    (1, 64, 64, 4, 2, 32, None, 0),
    (2, 100, 100, 2, 2, 64, None, 0),
    (1, 96, 96, 4, 1, 48, 32, 0),
    (1, 64, 128, 2, 2, 32, None, 64),
    (1, 30, 20, 2, 2, 16, 8, 10),
    (1, 30, 20, 2, 2, 16, 4, 40),
]


def _flash_inputs(B, Sq, Skv, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    dout = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bwd_matches_reference_kernels(case):
    """``ref.flash_attention_bwd`` against the reference's Pallas backward
    kernels (interpret mode, 32 x 32 blocks) and against ``jax.vjp`` of the
    reference's quadratic attention."""
    B, Sq, Skv, Hq, Hkv, D, window, off = case
    q, k, v, dout = _flash_inputs(B, Sq, Skv, Hq, Hkv, D, seed=Sq + Skv)
    kw = dict(causal=True, window=window, q_offset=off)
    t = lambda a: torch.from_numpy(a)
    out, lse = ref.flash_attention(t(q), t(k), t(v), **kw)
    got = ref.flash_attention_bwd(t(q), t(k), t(v), out, lse, t(dout), **kw)

    jout, jlse = _flash_fwd(q, k, v, scale=None, interpret=True, blk_q=32, blk_k=32, **kw)
    pallas = flash_attention_bwd_pallas(q, k, v, jout, jlse, dout, interpret=True,
                                        blk_q=32, blk_k=32, **kw)
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention(a, b, c, **kw), q, k, v)
    autodiff = vjp(jnp.asarray(dout))
    for name, g, p, a in zip("qkv", got, pallas, autodiff):
        assert g.shape == p.shape == a.shape, name
        assert np.array_equal(np.isinf(np.asarray(lse)), np.isinf(np.asarray(jlse)))
        if not np.abs(np.asarray(a)).max():  # every row dead: exactly 0
            assert not g.abs().max() and not np.abs(np.asarray(p)).max(), name
            continue
        assert _rel_err(g, p) <= GRAD_TOL, name
        assert _rel_err(g, a) <= GRAD_TOL, name


@pytest.mark.parametrize("case", FLASH_CASES[:5])
def test_flash_autograd_function_matches_plain_autograd(case):
    """``torch.autograd.grad`` through ``ops.flash_attention`` (the
    ``FlashAttention`` Function, whose CPU backward is
    ``ref.flash_attention_bwd``) against autograd of the plain quadratic
    form; ``lse`` carries no gradient."""
    B, Sq, Skv, Hq, Hkv, D, window, off = case
    kw = dict(causal=True, window=window, q_offset=off)
    q, k, v, dout = (torch.from_numpy(a) for a in _flash_inputs(B, Sq, Skv, Hq, Hkv, D, 3))
    grads = []
    for fn in (ops.flash_attention, ref.flash_attention):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out, lse = fn(*leaves, **kw)
        assert out.requires_grad
        grads.append(torch.autograd.grad(out, leaves, dout))
    out, lse = ops.flash_attention(*(x.clone().requires_grad_() for x in (q, k, v)), **kw)
    assert out.grad_fn is not None and not lse.requires_grad
    for name, got, want in zip("qkv", *grads):
        assert _rel_err(got, want) <= GRAD_TOL, name


def test_flash_bwd_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper takes CUDA tensors only: a CPU tensor reaches the
    plain version through ``ops``, never the kernel."""
    from repro_torch.kernels import flash_attention

    q, k, v, dout = (torch.from_numpy(a) for a in _flash_inputs(1, 8, 8, 2, 1, 16, 0))
    out, lse = ref.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        flash_attention.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        flash_attention.flash_attention_bwd_dkv_cuda(q, k, v, lse, lse, dout)


def _reference_model(seed: int = 0):
    cfg_ref, cfg = ref_smoke_config(ARCH), configs.get_smoke_config(ARCH)
    params = ref_model.init_params(jax.random.PRNGKey(seed), cfg_ref)
    net = convert.model_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg_ref, cfg, params, net


@pytest.mark.parametrize("backend", [None, "pallas_interpret"])
def test_loss_and_grads_match_reference(backend):
    """``loss_fn`` and the gradient of every parameter against the
    reference's ``jax.value_and_grad(loss_fn)``; with ``pallas_interpret``
    the reference runs its Pallas forward and both backward kernels."""
    cfg_ref, cfg, params, net = _reference_model()
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(ref_model.loss_fn, has_aux=True)(
        params, {"tokens": jnp.asarray(tokens)}, cfg_ref, backend=backend)
    loss, metrics, grads = model.loss_and_grads(net, {"tokens": torch.from_numpy(tokens)}, cfg)
    # one loss by two float32 paths: rounding of the logsumexp over 384 logits
    assert abs(float(loss) - float(ref_loss)) <= 1e-6 * abs(float(ref_loss))
    assert float(metrics["ce"]) == pytest.approx(float(ref_metrics["ce"]), rel=1e-6)
    assert float(metrics["aux"]) == float(ref_metrics["aux"]) == 0.0
    want = convert.named_from_reference(jax.tree.map(np.asarray, ref_grads), cfg, "cpu")
    assert sorted(want) == sorted(grads)
    for name in want:
        assert grads[name].dtype == want[name].dtype, name
        assert _rel_err(grads[name], want[name]) <= GRAD_TOL, name
    with torch.no_grad():  # the same loss through loss_fn without a graph
        plain, _ = model.loss_fn(net, {"tokens": torch.from_numpy(tokens)}, cfg)
    assert float(plain) == float(loss)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("compress", [False, True])
def test_train_steps_match_reference(grad_accum, compress):
    """3 ``make_train_step`` steps (AdamW at lr 1e-3, clip 1.0, weight decay
    0.01) against the reference's jitted step on the same batches: loss and
    grad norm per step, then every parameter."""
    cfg_ref, cfg, params, net = _reference_model()
    ref_opt = RefAdamWConfig(lr=LR, clip_norm=1.0, weight_decay=0.01)
    opt = AdamWConfig(lr=LR, clip_norm=1.0, weight_decay=0.01)
    ref_state = ref_model.init_train_state(params, ref_opt)
    ref_step = jax.jit(ref_model.make_train_step(
        cfg_ref, ref_opt, grad_accum=grad_accum, compress=compress))
    state = model.init_train_state(net, opt)
    step = model.make_train_step(cfg, opt, grad_accum=grad_accum, compress=compress)
    rng = np.random.default_rng(2)
    for i in range(3):
        tokens = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
        ref_state, ref_metrics = ref_step(ref_state, {"tokens": jnp.asarray(tokens)})
        state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
        # loss: as in test_loss_and_grads_match_reference; grad norm: the
        # norm of gradients within GRAD_TOL, and under compression their bf16
        # rounding, which may fall one bf16 step apart on an element (measured
        # 4.5e-6)
        assert float(metrics["loss"]) == pytest.approx(float(ref_metrics["loss"]), rel=1e-6), i
        assert float(metrics["grad_norm"]) == pytest.approx(
            float(ref_metrics["grad_norm"]), rel=2e-5), i
        assert int(state["step"]) == int(ref_state["step"]) == i + 1
    assert state["params"] is net
    assert ("grad_error" in state) == compress
    got = jax.tree.leaves(convert.model_params_to_reference(net, cfg))
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref_state["params"]))
    # AdamW moves an element by ~lr a step whatever its gradient's size, so
    # where a gradient is within its float32 noise of 0 the two sides can step
    # apart by up to ~2 lr: every element within 2 lr, and all but isolated
    # ones (1 in 309,408 measured) within the reference's own grad-accum test
    # band (rtol 5e-3, atol 2e-5, tests/test_models_smoke.py)
    off = 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 2 * LR
        off += int((np.abs(a - b) > 2e-5 + 5e-3 * np.abs(b)).sum())
    assert off <= 1e-4 * sum(a.size for a in got)


def test_train_step_refuses_ssd_heads():
    """hymba's SSD heads run the mLSTM kernel, which has no backward: no
    train step, on the CPU as on the card."""
    cfg = configs.get_smoke_config("hymba-1.5b")
    with pytest.raises(NotImplementedError, match="ROADMAP A.12"):
        model.make_train_step(cfg, AdamWConfig())


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hymba-1.5b"])
def test_serving_records_no_graph(arch):
    """Every parameter requires grad, yet prefill and decode return outputs
    and caches outside any autograd graph."""
    cfg = configs.get_smoke_config(arch)
    net = model.init_params(0, cfg, device="cpu")
    assert all(p.requires_grad for p in net.parameters())
    cache = model.init_cache(cfg, 2, 48, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(0))
    logits, cache = model.make_prefill_step(cfg)(net, cache, {"tokens": tokens})
    logits2, cache = model.make_serve_step(cfg)(net, cache, logits.argmax(-1))
    for t in (logits, logits2, *jax.tree.leaves(cache["layers"])):
        assert not t.requires_grad and t.grad_fn is None


def test_remat_gives_the_same_gradients():
    """``cfg.remat`` (per-layer ``torch.utils.checkpoint``) recomputes the
    forward in the backward and changes no gradient: bitwise on the CPU."""
    _, cfg, _, net = _reference_model()
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 32)))
    assert cfg.remat
    loss, _, grads = model.loss_and_grads(net, {"tokens": tokens}, cfg)
    loss2, _, grads2 = model.loss_and_grads(
        net, {"tokens": tokens}, dataclasses.replace(cfg, remat=False))
    assert float(loss) == float(loss2)
    for name in grads:
        assert torch.equal(grads[name], grads2[name]), name

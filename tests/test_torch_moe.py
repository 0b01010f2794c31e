"""The port's mixture of experts (``blocks.MoE``) and the MoE stack against
the reference's ``moe_forward`` and serving path, on the CPU.

Both MoE architectures' smoke configs (qwen2-moe-a2.7b: 8 experts, top 2,
2 shared experts; qwen3-moe-235b-a22b: 8 experts, top 2, none shared, 8 / 2
heads), float32, the same weights on both sides (drawn by the port from a
seed and carried to the reference's layout by ``convert``, which also
carries them back). The block's output within 1e-5 of max|reference| and
its load-balance ``aux`` within 1e-6, under both of the reference's
dispatch lowerings ("onehot" and "sort", which drop the same pairs), at a
capacity factor of 0.5, where the test asserts that pairs were dropped (the
model runs the default 1.25); a decode step's ``[B, 1, d]`` takes capacity
1 and drops nothing; the
router's exact ties broken as ``jax.lax.top_k`` breaks them (the lower
expert first). In bf16 the port sums a token's k weighted expert outputs
in float32 and rounds once, as the one-hot combine does (the sort lowering
adds them in bf16); the two packages also round the experts' and the
shared experts' activations to bf16 at other places, and that dominates:
both lie 0.0064-0.0070 of max|output| from a float32 run on the same bf16
values, 0.0086 from each other under either lowering. The bf16 limit is
four bf16 steps at the max's binade, 2^-6 of max|reference|, against each.
The model: ``forward``'s ``(logits, aux)``, a 40-token prefill and 8
decode steps within 1e-4 of max|logits|, every cache leaf within 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro.models import transformer as ref_transformer
from repro_torch import configs, convert
from repro_torch.models import blocks, model, transformer

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]
B, S, MAX_LEN, STEPS = 2, 40, 64, 8
BLOCK_TOL, AUX_TOL, MODEL_TOL = 1e-5, 1e-6, 1e-4
BF16_TOL = 2.0 ** -6


def _configs(arch, **kw):
    return (dataclasses.replace(ref_smoke_config(arch), **kw),
            dataclasses.replace(configs.get_smoke_config(arch), **kw))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _moe(arch, seed=0, **kw):
    """(reference cfg, the MoE's weights as the reference's numpy tree, the
    port's MoE holding them)."""
    cfg_ref, cfg = _configs(arch, **kw)
    moe = blocks.MoE(cfg, torch.Generator().manual_seed(seed), "cpu")
    params = {}
    for name, p in moe.named_parameters():
        *head, leaf = name.split(".")
        node = params
        for key in head:
            node = node.setdefault(key, {})
        value = p.detach().to(torch.float32).numpy()
        node[leaf] = value if p.dtype == torch.float32 else jnp.asarray(value, jnp.bfloat16)
    return cfg_ref, params, moe


def _ref_moe(params, x, cfg_ref):
    return jax.jit(ref_blocks.moe_forward, static_argnums=2)(params, x, cfg_ref)


def _x(cfg, seed=1, n=S):
    return np.random.default_rng(seed).standard_normal((B, n, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, dispatch):
    cfg_ref, params, moe = _moe(arch, moe_dispatch=dispatch, moe_capacity_factor=0.5)
    x = _x(cfg_ref)
    want, want_aux = _ref_moe(params, jnp.asarray(x), cfg_ref)
    with torch.no_grad():
        got, aux = moe(torch.from_numpy(x))
        route = moe.route(torch.from_numpy(x))
        step = moe.route(torch.from_numpy(x[:, :1]))
    assert route.capacity == int(max(1, round(S * cfg_ref.n_experts_active * 0.5
                                             / cfg_ref.n_experts))) == 5
    assert int((~route.keep).sum()) > 0  # pairs were dropped
    assert step.capacity == 1 and bool(step.keep.all())  # a decode step's token
    assert aux.dtype == torch.float32 and abs(float(aux) - float(want_aux)) <= AUX_TOL
    assert _rel(got, want) <= BLOCK_TOL


def test_tied_router_rows_take_the_lower_expert():
    """Router columns made equal give exact ties among the experts' scores;
    the port picks the same experts, in the same order, as
    ``jax.lax.top_k`` (the lower index first) and so the same output."""
    cfg_ref, params, moe = _moe(ARCHS[0])
    router = params["router"].copy()
    router[:, 5] = router[:, 2]
    router[:, 6] = router[:, 1]
    router[:, 7] = router[:, 0]
    params = dict(params, router=router)
    with torch.no_grad():
        moe.router.copy_(torch.from_numpy(router))
    x = _x(cfg_ref, seed=3)
    _, want_idx, _, _ = ref_blocks._moe_route(params, jnp.asarray(x), cfg_ref)
    want, _ = _ref_moe(params, jnp.asarray(x), cfg_ref)
    with torch.no_grad():
        route = moe.route(torch.from_numpy(x))
        got, _ = moe(torch.from_numpy(x))
    probs = torch.softmax(torch.from_numpy(x) @ moe.router, -1)
    assert bool((probs[..., 5] == probs[..., 2]).all())  # the ties are exact
    assert np.array_equal(route.experts.numpy(), np.asarray(want_idx))
    assert _rel(got, want) <= BLOCK_TOL


@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_bf16_moe_block_within_a_rounding_of_reference(dispatch):
    cfg_ref, params, moe = _moe(ARCHS[0], moe_dispatch=dispatch, moe_capacity_factor=0.5,
                                dtype="bfloat16")
    x = _x(cfg_ref, seed=4)
    want, _ = _ref_moe(params, jnp.asarray(x, jnp.bfloat16), cfg_ref)
    with torch.no_grad():
        got, _ = moe(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), np.asarray(want, np.float32)) <= BF16_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_matches_reference(arch):
    """``forward``'s (logits, aux), a prefill over 40 tokens and 8 decode
    steps against the reference's; the MoE leaves through ``convert`` both
    ways, in the reference's tree and back bitwise."""
    cfg_ref, cfg = _configs(arch)
    assert cfg_ref.param_count() == cfg.param_count()
    seeded = model.init_params(0, cfg, device="cpu")
    params = convert.model_params_to_reference(seeded, cfg)
    shapes = jax.eval_shape(lambda: ref_model.init_params(jax.random.PRNGKey(0), cfg_ref))
    assert jax.tree.structure(params) == jax.tree.structure(shapes)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(shapes)))
    assert params["decoder"]["units"]["b0"]["moe"]["router"].shape == (
        cfg.n_units, cfg.d_model, cfg.n_experts)
    net = convert.model_params_from_reference(params, cfg, device="cpu")
    assert net.layers[0].moe.router.dtype == torch.float32
    for (name, a), b in zip(seeded.named_parameters(), net.parameters()):
        assert torch.equal(a, b), name
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)

    want, want_aux = jax.jit(lambda p, t: ref_transformer.forward(p, {"tokens": t}, cfg_ref))(
        params, jnp.asarray(tokens[:, :S]))
    with torch.no_grad():
        got, aux = transformer.forward(net, {"tokens": torch.from_numpy(tokens[:, :S]).long()}, cfg)
    assert _rel(got, want) <= MODEL_TOL
    assert float(want_aux) > 0 and abs(float(aux) - float(want_aux)) <= cfg.n_layers * AUX_TOL

    ref_cache = ref_model.init_cache(cfg_ref, B, MAX_LEN)
    ref_logits, ref_cache = jax.jit(ref_model.make_prefill_step(cfg_ref))(
        params, ref_cache, {"tokens": jnp.asarray(tokens[:, :S])})
    cache = model.init_cache(cfg, B, MAX_LEN, device="cpu")
    logits, cache = model.make_prefill_step(cfg)(
        net, cache, {"tokens": torch.from_numpy(tokens[:, :S]).long()})
    assert _rel(logits, ref_logits) <= MODEL_TOL
    ours, theirs = convert.cache_to_reference(cache, cfg), jax.tree.map(np.asarray, ref_cache)
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert a.shape == b.shape and np.abs(a - b).max() <= MODEL_TOL * max(1.0, np.abs(b).max())
    ref_step, step = jax.jit(ref_model.make_serve_step(cfg_ref)), model.make_serve_step(cfg)
    for i in range(STEPS):
        ref_logits, ref_cache = ref_step(params, ref_cache, jnp.asarray(tokens[:, S + i]))
        logits, cache = step(net, cache, torch.from_numpy(tokens[:, S + i]).long())
        assert _rel(logits, ref_logits) <= MODEL_TOL, i

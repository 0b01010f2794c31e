"""The port's serving path (``init_params`` -> ``init_cache`` ->
``make_prefill_step`` -> ``make_serve_step``) against the reference's, on
the CPU.

The reference's ``init_params`` draws the weights; ``convert`` carries them
(and caches) across, so both packages compute the same model. Prompts of 40
tokens (past the smoke configs' 32-slot window, so the local layers' ring
wraps) go through both prefills, then 12 tokens through both decode steps.
Everything is float32: last-position and per-step logits within 1e-4, every
cache tensor within 1e-4 (the same products, summed in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import model as ref_model
from repro_torch import configs, convert
from repro_torch.models import model
from repro_torch.models.config import BlockKind

ATOL = 1e-4
B, S, MAX_LEN, STEPS = 2, 40, 64, 12

# every block kind the port runs: global and sliding-window attention, SSD
# heads alone, and hymba's pair in both forms
_MIXED = dict(block_pattern=(BlockKind.ATTN_LOCAL, BlockKind.MAMBA, BlockKind.HYMBA,
                             BlockKind.HYMBA_LOCAL, BlockKind.ATTN), n_layers=6)


def _configs(arch):
    if arch == "mixed":
        return (dataclasses.replace(ref_smoke_config("hymba-1.5b"), **_MIXED),
                dataclasses.replace(configs.get_smoke_config("hymba-1.5b"), **_MIXED))
    return ref_smoke_config(arch), configs.get_smoke_config(arch)


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("arch", ["hymba-1.5b", "tinyllama-1.1b", "mixed"])
def test_serving_path_matches_reference(arch):
    cfg_ref, cfg = _configs(arch)
    assert cfg_ref.param_count() == cfg.param_count()
    params = ref_model.init_params(jax.random.PRNGKey(0), cfg_ref)
    net = convert.model_params_from_reference(jax.tree.map(np.asarray, params), cfg, device="cpu")
    assert sum(p.numel() for p in net.parameters()) == sum(
        np.asarray(a).size for a in jax.tree.leaves(params))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)

    ref_cache = ref_model.init_cache(cfg_ref, B, MAX_LEN)
    ref_logits, ref_cache = ref_model.make_prefill_step(cfg_ref)(
        params, ref_cache, {"tokens": jnp.asarray(tokens[:, :S])})
    cache = model.init_cache(cfg, B, MAX_LEN, device="cpu")
    logits, cache = model.make_prefill_step(cfg)(
        net, cache, {"tokens": torch.from_numpy(tokens[:, :S]).long()})
    assert logits.shape == (B, cfg.vocab_size)
    assert _max_err(logits, ref_logits) <= ATOL
    assert cache["pos"] == int(ref_cache["pos"]) == S
    ours = convert.cache_to_reference(cache, cfg)
    theirs = jax.tree.map(np.asarray, ref_cache)
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours), jax.tree.leaves(theirs)):
        assert a.shape == b.shape, path
        assert _max_err(a, b) <= ATOL, path

    ref_step, step = ref_model.make_serve_step(cfg_ref), model.make_serve_step(cfg)
    for i in range(STEPS):
        ref_logits, ref_cache = ref_step(params, ref_cache, jnp.asarray(tokens[:, S + i]))
        logits, cache = step(net, cache, torch.from_numpy(tokens[:, S + i]).long())
        assert _max_err(logits, ref_logits) <= ATOL, i
    assert cache["pos"] == S + STEPS


def test_cache_conversion_round_trips():
    cfg_ref, cfg = _configs("hymba-1.5b")
    params = ref_model.init_params(jax.random.PRNGKey(3), cfg_ref)
    cache = ref_model.init_cache(cfg_ref, B, MAX_LEN)
    tokens = jnp.asarray(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)), jnp.int32)
    _, cache = ref_model.make_prefill_step(cfg_ref)(params, cache, {"tokens": tokens})
    cache = jax.tree.map(np.asarray, cache)
    back = convert.cache_to_reference(convert.cache_from_reference(cache, cfg, "cpu"), cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(cache)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mixed"])
def test_decode_continues_prefill(arch):
    """Prefill over S + 1 tokens gives the logits of prefill over S then one
    decode step (the port's own consistency check, which the card repeats
    in bf16 at full width), before and after the ring wraps."""
    _, cfg = _configs(arch)
    net = model.init_params(0, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, 2 * S), generator=torch.Generator().manual_seed(4))
    prefill, step = model.make_prefill_step(cfg), model.make_serve_step(cfg)
    for n in (20, S):  # before (20 < window 32) and after the ring wraps
        full, _ = prefill(net, model.init_cache(cfg, B, MAX_LEN, device="cpu"),
                          {"tokens": tokens[:, :n + 1]})
        cache = model.init_cache(cfg, B, MAX_LEN, device="cpu")
        _, cache = prefill(net, cache, {"tokens": tokens[:, :n]})
        stepped, cache = step(net, cache, tokens[:, n])
        assert _max_err(stepped, full) <= ATOL


def test_bf16_serving_runs_in_bf16():
    cfg = dataclasses.replace(configs.get_smoke_config("hymba-1.5b"), dtype="bfloat16")
    net = model.init_params(0, cfg, device="cpu")
    assert net.embed.dtype == torch.bfloat16 and net.layers[0].norm1.dtype == torch.float32
    cache = model.init_cache(cfg, B, MAX_LEN, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(5))
    logits, cache = model.make_prefill_step(cfg)(net, cache, {"tokens": tokens})
    logits2, cache = model.make_serve_step(cfg)(net, cache, logits.argmax(-1))
    assert logits.dtype == logits2.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits2.float()).all())
    assert cache["layers"][0]["kv"]["k"].dtype == torch.bfloat16
    assert cache["layers"][0]["ssm"]["C"].dtype == torch.float32


def test_entry_points_want_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke_config("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(0, cfg, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.model_params_from_reference({}, cfg)
    assert model.init_params(0, cfg, device="cpu").embed.device.type == "cpu"
    with pytest.raises(TypeError):  # a seed, never a generator that brings its own device
        model.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")


@pytest.mark.parametrize("kind", [BlockKind.MOE, BlockKind.MLSTM, BlockKind.SLSTM])
def test_unported_block_kinds_raise(kind):
    cfg = dataclasses.replace(configs.get_smoke_config("tinyllama-1.1b"),
                              block_pattern=(kind,), n_experts=4, n_experts_active=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A.12"):
        model.init_params(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A.12"):
        model.init_cache(cfg, 1, 8, device="cpu")


def test_configs_carry_the_published_widths():
    cfg = configs.get_config("hymba-1.5b")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size,
            cfg.ssm_state, cfg.window, cfg.n_layers) == (1600, 25, 5, 64, 5504, 32001, 16, 1024, 32)
    assert cfg.layer_kinds.count(BlockKind.HYMBA) == 4
    assert 1.6e9 < cfg.param_count() < 1.7e9
    assert cfg.param_count() == ref_smoke_config("hymba-1.5b").scaled(
        **{f: getattr(cfg, f) for f in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                                        "head_dim", "d_ff", "vocab_size", "ssm_state",
                                        "window")}).param_count()
    assert sorted(configs.list_archs()) == ["hymba-1.5b", "tinyllama-1.1b"]
    with pytest.raises(KeyError):
        configs.get_config("xlstm-350m")


def test_blocks_match_reference_blocks():
    """Each block's full-sequence forward (attention with RoPE, the SSD
    heads, the MLP) against the reference's ``repro.models.blocks``."""
    from repro.models import blocks as ref_blocks
    from repro.models.common import rope as ref_rope

    cfg_ref, cfg = _configs("hymba-1.5b")
    params = jax.tree.map(np.asarray, ref_model.init_params(jax.random.PRNGKey(5), cfg_ref))
    net = convert.model_params_from_reference(params, cfg, device="cpu")
    unit = jax.tree.map(lambda a: a[0], params["decoder"]["units"])["b1"]  # a local layer
    layer = net.layers[1]
    x = np.random.default_rng(6).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    xt = torch.from_numpy(x)
    tables = net.rope_tables(torch.arange(S))
    with torch.no_grad():  # the parameters are trainable; compare values only
        got, _, _ = layer.attn(xt, tables[False], window=cfg.window)
        got_mamba, got_mlp = layer.mamba(xt)[0], layer.mlp(xt)
    want = ref_blocks.attention_forward(unit["attn"], x, cfg_ref, positions=pos, window=cfg.window)
    assert _max_err(got, want) <= ATOL
    cos, sin = ref_rope(jnp.asarray(pos), cfg.hd, cfg.rope_theta)
    assert _max_err(tables[False][0], cos[0]) <= 1e-6 and _max_err(tables[False][1], sin[0]) <= 1e-6
    assert _max_err(got_mamba, ref_blocks.mamba_forward(unit["mamba"], x, cfg_ref)) <= ATOL
    assert _max_err(got_mlp, ref_blocks.mlp_forward(unit["mlp"], x)) <= ATOL


@pytest.mark.parametrize("normalize", [True, False])
def test_linear_cell_step_matches_reference(normalize):
    from repro.models import blocks as ref_blocks
    from repro_torch.models import blocks

    rng = np.random.default_rng(7)
    Bc, H, Dk, Dv = 3, 4, 8, 12
    q, k = (rng.standard_normal((Bc, H, Dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((Bc, H, Dv)).astype(np.float32)
    li, lf = (rng.standard_normal((Bc, H)).astype(np.float32) for _ in range(2))
    cache = {"C": rng.standard_normal((Bc, H, Dk, Dv)).astype(np.float32),
             "n": rng.standard_normal((Bc, H, Dk)).astype(np.float32),
             "m": rng.standard_normal((Bc, H)).astype(np.float32) if normalize
             else np.zeros((Bc, H), np.float32)}
    out, new = blocks.linear_cell_step(
        *(torch.from_numpy(a) for a in (q, k, v, li, lf)),
        {n: torch.from_numpy(a) for n, a in cache.items()}, normalize=normalize)
    ref_out, ref_new = ref_blocks._linear_cell_step(q, k, v, li, lf, cache, normalize=normalize)
    assert _max_err(out, ref_out) <= ATOL
    for n in ("C", "n", "m"):
        assert _max_err(new[n], ref_new[n]) <= ATOL

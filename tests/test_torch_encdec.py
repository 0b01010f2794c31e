"""The encoder-decoder stack (seamless-m4t-large-v2) and the vision frontend
(internvl2-2b) of the port against the reference, on the CPU.

The reference's ``init_params`` draws the weights at the smoke configs;
``convert`` carries them (and caches) across, so both packages compute the
same model on the same numpy inputs from a seed: prompt tokens and the
frontend's embeddings (seamless's speech frames, fed to its encoder;
internvl2's image embeddings, prepended to the prompt). Everything is
float32: the full-sequence logits, the prefill's last-position logits,
every cache tensor (``cross_kv``, the encoder output's keys and values, too)
and 12 decode steps' logits within 1e-4 (the same products, summed in
another order). A vision prompt shorter than ``frontend_tokens + 8`` shows
the reference's truncation (the prompt's last ``frontend_tokens`` tokens
drop out), and a decode step straight after ``init_cache`` attends over
the cache's zero cross keys, as the reference's does."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import model as ref_model
from repro.models import transformer as ref_transformer
from repro_torch import configs, convert
from repro_torch.models import model
from repro_torch.models import transformer as T

ATOL = 1e-4
B, S, MAX_LEN, STEPS = 2, 40, 64, 12
ARCHS = ["seamless-m4t-large-v2", "internvl2-2b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """``(arch, reference config, port config, reference params, port
    model)`` at the smoke config, the reference's weights carried across."""
    arch = request.param
    cfg_ref, cfg = ref_smoke_config(arch), configs.get_smoke_config(arch)
    params = jax.tree.map(np.asarray, ref_model.init_params(jax.random.PRNGKey(0), cfg_ref))
    net = convert.model_params_from_reference(params, cfg, device="cpu")
    return arch, cfg_ref, cfg, params, net


def _inputs(cfg, seed, s=S + STEPS):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    fe = rng.standard_normal((B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return tokens, fe


def _batches(tokens, fe):
    return ({"tokens": jnp.asarray(tokens), "frontend_embeds": jnp.asarray(fe)},
            {"tokens": torch.from_numpy(tokens).long(), "frontend_embeds": torch.from_numpy(fe)})


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _same_caches(cache, ref_cache, cfg):
    ours = convert.cache_to_reference(cache, cfg)
    theirs = jax.tree.map(np.asarray, ref_cache)
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours), jax.tree.leaves(theirs)):
        assert a.shape == b.shape, path
        assert _max_err(a, b) <= ATOL, path


def _decode_both(cfg_ref, cfg, params, net, ref_cache, cache, tokens):
    """Decode ``tokens [B, n]`` a column a step on both sides; each step's
    logits within ATOL."""
    ref_step, step = ref_model.make_serve_step(cfg_ref), model.make_serve_step(cfg)
    for i in range(tokens.shape[1]):
        ref_logits, ref_cache = ref_step(params, ref_cache, jnp.asarray(tokens[:, i]))
        logits, cache = step(net, cache, torch.from_numpy(tokens[:, i]).long())
        assert _max_err(logits, ref_logits) <= ATOL, i
    return ref_cache, cache


def test_forward_matches_reference(pair):
    _, cfg_ref, cfg, params, net = pair
    tokens, fe = _inputs(cfg, 1, S)
    ref_batch, batch = _batches(tokens, fe)
    ref_logits, _ = jax.jit(lambda p, b: ref_transformer.forward(p, b, cfg_ref))(params, ref_batch)
    with torch.no_grad():
        logits, aux = T.forward(net, batch, cfg)
    assert logits.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    assert _max_err(logits, ref_logits) <= ATOL


def test_serving_path_matches_reference(pair):
    """Prefill (last-position logits, every cache tensor, ``cross_kv``
    included) and 12 decode steps."""
    _, cfg_ref, cfg, params, net = pair
    tokens, fe = _inputs(cfg, 2)
    ref_batch, batch = _batches(tokens[:, :S], fe)
    ref_logits, ref_cache = ref_model.make_prefill_step(cfg_ref)(
        params, ref_model.init_cache(cfg_ref, B, MAX_LEN), ref_batch)
    logits, cache = model.make_prefill_step(cfg)(
        net, model.init_cache(cfg, B, MAX_LEN, device="cpu"), batch)
    assert logits.shape == (B, cfg.vocab_size)
    assert _max_err(logits, ref_logits) <= ATOL
    assert cache["pos"] == int(ref_cache["pos"]) == S
    _same_caches(cache, ref_cache, cfg)
    if cfg.is_encdec:
        assert cache["layers"][0]["cross_kv"]["k"].shape == (
            B, cfg.frontend_tokens, cfg.n_kv_heads, cfg.hd)
    ref_cache, cache = _decode_both(cfg_ref, cfg, params, net, ref_cache, cache, tokens[:, S:])
    assert cache["pos"] == S + STEPS
    _same_caches(cache, ref_cache, cfg)


@pytest.mark.parametrize("s", [10, 20])
def test_vision_prefix_truncates_the_prompt(s):
    """internvl2-2b's prompt of ``s`` < frontend_tokens + 8 tokens (16 in the
    smoke config): the reference prepends the 16 projected image embeddings
    and keeps the first ``s`` positions, so the prompt's last 16 tokens (all
    of them at ``s`` 10) never reach the model. The port gives the
    reference's logits and cache, and the same logits whatever those
    tokens are."""
    arch = "internvl2-2b"
    cfg_ref, cfg = ref_smoke_config(arch), configs.get_smoke_config(arch)
    params = jax.tree.map(np.asarray, ref_model.init_params(jax.random.PRNGKey(1), cfg_ref))
    net = convert.model_params_from_reference(params, cfg, device="cpu")
    assert s < cfg.frontend_tokens + 8
    tokens, fe = _inputs(cfg, 3, s + 4)
    ref_batch, batch = _batches(tokens[:, :s], fe)
    ref_logits, ref_cache = ref_model.make_prefill_step(cfg_ref)(
        params, ref_model.init_cache(cfg_ref, B, MAX_LEN), ref_batch)
    logits, cache = model.make_prefill_step(cfg)(
        net, model.init_cache(cfg, B, MAX_LEN, device="cpu"), batch)
    assert _max_err(logits, ref_logits) <= ATOL
    assert cache["pos"] == s
    _same_caches(cache, ref_cache, cfg)
    kept = max(s - cfg.frontend_tokens, 0)
    other = tokens[:, :s].copy()
    other[:, kept:] = (other[:, kept:] + 1) % cfg.vocab_size  # the dropped tail changed
    again, _ = model.make_prefill_step(cfg)(
        net, model.init_cache(cfg, B, MAX_LEN, device="cpu"), _batches(other, fe)[1])
    assert torch.equal(again, logits)
    _decode_both(cfg_ref, cfg, params, net, ref_cache, cache, tokens[:, s:])


def test_encdec_decodes_straight_after_init_cache():
    """seamless-m4t-large-v2's serve step with no prefill: each layer's
    cross-attention attends over the cache's zero keys and values (so adds
    nothing), as the reference's does; 4 steps."""
    arch = "seamless-m4t-large-v2"
    cfg_ref, cfg = ref_smoke_config(arch), configs.get_smoke_config(arch)
    params = jax.tree.map(np.asarray, ref_model.init_params(jax.random.PRNGKey(2), cfg_ref))
    net = convert.model_params_from_reference(params, cfg, device="cpu")
    tokens, _ = _inputs(cfg, 4, 4)
    ref_cache, cache = _decode_both(cfg_ref, cfg, params, net, ref_model.init_cache(cfg_ref, B, 8),
                                    model.init_cache(cfg, B, 8, device="cpu"), tokens)
    assert cache["pos"] == 4
    _same_caches(cache, ref_cache, cfg)


def test_frontend_inputs_as_the_reference_takes_them():
    """An encoder-decoder without ``frontend_embeds`` raises a KeyError that
    names the key (the reference fails there too); a vision config without
    them runs on the tokens alone, as the reference's ``embed_inputs``
    does; a float32 frontend input is rounded to the weights' dtype before
    the projection."""
    cfg = configs.get_smoke_config("seamless-m4t-large-v2")
    net = model.init_params(0, cfg, device="cpu")
    tokens = torch.zeros((B, 4), dtype=torch.long)
    with pytest.raises(KeyError, match="frontend_embeds"):
        model.make_prefill_step(cfg)(net, model.init_cache(cfg, B, 8, device="cpu"),
                                     {"tokens": tokens})
    with pytest.raises(KeyError, match="frontend_embeds"):
        T.forward(net, {"tokens": tokens}, cfg)

    arch = "internvl2-2b"
    cfg_ref, cfg = ref_smoke_config(arch), configs.get_smoke_config(arch)
    params = jax.tree.map(np.asarray, ref_model.init_params(jax.random.PRNGKey(3), cfg_ref))
    net = convert.model_params_from_reference(params, cfg, device="cpu")
    toks, _ = _inputs(cfg, 5, S)
    ref_logits, _ = ref_model.make_prefill_step(cfg_ref)(
        params, ref_model.init_cache(cfg_ref, B, MAX_LEN), {"tokens": jnp.asarray(toks)})
    logits, _ = model.make_prefill_step(cfg)(
        net, model.init_cache(cfg, B, MAX_LEN, device="cpu"), {"tokens": torch.from_numpy(toks)})
    assert _max_err(logits, ref_logits) <= ATOL

    bf = dataclasses.replace(cfg, dtype="bfloat16")
    net16 = model.init_params(0, bf, device="cpu")
    fe = torch.randn((B, bf.frontend_tokens, bf.frontend_dim), generator=torch.Generator().manual_seed(6))
    batch = {"tokens": torch.from_numpy(toks).long(), "frontend_embeds": fe}
    with torch.no_grad():
        x = T.embed_inputs(net16, batch, bf)
        want = fe.to(torch.bfloat16) @ net16.frontend_proj
    assert x.dtype == torch.bfloat16 and torch.equal(x[:, :bf.frontend_tokens], want)
    assert torch.equal(x[:, bf.frontend_tokens:], net16.embed[batch["tokens"][:, :S - bf.frontend_tokens]])


def test_param_counts_match_reference(pair):
    """``param_count()`` of the port's config equals the reference's at the
    smoke size and at full width, the module holds as many numbers as the
    reference's tree, and both full-width configs equal the reference's."""
    arch, cfg_ref, cfg, params, net = pair
    assert cfg.param_count() == cfg_ref.param_count()
    assert sum(p.numel() for p in net.parameters()) == sum(a.size for a in jax.tree.leaves(params))
    full = configs.get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref_config(arch))
    assert full.param_count() == ref_config(arch).param_count()


def test_params_round_trip_bitwise(pair):
    """The reference's tree through the port and back, every leaf bit for
    bit; by name (``named_from_reference``) the same tensors as the
    module's; each name maps to its leaf (``_reference_key``), stacked
    leaves with their stack's length."""
    _, cfg_ref, cfg, params, net = pair
    back = convert.model_params_to_reference(net, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    named = convert.named_from_reference(params, cfg, "cpu")
    mine = dict(net.named_parameters())
    assert sorted(named) == sorted(mine)
    for name, t in named.items():
        assert torch.equal(t, mine[name]), name
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    for name, p in mine.items():
        key, n = convert._reference_key(name, cfg)
        assert flat[key].shape == ((n,) if n else ()) + tuple(p.shape), name
    if cfg.is_encdec:
        for name in ("encoder.0.attn.wq", "enc_final_norm", "frontend_proj",
                     "layers.1.cross.wo", "layers.0.norm_cross"):
            assert name in mine, name
        assert convert._reference_key("encoder.1.mlp.w_up", cfg) == (
            "encoder/units/b0/mlp/w_up", cfg.encoder_layers)
        assert "bq" not in params["decoder"]["units"]["b0"]["cross"]


def test_encdec_cache_round_trips_bitwise():
    """seamless-m4t-large-v2's prefilled reference cache (``kv`` and
    ``cross_kv`` a layer) into the port's layout and back, bit for bit."""
    arch = "seamless-m4t-large-v2"
    cfg_ref, cfg = ref_smoke_config(arch), configs.get_smoke_config(arch)
    params = ref_model.init_params(jax.random.PRNGKey(4), cfg_ref)
    tokens, fe = _inputs(cfg, 7, S)
    _, cache = ref_model.make_prefill_step(cfg_ref)(
        params, ref_model.init_cache(cfg_ref, B, MAX_LEN), _batches(tokens, fe)[0])
    cache = jax.tree.map(np.asarray, cache)
    ours = convert.cache_from_reference(cache, cfg, "cpu")
    assert sorted(ours["layers"][0]) == ["cross_kv", "kv"]
    back = convert.cache_to_reference(ours, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(cache)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(cache)):
        assert np.array_equal(a, b)

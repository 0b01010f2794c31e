"""xLSTM's blocks in the port against the reference's, on the CPU.

The reference's ``init_mlstm`` / ``init_slstm`` draw the weights, which the
port's ``MLSTM`` / ``SLSTM`` modules load by name; inputs come from a numpy
seed. Each block's full-sequence forward, the state its prefill leaves
(the mLSTM's closed-form ``C``, ``n``, ``m``; the sLSTM's ``h``, ``c``,
``n``, ``m`` after its loop) and a decode step from that state go through
both packages in float32, within 1e-4 of the reference's largest entry
(the same products, summed in another order, through exponentials; the
serving-path tests of ``test_torch_models.py`` use the same limit). The
chunkwise cell at xLSTM's head widths (Dk 128 and 512; 160 against the
Pallas kernel in interpret mode) is held within 1e-5 of the largest entry,
as ``test_torch_llm_kernels.py`` holds the narrower heads. ``convert``
carries the xLSTM leaves and caches across and back bit for bit."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import ops as jops
from repro.kernels.mlstm_chunk import mlstm_chunk_pallas
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.kernels import ref
from repro_torch.models import blocks

TOL = 1e-4  # blocks, relative to the reference's largest entry
CELL_TOL = 1e-5  # the chunkwise cell alone
B = 2


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _cell_inputs(S, H, Dk, Dv, seed):
    """q, k, v and xLSTM's gate pre-activations (the forget gate open)."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((1, S, H, Dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((1, S, H, Dv)).astype(np.float32)
    ig = rng.standard_normal((1, S, H)).astype(np.float32)
    fg = (rng.standard_normal((1, S, H)) + 3.0).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("Dk", [128, 512])
@pytest.mark.parametrize("S", [150, 300])
def test_chunked_cell_matches_reference_at_wide_heads(Dk, S):
    """The plain chunked cell (the tiled kernel's yardstick and the CPU
    path past S 256) at ``normalize=True`` and Dk = Dv past the narrow
    kernels' 64, against the reference's CPU path (the parallel form up to
    S 256, its chunked recurrence above), a padded last chunk in both."""
    args = _cell_inputs(S, 2, Dk, Dk, seed=S + Dk)
    want = np.asarray(jops.mlstm_chunk(*args, normalize=True, backend="xla"))
    got = ref.mlstm_chunk_chunked(*_t(*args), chunk=128, normalize=True).numpy()
    assert _rel(got, want) <= CELL_TOL


def test_chunked_cell_matches_pallas_interpret_at_dk_160():
    args = _cell_inputs(150, 1, 160, 96, seed=160)
    want = np.asarray(mlstm_chunk_pallas(*args, chunk=128, normalize=True, interpret=True))
    got = ref.mlstm_chunk_chunked(*_t(*args), chunk=128, normalize=True).numpy()
    assert _rel(got, want) <= CELL_TOL


def _configs(wide: bool):
    """The smoke config (heads 64 wide in the mLSTM), or one whose mLSTM
    heads are 128 wide, past the narrow kernels' Dk."""
    over = dict(d_model=128) if wide else {}
    return (dataclasses.replace(ref_smoke_config("xlstm-350m"), **over),
            dataclasses.replace(configs.get_smoke_config("xlstm-350m"), **over))


def _module(cls, params, cfg):
    mod = cls(cfg, None, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()},
                        strict=True)
    return mod


def _states_close(got, want):
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == np.shape(arr), name
        assert _rel(got[name].numpy(), arr) <= TOL, name


@pytest.mark.parametrize("wide,S", [(False, 40), (True, 300)])
def test_mlstm_block_matches_reference(wide, S):
    cfg_ref, cfg = _configs(wide)
    params = jax.tree.map(np.asarray, jblocks.init_mlstm(jax.random.PRNGKey(S), cfg_ref))
    mod = _module(blocks.MLSTM, params, cfg)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        y = mod(torch.from_numpy(x))
        y_pre, state = mod.prefill(torch.from_numpy(x))
        y_dec, new = mod.decode(torch.from_numpy(x1), state)
    assert _rel(y, jblocks.mlstm_forward(params, x, cfg_ref)) <= TOL
    assert torch.equal(y, y_pre)
    cache = jblocks.init_mlstm_cache(cfg_ref, B)
    want_pre, want_state = jtransformer._mlstm_prefill(params, x, cache, cfg_ref, None)
    assert _rel(y_pre, want_pre) <= TOL
    want_state = jax.tree.map(np.asarray, want_state)
    _states_close(state, want_state)
    want_dec, want_new = jblocks.mlstm_decode(params, x1, want_state, cfg_ref)
    assert _rel(y_dec, want_dec) <= TOL
    _states_close(new, jax.tree.map(np.asarray, want_new))


def test_slstm_block_matches_reference():
    cfg_ref, cfg = _configs(False)
    params = jax.tree.map(np.asarray, jblocks.init_slstm(jax.random.PRNGKey(9), cfg_ref))
    mod = _module(blocks.SLSTM, params, cfg)
    rng = np.random.default_rng(9)
    S = 40
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        y = mod(torch.from_numpy(x))
        y_pre, state = mod.prefill(torch.from_numpy(x))
        y_dec, new = mod.decode(torch.from_numpy(x1), state)
    assert _rel(y, jblocks.slstm_forward(params, x, cfg_ref)) <= TOL
    assert torch.equal(y, y_pre)
    want_pre, want_state = jtransformer._slstm_prefill(params, x, cfg_ref)
    assert _rel(y_pre, want_pre) <= TOL
    want_state = jax.tree.map(np.asarray, want_state)
    _states_close(state, want_state)
    want_dec, want_new = jblocks.slstm_decode(params, x1, want_state, cfg_ref)
    assert _rel(y_dec, want_dec) <= TOL
    _states_close(new, jax.tree.map(np.asarray, want_new))



def test_xlstm_weights_and_caches_cross_both_ways():
    """``convert`` carries the mLSTM and sLSTM leaves and their ``"cell"``
    caches (``C``, ``n``, ``m``; ``h``, ``c``, ``n``, ``m``) across and
    back, bit for bit."""
    from repro.models import model as ref_model
    from repro_torch import convert

    cfg_ref, cfg = _configs(False)
    params = jax.tree.map(np.asarray, ref_model.init_params(jax.random.PRNGKey(2), cfg_ref))
    net = convert.model_params_from_reference(params, cfg, device="cpu")
    back = convert.model_params_to_reference(net, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(a, b)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 20)).astype(np.int32)
    cache = ref_model.init_cache(cfg_ref, B, 32)
    _, cache = ref_model.make_prefill_step(cfg_ref)(params, cache, {"tokens": tokens})
    cache = jax.tree.map(np.asarray, cache)
    ours = convert.cache_from_reference(cache, cfg, "cpu")
    assert sorted(ours["layers"][0]["cell"]) == ["C", "m", "n"]
    assert sorted(ours["layers"][3]["cell"]) == ["c", "h", "m", "n"]
    for a, b in zip(jax.tree.leaves(convert.cache_to_reference(ours, cfg)), jax.tree.leaves(cache)):
        assert np.array_equal(a, b)

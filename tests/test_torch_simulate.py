"""The port's per-campaign engine (``simulate``, ``simulate_batch``, the
``vmap`` lowering of ``simulate_bank``) against the reference's on the CPU.

The campaign is ``wlcg_production_workload(seed=0, n_observations=20,
n_waves=3)`` (20 legs, 6 processes, 1 link) at ``max_ticks=3000``, B <= 8.
The same numpy inputs and threefry keys go through both packages, whose
``simulate_batch`` is held against the reference's per-simulation
``simulate_batch`` (backend ``xla``, and ``pallas_interpret`` for the
kernel path), never its banked run. Tolerances: ``done``, ``ticks``,
``transfer_time`` and ``start_tick`` equal; ``conth_mb`` and ``conpr_mb``
within rtol 1e-5, atol 1e-4 (per-process and per-link sums in another
order than XLA's dot), and ``conpr_mb`` exactly 0 wherever the
reference's is. Across window sizes the port is bitwise equal to
itself."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import calibration as rcal
from repro.core import engine as reng
from repro.core import workload as rwork
from repro_torch.convert import from_reference
from repro_torch.core import calibration as pcal
from repro_torch.core import engine as peng
from repro_torch.core import prng
from repro_torch.core import workload as pwork
from repro_torch.core.refsim import reference_simulate
from repro_torch.kernels import grid_tick

jax.config.update("jax_threefry_partitionable", True)

MAX_TICKS = 3_000
B = 6
EXACT = ("done", "ticks", "transfer_time", "start_tick", "size_mb", "profile")
CLOSE = ("conth_mb", "conpr_mb")


def _t(a) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)


def _assert_matches(port, ref, msg=""):
    for f in EXACT:
        np.testing.assert_array_equal(
            getattr(port, f).numpy(), np.asarray(getattr(ref, f)), err_msg=msg + f
        )
    for f in CLOSE:
        np.testing.assert_allclose(
            getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
            rtol=1e-5, atol=1e-4, err_msg=msg + f,
        )
    # where the reference's ConPr is exactly 0 (a link whose other
    # processes moved nothing), the port's is too: its link sums add the
    # processes' sums, so a link with one busy process sums to exactly it
    zero = np.asarray(ref.conpr_mb) == 0
    np.testing.assert_array_equal(port.conpr_mb.numpy()[zero], 0.0, err_msg=msg + "conpr_mb zeros")


def _assert_bitwise(a, b, msg=""):
    for f in a._fields:
        np.testing.assert_array_equal(
            getattr(a, f).numpy(), getattr(b, f).numpy(), err_msg=msg + f
        )


@pytest.fixture(scope="module")
def campaign():
    """The same small campaign compiled by both packages, its specs and
    theta mappers."""
    rt = rwork.compile_campaign(*rwork.wlcg_production_workload(
        seed=0, n_observations=20, n_waves=3))
    pt = pwork.compile_campaign(*pwork.wlcg_production_workload(
        seed=0, n_observations=20, n_waves=3))
    rspec = reng.SimSpec.from_table(rt, max_ticks=MAX_TICKS)
    pspec = peng.SimSpec.from_table(pt, max_ticks=MAX_TICKS, device="cpu")
    return dict(rt=rt, pt=pt, rspec=rspec, pspec=pspec,
                rmap=rcal.make_theta_mapper(rt, "webdav"),
                pmap=pcal.make_theta_mapper(pt, "webdav", device="cpu"))


def _params(cam, stochastic: bool, per_sim: bool):
    """Reference and port params from one numpy theta (``[3]`` shared or
    ``[B, 3]`` per simulation); sigma 0 unless ``stochastic``."""
    rng = np.random.default_rng(0)
    theta = rng.uniform([0, 0, 0], [0.1, 60, 30], (B, 3)).astype(np.float32)
    if not stochastic:
        theta[:, 2] = 0.0
    if not per_sim:
        theta = theta[0]
    rp = (jax.vmap(cam["rmap"]) if per_sim else cam["rmap"])(jnp.asarray(theta))
    return rp, cam["pmap"](torch.from_numpy(theta))


@pytest.mark.parametrize("per_sim", [False, True], ids=["shared", "per-sim"])
@pytest.mark.parametrize("stochastic", [False, True], ids=["sigma0", "stochastic"])
@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_simulate_batch_matches_reference(campaign, leap, stochastic, per_sim):
    rp, pp = _params(campaign, stochastic, per_sim)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want = reng.simulate_batch(campaign["rspec"], rp, keys, leap=leap, backend="xla")
    assert int(np.asarray(want.done).sum()) > 0
    got = peng.simulate_batch(campaign["pspec"], pp, _t(keys), leap=leap, window=8)
    _assert_matches(got, want)


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_simulate_batch_matches_reference_kernel_path(campaign, leap):
    """Against the reference's Pallas tick in interpret mode, with one
    ``enabled`` mask per simulation under a shared stochastic theta."""
    rp, pp = _params(campaign, stochastic=True, per_sim=False)
    enabled = np.random.default_rng(1).uniform(size=(B, campaign["rt"].n_legs)) < 0.7
    rp = rp._replace(enabled=jnp.asarray(enabled))
    pp = pp._replace(enabled=torch.from_numpy(enabled))
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    want = reng.simulate_batch(campaign["rspec"], rp, keys, leap=leap,
                               backend="pallas_interpret")
    got = peng.simulate_batch(campaign["pspec"], pp, _t(keys), leap=leap)
    _assert_matches(got, want)
    assert got.done.numpy()[~enabled].all(), "disabled legs are born done"
    np.testing.assert_array_equal(
        got.transfer_time.numpy()[~enabled], 0.0, err_msg="disabled legs transfer nothing"
    )


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_simulate_matches_reference(campaign, leap):
    rp, pp = _params(campaign, stochastic=True, per_sim=False)
    key = jax.random.PRNGKey(11)
    want = reng.simulate(campaign["rspec"], rp, key, leap=leap)
    got = peng.simulate(campaign["pspec"], pp, _t(key), leap=leap)
    assert got.done.shape == (campaign["rt"].n_legs,) and got.ticks.shape == ()
    _assert_matches(got, want)


def test_matches_refsim_oracle(campaign):
    """Under bg_sigma=0 the per-campaign tick engine equals the loop oracle."""
    pt = campaign["pt"]
    params = peng.make_params(pt, bg_mu=3.0, bg_sigma=0.0, device="cpu")
    res = peng.simulate(campaign["pspec"], params, prng.PRNGKey(0))
    oracle = reference_simulate(pt, params.keep_frac.numpy(), params.bg_mu.numpy(),
                                params.bg_sigma.numpy(), MAX_TICKS)
    np.testing.assert_array_equal(res.done.numpy(), oracle["done"])
    assert int(res.ticks) == int(oracle["ticks"])
    for f in ("transfer_time", "start_tick", "conth_mb", "conpr_mb"):
        np.testing.assert_allclose(getattr(res, f).numpy(), oracle[f], rtol=1e-5,
                                   atol=1e-3, err_msg=f)


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_window_invariance(campaign, leap):
    """Results are bitwise the same for every window size K (stochastic,
    per-simulation theta): the alive freeze and the pre-drawn key chain."""
    _, pp = _params(campaign, stochastic=True, per_sim=True)
    keys = prng.split(prng.PRNGKey(5), B)
    runs = [peng.simulate_batch(campaign["pspec"], pp, keys, leap=leap, window=k)
            for k in (1, 7, 64)]
    _assert_bitwise(runs[0], runs[1], "K=1 vs K=7 ")
    _assert_bitwise(runs[0], runs[2], "K=1 vs K=64 ")


def test_make_params_matches_reference(campaign):
    for kw in ({}, dict(overhead=0.05), dict(overhead=0.05, protocol="webdav"),
               dict(bg_mu=4.0, bg_sigma=2.5)):
        want = reng.make_params(campaign["rt"], **kw)
        got = peng.make_params(campaign["pt"], device="cpu", **kw)
        for f in ("keep_frac", "bg_mu", "bg_sigma"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)


def test_from_reference_unstacked(campaign):
    """convert.from_reference carries a reference campaign spec, per-sim
    params and [B, 2] keys across; both engines agree on them."""
    rp, _ = _params(campaign, stochastic=True, per_sim=True)
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    spec, params, t_keys = from_reference(campaign["rspec"], rp, keys, device="cpu")
    assert spec.campaign_tables is not None and t_keys.shape == (B, 2)
    for f in ("proc_of_leg", "link_of_leg", "link_of_proc"):
        np.testing.assert_array_equal(getattr(spec, f).numpy(),
                                      getattr(campaign["pspec"], f).numpy())
    want = reng.simulate_batch(campaign["rspec"], rp, keys, leap=True)
    _assert_matches(peng.simulate_batch(spec, params, t_keys, leap=True), want)


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_vmap_lowering_matches_reference(leap):
    """simulate_bank(lowering="vmap") against the reference's vmap lowering
    (stochastic, per-replica keep): padded legs born done."""
    bank = repro.build_bank(["wlcg-remote", "bursty", "stagein"], n=3, seed=9,
                            max_ticks=MAX_TICKS)
    base = repro.make_bank_params(bank, bg_mu=3.0, bg_sigma=1.5)
    rng = np.random.RandomState(0)
    keep = np.asarray(base.keep_frac)[:, None, :] * rng.uniform(
        0.9, 1.0, (3, 2, 1)).astype(np.float32)
    params = base._replace(keep_frac=jnp.asarray(keep))
    keys = jax.random.split(jax.random.PRNGKey(9), 6).reshape(3, 2, 2)
    want = repro.simulate_bank(bank, params, keys, leap=leap, lowering="vmap")
    spec, t_params, t_keys = from_reference(bank, params, keys, device="cpu")
    got = peng.simulate_bank(spec, t_params, t_keys, leap=leap, lowering="vmap",
                             device="cpu")
    assert got.done.shape == (3, 2, bank.pad_legs)
    _assert_matches(got, want)


def test_per_campaign_path_stays_off_the_kernel_on_cpu(campaign):
    """CPU tensors take the plain tick: no kernel launch, nothing built."""
    before = dict(grid_tick.LAUNCHES)
    _, pp = _params(campaign, stochastic=True, per_sim=False)
    peng.simulate_batch(campaign["pspec"], pp, prng.split(prng.PRNGKey(1), 2), leap=True)
    assert grid_tick.LAUNCHES == before


def test_entry_points_default_to_cuda(campaign):
    """Without a device the per-campaign entry points want CUDA and raise
    where there is none; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        peng.SimSpec.from_table(campaign["pt"])
    with pytest.raises(RuntimeError, match="CUDA"):
        peng.make_params(campaign["pt"])
    with pytest.raises(RuntimeError, match="CUDA"):
        pcal.make_theta_mapper(campaign["pt"])


def test_simulate_batch_validates_inputs(campaign):
    _, pp = _params(campaign, stochastic=False, per_sim=False)
    with pytest.raises(ValueError, match=r"\[B, 2\]"):
        peng.simulate_batch(campaign["pspec"], pp, torch.zeros((2, 2, 2), dtype=torch.int64))
    bank_spec = peng.bank_spec(pwork.compile_bank(
        [pwork.wlcg_production_workload(seed=0, n_observations=20, n_waves=3)]), "cpu")
    with pytest.raises(ValueError, match="unstacked"):
        peng.simulate_batch(bank_spec, pp, prng.split(prng.PRNGKey(0), 2))

"""The port's ``Fleet.run`` against the reference package's on the CPU.

Across all 7 scenario families, in tick and leap mode, with deterministic
and stochastic background load: ``done``, ``ticks``, ``transfer_time`` and
``start_tick`` are equal; ``conth_mb`` and ``conpr_mb`` within rtol 1e-5,
atol 1e-4 (the segment sums run in another order than the reference's
one-hot matmul). The port's results at window K=1 and K=16 are bitwise
equal, and both match the reference. Under ``bg_sigma > 0`` the normals
are ``jax.random``'s bit for bit (see test_torch_prng.py)."""
import numpy as np
import pytest
import torch

import repro
from repro.core.scenarios import family_names
from repro_torch import Fleet, SimParams, simulate_bank
from repro_torch.convert import from_reference
from repro_torch.core import prng
from repro_torch.core.refsim import reference_simulate

N = len(family_names())
R = 2
MAX_TICKS = 2_000
EXACT = ("done", "ticks", "transfer_time", "start_tick", "size_mb", "profile")
CLOSE = ("conth_mb", "conpr_mb")


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


def _assert_bitwise(a, b, msg=""):
    for f in a._fields:
        np.testing.assert_array_equal(
            getattr(a, f).numpy(), getattr(b, f).numpy(), err_msg=msg + f
        )


@pytest.mark.parametrize("stochastic", [False, True], ids=["sigma0", "sigma1.5"])
@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_fleet_run_matches_reference(leap, stochastic):
    kw = dict(bg_mu=2.0, bg_sigma=1.5) if stochastic else {}
    ref_fleet = repro.Fleet.from_scenarios(n=N, seed=0, max_ticks=MAX_TICKS, leap=leap)
    fleet = Fleet.from_scenarios(
        n=N, seed=0, max_ticks=MAX_TICKS, leap=leap, device="cpu"
    )
    want = ref_fleet.run(ref_fleet.params(**kw), replicas=R, lowering="banked", window=16)
    assert int(np.asarray(want.done).sum()) > 0
    results = {}
    for k in (1, 16):
        results[k] = fleet.run(fleet.params(**kw), replicas=R, window=k)
        _assert_matches(results[k], want, msg=f"K={k} ")
    _assert_bitwise(results[1], results[16], msg="K=1 vs K=16 ")


def test_matches_refsim_oracle():
    """Under bg_sigma=0 the banked tick engine equals the loop oracle."""
    fleet = Fleet.from_scenarios(n=N, seed=1, max_ticks=MAX_TICKS, device="cpu")
    res = fleet.run()
    bank = fleet.bank
    for i in range(N):
        nt = int(bank.n_legs[i])
        oracle = reference_simulate(
            bank.scenario_table(i), bank.keep_frac[i, :nt],
            bank.bg_mu[i, : bank.n_links[i]], bank.bg_sigma[i, : bank.n_links[i]],
            int(bank.max_ticks[i]),
        )
        np.testing.assert_array_equal(res.done[i, 0, :nt].numpy(), oracle["done"])
        assert int(res.ticks[i, 0]) == int(oracle["ticks"])
        for f in ("transfer_time", "start_tick", "conth_mb", "conpr_mb"):
            np.testing.assert_allclose(
                getattr(res, f)[i, 0, :nt].numpy(), oracle[f],
                rtol=1e-5, atol=1e-3, err_msg=f"scenario {i} {f}",
            )


def test_simulate_bank_from_converted_reference_inputs():
    """convert.from_reference carries a reference bank, per-replica params
    and keys across; the port's simulate_bank on them matches the
    reference's simulate_bank."""
    import jax
    import jax.numpy as jnp

    bank = repro.build_bank(["wlcg-remote", "bursty", "stagein"], n=3, seed=9,
                            max_ticks=MAX_TICKS)
    base = repro.make_bank_params(bank, bg_mu=3.0, bg_sigma=1.5)
    rng = np.random.RandomState(0)
    keep = np.asarray(base.keep_frac)[:, None, :] * rng.uniform(
        0.9, 1.0, (3, R, 1)).astype(np.float32)
    params = base._replace(keep_frac=jnp.asarray(keep))
    keys = jax.random.split(jax.random.PRNGKey(9), 3 * R).reshape(3, R, 2)
    want = repro.simulate_bank(bank, params, keys, leap=True, lowering="banked", window=4)
    spec, t_params, t_keys = from_reference(bank, params, keys, device="cpu")
    assert isinstance(t_params, SimParams) and t_params.keep_frac.shape == (3, R, bank.pad_legs)
    got = simulate_bank(spec, t_params, t_keys, leap=True, window=4, device="cpu")
    _assert_matches(got, want)


def test_fleet_keys_follow_reference_schedule():
    import jax

    ref_keys = jax.random.split(jax.random.PRNGKey(0), N * 3).reshape(N, 3, 2)
    port = prng.split(prng.PRNGKey(0), N * 3).reshape(N, 3, 2)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref_keys).astype(np.int64))


def test_entry_points_default_to_cuda():
    """Without a device argument the entry points run on CUDA, and raise
    where there is none; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        Fleet.from_scenarios(n=1, seed=0, max_ticks=50)
    fleet = Fleet.from_scenarios(n=1, seed=0, max_ticks=50, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_bank(fleet.bank, fleet.params(), torch.zeros((1, 1, 2), dtype=torch.int64))


def test_unported_paths_raise():
    """A calibration theta maps onto the bank; the bucketed dispatch
    (ROADMAP A.3) runs and equals the monolithic run bitwise. The
    per-campaign engine (A.7) is ported: one scenario of the bank run as a
    campaign of its own equals the reference's ``simulate_batch`` of it."""
    import jax
    from repro.core import engine as ref_engine
    from repro_torch.core import engine

    fleet = Fleet.from_scenarios(n=4, seed=2, max_ticks=200, n_buckets=2, device="cpu")
    assert fleet.n_buckets > 1
    _assert_bitwise(fleet.run(replicas=2), fleet.run(replicas=2, bucketed=False))
    assert fleet.run(bucketed=False).ticks.shape == (4, 1)
    res = fleet.run([0.1, 2.0, 1.0], bucketed=False)
    assert res.ticks.shape == (4, 1)
    with pytest.raises(TypeError, match="theta"):
        fleet.run([0.1, 2.0], bucketed=False)
    ref_table = repro.Fleet.from_scenarios(n=4, seed=2, max_ticks=200).bank.scenario_table(1)
    table = fleet.bank.scenario_table(1)
    keys = jax.random.split(jax.random.PRNGKey(6), R)
    want = ref_engine.simulate_batch(
        ref_engine.SimSpec.from_table(ref_table, max_ticks=200),
        ref_engine.make_params(ref_table, bg_mu=2.0, bg_sigma=1.5), keys, leap=True)
    got = engine.simulate_batch(
        engine.SimSpec.from_table(table, max_ticks=200, device="cpu"),
        engine.make_params(table, bg_mu=2.0, bg_sigma=1.5, device="cpu"),
        torch.from_numpy(np.asarray(keys).astype(np.int64)), leap=True)
    _assert_matches(got, want)

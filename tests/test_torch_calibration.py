"""The port's calibration path against the reference's, on the CPU.

The same inputs (numpy seeds, the same threefry keys) go through both
packages. Tolerances, each with its reason:

- keys, permutations, uniform draws, ``prng.fold_in`` and histogram modes
  are bitwise (integer hashing and the same float32 edges);
- regressions within rtol 1e-4: float32 normal equations whose sums run in
  another order than XLA's, then a float32 solve;
- logits within 1e-5: the same float32 MLP with its sums in another order;
- one AdamW step within 1e-7, two epochs of training within 1e-4: the same
  batches, with gradients that differ in the last bits;
- chains: the accept decisions equal, samples within 1e-5 (1e-4 with step
  adaptation, whose ``exp`` and ``pow`` round differently); the proposal is
  one fused XLA computation whose rounding the port does not reproduce
  bitwise;
- presimulation and validation: theta and scenario ids bitwise, every
  done tick of the runs behind the tuples equal, the Eq.-1 fits within
  rtol 1e-4 where the fit's normal matrix is well conditioned (condition
  number under 1e4); a near-singular fit is solved by any float32 solve
  only to about ``cond * 2**-23``, and there the port is held to that bound
  around the float64 solution (ROADMAP C);
- the amortized posterior: the context table bitwise, ``theta_star_all``
  within one histogram bin (1/50 of the prior range) per axis.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import calibration as rcal
from repro.core import classifier as rclf
from repro.core import mcmc as rmcmc
from repro.core import regression as rreg
from repro.core.scenarios import family_names
from repro.core.workload import ProfileTag
from repro.train import optimizer as ropt
import repro_torch
from repro_torch.convert import classifier_from_reference, classifier_to_reference
from repro_torch.core import calibration as pcal
from repro_torch.core import classifier as pclf
from repro_torch.core import mcmc as pmcmc
from repro_torch.core import prng, regression as preg
from repro_torch.train import optimizer as popt

jax.config.update("jax_threefry_partitionable", True)

N = len(family_names())
MAX_TICKS = 2_000
SMOKE = dict(n_presim=56, epochs=2, batch_size=16, lr=3e-4, n_chains=2,
             n_mcmc=100, burn_in=50)
BIN = np.array([0.1, 100.0, 100.0]) / 50  # one histogram bin per axis


def _t(a) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)


@pytest.fixture(scope="module")
def fleets():
    ref = repro.Fleet.from_scenarios(n=N, seed=0, max_ticks=MAX_TICKS, leap=True)
    port = repro_torch.Fleet.from_scenarios(n=N, seed=0, max_ticks=MAX_TICKS, leap=True,
                                            device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def net():
    """A conditional classifier (9 context features) in both packages."""
    params = rclf.init_classifier(jax.random.PRNGKey(1), rclf.ClassifierConfig(context_dim=9))
    return params, classifier_from_reference(params, device="cpu")


# -- RNG ------------------------------------------------------------------

@pytest.mark.parametrize("data", [0, 1, 7, 1023, 2**31 + 5])
def test_fold_in_bitwise(data):
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.fold_in(key, data)).astype(np.int64)
    np.testing.assert_array_equal(prng.fold_in(_t(key), data).numpy(), want)


def test_fold_in_batched_over_data():
    key = jax.random.PRNGKey(9)
    idx = np.arange(12)
    want = np.stack([np.asarray(jax.random.fold_in(key, int(i))) for i in idx]).astype(np.int64)
    np.testing.assert_array_equal(prng.fold_in(_t(key)[None], torch.from_numpy(idx)).numpy(), want)


@pytest.mark.parametrize("n", [1, 7, 4096, 65536])
def test_permutation_bitwise(n):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.permutation(key, n))
    np.testing.assert_array_equal(prng.permutation(_t(key), n).numpy(), want)


def test_uniform_with_bounds_bitwise():
    keys = jax.random.split(jax.random.PRNGKey(2), 16)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (8, 3), minval=0.2, maxval=0.8))(keys))
    np.testing.assert_array_equal(prng.uniform(_t(keys), (8, 3), 0.2, 0.8).numpy(), want)
    lo = np.array([0.0, 1.0, -2.0], np.float32)
    hi = np.array([0.1, 100.0, 3.0], np.float32)
    want = np.asarray(jax.random.uniform(keys[0], (5, 3), minval=lo, maxval=hi))
    got = prng.uniform(_t(keys[0]), (5, 3), torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), want)


# -- regression -------------------------------------------------------------

def test_regressions_match_reference_batched():
    rng = np.random.default_rng(0)
    B, n = 5, 40
    size = rng.uniform(10, 2000, (B, n)).astype(np.float32)
    conth = rng.uniform(0, 5e4, (B, n)).astype(np.float32)
    conpr = rng.uniform(0, 1e4, (B, n)).astype(np.float32)
    T = (0.05 * size + 1e-3 * conth + 2e-3 * conpr
         + rng.normal(0, 3, (B, n))).astype(np.float32)
    valid = (rng.uniform(0, 1, (B, n)) < 0.7).astype(np.float32)
    t = torch.from_numpy
    got1 = preg.fit_eq1(t(T), t(size), t(conth), t(conpr), t(valid))
    got2 = preg.fit_eq2(t(T), t(size), t(conpr), t(valid))
    for b in range(B):
        want1 = rreg.fit_eq1(T[b], size[b], conth[b], conpr[b], valid[b])
        want2 = rreg.fit_eq2(T[b], size[b], conpr[b], valid[b])
        for got, want in ((got1, want1), (got2, want2)):
            for f in ("coef", "f_statistic", "r_squared", "df_resid"):
                np.testing.assert_allclose(getattr(got, f)[b].numpy(), np.asarray(getattr(want, f)),
                                           rtol=1e-4, err_msg=f)
    err = preg.coefficient_error(t(np.array([0.1, 0.2, 0.3], np.float32)), got1.coef)
    want = rreg.coefficient_error(jnp.asarray([0.1, 0.2, 0.3]), jnp.asarray(got1.coef.numpy()))
    np.testing.assert_allclose(err.numpy(), np.asarray(want), rtol=1e-6)


def test_dataset_fits_and_hourly_coefficients(fleets):
    """Observation datasets of one run, the per-profile fit and the hourly
    partition, against the reference's on the same run."""
    from repro.core import dataset as rds
    from repro_torch.core import dataset as pds

    ref, port = fleets
    want = ref.run(replicas=1, lowering="banked")
    got = port.run(replicas=1)
    for i in range(N):
        w = type(want)(*(np.asarray(f)[i, 0] for f in want))
        g = type(got)(*(f[i, 0] for f in got))
        for prof in (ProfileTag.REMOTE, ProfileTag.STAGE_IN):
            wd, gd = rds.observations(w, prof), pds.observations(g, prof)
            np.testing.assert_array_equal(gd.valid.numpy(), np.asarray(wd.valid))
            wf, gf = rds.fit_profile(wd, prof), pds.fit_profile(gd, prof)
            np.testing.assert_allclose(gf.coef.numpy(), np.asarray(wf.coef), rtol=1e-4, atol=1e-6)
        start = g.start_tick
        wh = rds.hourly_coefficients(w, ProfileTag.STAGE_IN, start_ticks=np.asarray(w.start_tick),
                                     ticks_per_partition=200, n_partitions=6)
        gh = pds.hourly_coefficients(g, ProfileTag.STAGE_IN, start_ticks=start,
                                     ticks_per_partition=200, n_partitions=6)
        np.testing.assert_allclose(gh, wh, rtol=1e-4, atol=1e-6)


# -- classifier and optimizer ----------------------------------------------

def test_classifier_logit_with_converted_params(net):
    params, tparams = net
    rng = np.random.default_rng(3)
    theta, x, ctx = (rng.uniform(0, 1, (64, d)).astype(np.float32) for d in (3, 3, 9))
    want = np.asarray(rclf.classifier_logit(params, theta, x, ctx))
    got = pclf.classifier_logit(tparams, *(torch.from_numpy(a) for a in (theta, x, ctx)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    back = classifier_to_reference(tparams)
    assert set(back) == set(params)
    np.testing.assert_array_equal(np.asarray(rclf.classifier_logit(back, theta, x, ctx)), want)


def test_init_classifier_matches_reference():
    cfg = rclf.ClassifierConfig(context_dim=9)
    want = rclf.init_classifier(jax.random.PRNGKey(4), cfg)
    got = pclf.init_classifier(_t(jax.random.PRNGKey(4)),
                               pclf.ClassifierConfig(context_dim=9))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_one_adamw_update(net):
    params, tparams = net
    rng = np.random.default_rng(5)
    grads = {k: rng.normal(0, 1, np.shape(v)).astype(np.float32) for k, v in params.items()}
    cfg = ropt.AdamWConfig(lr=1e-3, weight_decay=0.01)
    state = ropt.adamw_init(params, cfg)
    state = state._replace(step=jnp.asarray(3, jnp.int32),
                           mu={k: 0.1 * g for k, g in grads.items()},
                           nu={k: 0.01 * g * g for k, g in grads.items()})
    want_p, want_s, want_n = ropt.adamw_update(grads, state, params, cfg)
    t = lambda d: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    pstate = popt.AdamWState(step=torch.tensor(3, dtype=torch.int32), mu=t(state.mu), nu=t(state.nu))
    got_p, got_s, got_n = popt.adamw_update(
        t(grads), pstate, tparams, popt.AdamWConfig(lr=1e-3, weight_decay=0.01))
    assert int(got_s.step) == 4
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]), atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got_s.nu[k].numpy(), np.asarray(want_s.nu[k]), rtol=1e-6, err_msg=k)


def test_train_classifier_two_epochs():
    rng = np.random.default_rng(6)
    n = 2048
    theta = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x = np.clip(theta + rng.normal(0, 0.1, (n, 3)), 0, 1).astype(np.float32)
    ctx = rng.uniform(0, 1, (n, 9)).astype(np.float32)
    cfg = rclf.ClassifierConfig(context_dim=9, lr=1e-3)
    key = jax.random.PRNGKey(8)
    want, wm = rclf.train_classifier(key, cfg, theta, x, ctx, epochs=2, batch_size=256)
    got, gm = pclf.train_classifier(
        _t(key), pclf.ClassifierConfig(context_dim=9, lr=1e-3),
        torch.from_numpy(theta), torch.from_numpy(x), torch.from_numpy(ctx),
        epochs=2, batch_size=256)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(gm.loss), float(wm.loss), atol=1e-4)
    assert float(gm.accuracy) == pytest.approx(float(wm.accuracy), abs=2 / 256)


# -- MCMC ---------------------------------------------------------------------

@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_chain_matches_reference(net, adaptive):
    params, tparams = net
    x = np.array([0.3, 0.5, 0.6], np.float32)
    ctx = np.random.default_rng(0).uniform(0, 1, 9).astype(np.float32)
    init = np.array([0.4, 0.5, 0.6], np.float32)
    key = jax.random.PRNGKey(7)
    if adaptive:
        want = rmcmc.run_chain_adaptive(params, x, key, n_samples=400, burn_in=100,
                                        init=init, context=ctx)
        got = pmcmc.run_chain_adaptive(tparams, _t(x), _t(key), n_samples=400,
                                       burn_in=100, init=_t(init), context=_t(ctx))
    else:
        want = rmcmc.run_chain(params, x, key, n_samples=400, burn_in=100,
                               init=init, context=ctx)
        got = pmcmc.run_chain(tparams, _t(x), _t(key), n_samples=400, burn_in=100,
                              init=_t(init), context=_t(ctx))
    ws, gs = np.asarray(want.samples), got.samples.numpy()
    # accept decisions: a step moved the chain iff it was accepted
    np.testing.assert_array_equal((np.diff(gs, axis=0) != 0).any(1),
                                  (np.diff(ws, axis=0) != 0).any(1))
    assert float(got.accept_rate) == float(want.accept_rate)
    tol = 1e-4 if adaptive else 1e-5
    np.testing.assert_allclose(gs, ws, atol=tol, rtol=0)
    np.testing.assert_allclose(got.log_ratios.numpy(), np.asarray(want.log_ratios), atol=tol)


def test_run_chains_pooled(net):
    params, tparams = net
    x = np.array([0.2, 0.4, 0.5], np.float32)
    ctx = np.full(9, 0.5, np.float32)
    key = jax.random.PRNGKey(12)
    want, wr = rmcmc.run_chains(params, x, key, n_chains=3, n_samples=200, burn_in=50,
                                adaptive=True, context=ctx)
    got, gr = pmcmc.run_chains(tparams, _t(x), _t(key), n_chains=3, n_samples=200,
                               burn_in=50, adaptive=True, context=_t(ctx))
    assert got.samples.shape == (600, 3)
    np.testing.assert_allclose(got.samples.numpy(), np.asarray(want.samples), atol=1e-4)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=1e-3)


def test_gelman_rubin_and_posterior_mode_on_shared_arrays():
    rng = np.random.default_rng(9)
    chains = rng.uniform(0, 1, (4, 301, 3)).astype(np.float32)
    np.testing.assert_allclose(pmcmc.gelman_rubin(torch.from_numpy(chains)).numpy(),
                               np.asarray(rmcmc.gelman_rubin(jnp.asarray(chains))), rtol=1e-5)
    # samples on and next to every bin edge, and on 0 and 1
    edges = np.asarray(jnp.linspace(jnp.float32(0), jnp.float32(1), 51, dtype=jnp.float32))
    near = np.concatenate([edges, np.nextafter(edges, np.float32(2)),
                           np.nextafter(edges, np.float32(-1))]).astype(np.float32)
    for seed in range(4):
        r = np.random.default_rng(seed)
        s = np.concatenate([r.beta(2, 5, (500, 3)).astype(np.float32),
                            r.choice(near, (300, 3))])
        np.testing.assert_array_equal(pmcmc.posterior_mode(torch.from_numpy(s)).numpy(),
                                      np.asarray(rmcmc.posterior_mode(jnp.asarray(s))))


# -- theta mapping, presimulation, validation ---------------------------------

def test_theta_mapper_and_fleet_run_theta(fleets):
    ref, port = fleets
    theta = np.array([0.05, 30.0, 10.0], np.float32)
    per = np.random.default_rng(1).uniform([0, 0, 0], [0.1, 60, 30], (N, 3)).astype(np.float32)
    for th in (theta, per):
        want = rcal.make_theta_mapper(ref.bank)(jnp.asarray(th))
        got = pcal.make_theta_mapper(port.bank, device="cpu")(torch.from_numpy(th))
        for f in ("keep_frac", "bg_mu", "bg_sigma"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
        w = ref.run(jnp.asarray(th), replicas=2, lowering="banked")
        g = port.run(torch.from_numpy(th), replicas=2)
        for f in ("done", "ticks", "transfer_time"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)), f)


def _assert_fits_close(got, want, res):
    """Eq.-1 fits of the port (``got``) against the reference's (``want``),
    both ``[..., 3]``, of the runs ``res`` (the port's): within rtol 1e-4
    where the fit's normal matrix is well conditioned (condition number
    under 1e4). A near-singular fit (no more remote observations than
    unknowns, or a regressor that is all zero) is solved by any float32
    solve only to about ``cond * 2**-23``: there the port is held to that
    bound around the float64 solution of its own observations, and the
    reference, whose float32 LU differs, to being finite."""
    w = (res.done & (res.profile == int(ProfileTag.REMOTE))).numpy().astype(np.float64)
    X = np.stack([res.size_mb.numpy(), res.conth_mb.numpy(), res.conpr_mb.numpy()],
                 -1).astype(np.float64) * w[..., None]
    y = res.transfer_time.numpy().astype(np.float64) * w
    A = np.einsum("...ni,...nj->...ij", X, X) + 1e-8 * np.eye(3)
    exact = np.linalg.solve(A, np.einsum("...ni,...n->...i", X, y)[..., None])[..., 0]
    cond = np.linalg.cond(A)
    got, want = got.reshape(exact.shape), want.reshape(exact.shape)
    ok = cond < 1e4
    assert ok.mean() > 0.5
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-6)
    bound = 4 * cond[..., None] * 2.0**-23 * np.abs(exact).max(-1, keepdims=True) + 1e-6
    assert (np.abs(got - exact) <= bound).all()
    assert np.isfinite(want).all()


def test_presimulate_bank_matches_reference(fleets):
    ref, port = fleets
    key = jax.random.PRNGKey(3)
    wt, wx, ws = ref.presimulate(rcal.PriorBox.paper(), key, 4, batch=4)
    gt, gx, gs = port.presimulate(pcal.PriorBox.paper(), _t(key), 4, batch=4)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    # the runs behind the tuples, from the same per-draw params and keys:
    # every done tick equal
    _, sub = jax.random.split(key)
    _, ks = jax.random.split(sub)
    keys = jax.random.split(ks, N * 4).reshape(N, 4, 2)
    keep, mask, link_scale = pcal.make_theta_mapper(port.bank, device="cpu").args
    th = gt.reshape(N, 4, 3)
    params = repro_torch.SimParams(
        keep_frac=torch.where(mask[:, None], 1.0 - th[..., 0:1], keep[:, None]),
        bg_mu=th[..., 1:2] * link_scale[:, None],
        bg_sigma=th[..., 2:3] * link_scale[:, None],
    )
    got = port.run(params, keys=_t(keys))
    want = ref.run(repro.SimParams(*(jnp.asarray(f.numpy()) for f in params[:3])),
                   keys=keys, lowering="banked")
    for f in ("done", "ticks", "transfer_time", "start_tick"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(pcal._eq1_coefficients(got).reshape(-1, 3).numpy(), gx.numpy())
    _assert_fits_close(gx.numpy(), np.asarray(wx), got)


def test_validate_bank_matches_reference(fleets):
    ref, port = fleets
    theta = np.random.default_rng(2).uniform([0, 0, 0], [0.1, 50, 20], (N, 3)).astype(np.float32)
    x_true = np.random.default_rng(3).uniform(0.01, 0.2, (N, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = ref.validate(jnp.asarray(theta), jnp.asarray(x_true), key, n_sims=4)
    got = port.validate(torch.from_numpy(theta), torch.from_numpy(x_true), _t(key), n_sims=4)
    assert got["scenario_names"] == want["scenario_names"]
    runs = port.run(torch.from_numpy(theta), keys=prng.split(_t(key), N * 4).reshape(N, 4, 2))
    _assert_fits_close(got["coefficients"], want["coefficients"], runs)
    # the summaries are the reference's functions of the port's coefficients
    c = jnp.asarray(got["coefficients"])
    err = np.abs(x_true[:, None] - got["coefficients"]) / np.abs(x_true[:, None])
    np.testing.assert_allclose(got["errors"], err, rtol=1e-6)
    np.testing.assert_array_equal(got["median_coef"], np.asarray(jnp.median(c, axis=1)))
    np.testing.assert_allclose(got["mean_abs_error"], err.mean(1), rtol=1e-6)
    np.testing.assert_allclose(got["sum_error"], err.sum(2), rtol=1e-6)


def test_median_is_jnp_median():
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 6, 2)).astype(np.float32))
    x[1, 2, 0] = float("nan")
    for n in (5, 6):
        np.testing.assert_array_equal(pcal._median(x[:, :n], 1).numpy(),
                                      np.asarray(jnp.median(jnp.asarray(x[:, :n].numpy()), axis=1)))


# -- end to end ---------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated(fleets):
    ref, port = fleets
    theta = [0.05, 40.0, 20.0]
    x_ref = np.asarray(ref.coefficients(jnp.asarray(theta), replicas=2,
                                        key=jax.random.PRNGKey(42))).mean(1)
    x_port = port.coefficients(torch.tensor(theta), replicas=2, key=prng.PRNGKey(42)).mean(1)
    np.testing.assert_allclose(x_port.numpy(), x_ref, rtol=1e-4, atol=1e-6)
    want = ref.calibrate(jnp.asarray(x_ref), jax.random.PRNGKey(0),
                         rcal.CalibrationConfig(**SMOKE), amortized=True)
    got = port.calibrate(torch.from_numpy(x_ref), prng.PRNGKey(0),
                         pcal.CalibrationConfig(**SMOKE), amortized=True)
    return want, got


def test_amortized_calibrate_matches_reference(calibrated):
    want, got = calibrated
    assert isinstance(got, pcal.AmortizedPosterior)
    np.testing.assert_array_equal(got.features.numpy(), np.asarray(want.features))
    assert got.scenario_names == want.scenario_names
    for k, v in want.classifier_params.items():
        np.testing.assert_allclose(got.classifier_params[k].numpy(), np.asarray(v), atol=1e-4)
    key = jax.random.PRNGKey(1)
    ts = got.theta_star_all(_t(key)).numpy()
    assert ts.shape == (N, 3) and np.isfinite(ts).all()
    assert (np.abs(ts - np.asarray(want.theta_star_all(key))) <= BIN * 1.001).all()


def test_theta_star_all_is_the_per_scenario_loop(calibrated):
    _, got = calibrated
    key = prng.PRNGKey(1)
    batched, stats = got.theta_star_all(key, return_stats=True)
    looped = torch.stack([got.theta_star(i, prng.fold_in(key, i)) for i in range(N)])
    assert torch.equal(batched, looped)
    assert stats["accept_rate"].shape == (N,) and stats["rhat"].shape == (N, 3)
    res, rhat = got.mcmc(3, prng.fold_in(key, 3))
    assert float(res.accept_rate) == float(stats["accept_rate"][3])
    assert torch.equal(rhat, stats["rhat"][3])
    assert torch.equal(got.theta_star(got.scenario_names[2], prng.fold_in(key, 2)), looped[2])


def test_calibrate_not_amortized_matches_reference(fleets):
    ref, port = fleets
    x = np.array([0.06, 0.02, 0.01], np.float32)
    cfg = dict(SMOKE, n_chains=2, n_mcmc=150)
    want = ref.calibrate(jnp.asarray(x), jax.random.PRNGKey(4), rcal.CalibrationConfig(**cfg))
    got = port.calibrate(torch.from_numpy(x), prng.PRNGKey(4), pcal.CalibrationConfig(**cfg))
    assert isinstance(got, pcal.CalibrationResult)
    assert (np.abs(got.theta_star.numpy() - np.asarray(want.theta_star)) <= BIN * 1.001).all()
    np.testing.assert_allclose(got.posterior_samples.numpy(),
                               np.asarray(want.posterior_samples), rtol=1e-4, atol=1e-3)
    assert float(got.accept_rate) == float(want.accept_rate)


# -- the per-campaign path (one compiled campaign) -----------------------------

@pytest.fixture(scope="module")
def campaign():
    """A small campaign compiled by both packages (20 legs), its specs and
    theta mappers."""
    from repro.core import engine as reng
    from repro.core import workload as rwork
    from repro_torch.core import engine as peng
    from repro_torch.core import workload as pwork

    kw = dict(seed=0, n_observations=20, n_waves=3)
    rt = rwork.compile_campaign(*rwork.wlcg_production_workload(**kw))
    pt = pwork.compile_campaign(*pwork.wlcg_production_workload(**kw))
    return dict(
        rt=rt, pt=pt, rspec=reng.SimSpec.from_table(rt, max_ticks=3_000),
        pspec=peng.SimSpec.from_table(pt, max_ticks=3_000, device="cpu"),
        rmap=rcal.make_theta_mapper(rt), pmap=pcal.make_theta_mapper(pt, device="cpu"),
    )


def _runs(cam, params, keys, leap):
    """The port's runs behind a set of coefficients."""
    from repro_torch.core import engine as peng

    return peng.simulate_batch(cam["pspec"], params, keys, leap=leap)


@pytest.mark.parametrize("n_rep,leap", [(1, False), (3, True)], ids=["1-tick", "3-leap"])
def test_simulate_coefficients_matches_reference(campaign, n_rep, leap):
    """The coefficient triple of one campaign under one theta, single and
    replicated (the mean of ``split(key, n)`` replicates): every run's fit
    against the reference's, and the mean of the port's own fits."""
    from repro.core import engine as reng

    theta = np.array([0.02, 36.9, 14.4], np.float32)
    key = jax.random.PRNGKey(42)
    want = rcal.simulate_coefficients(campaign["rspec"], campaign["rmap"](jnp.asarray(theta)),
                                      key, n_replicates=n_rep, leap=leap)
    params = campaign["pmap"](torch.from_numpy(theta))
    got = pcal.simulate_coefficients(campaign["pspec"], params, _t(key),
                                     n_replicates=n_rep, leap=leap)
    assert got.shape == (3,)
    keys = jax.random.split(key, n_rep) if n_rep > 1 else key[None]
    runs = _runs(campaign, params, _t(keys), leap)
    per_run = pcal._eq1_coefficients(runs)
    np.testing.assert_array_equal(got.numpy(), per_run.mean(0).numpy())
    ref_runs = reng.simulate_batch(campaign["rspec"], campaign["rmap"](jnp.asarray(theta)),
                                   keys, leap=leap)
    want_per_run = np.asarray(jax.vmap(rcal._eq1_coefficients)(ref_runs))
    _assert_fits_close(per_run.numpy(), want_per_run, runs)
    np.testing.assert_allclose(np.asarray(want), want_per_run.mean(0), rtol=1e-6, atol=1e-7)


def test_per_campaign_paths_raise(campaign):
    """The per-campaign presimulation against the reference's (it raised
    before the per-campaign engine was ported): thetas bitwise, every done
    tick of the runs behind the tuples equal, the fits close; and the one
    per-campaign call that still raises, an amortized calibration without
    presimulated tuples."""
    key = jax.random.PRNGKey(3)
    prior = rcal.PriorBox.paper()
    wt, wx = rcal.presimulate(campaign["rspec"], campaign["rmap"], prior, key, 7,
                              batch=4, leap=True)
    gt, gx = pcal.presimulate(campaign["pspec"], campaign["pmap"], pcal.PriorBox.paper(),
                              _t(key), 7, batch=4, leap=True)
    assert gt.shape == (7, 3) and gx.shape == (7, 3)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    # the runs behind the tuples: per chunk key, sub = split(key),
    # kt, ks = split(sub), one key per theta from split(ks, batch)
    k, keys = key, []
    for _ in range(2):
        k, sub = jax.random.split(k)
        _, ks = jax.random.split(sub)
        keys.append(np.asarray(jax.random.split(ks, 4)))
    theta8, _ = pcal.presimulate(campaign["pspec"], campaign["pmap"], pcal.PriorBox.paper(),
                                 _t(key), 8, batch=4, leap=True)
    runs = _runs(campaign, campaign["pmap"](theta8), _t(np.concatenate(keys)), True)
    x8 = pcal._eq1_coefficients(runs)
    np.testing.assert_array_equal(x8[:7].numpy(), gx.numpy())
    _assert_fits_close(gx.numpy(), np.asarray(wx), type(runs)(*(f[:7] for f in runs)))
    with pytest.raises(ValueError, match="scenario_id"):
        pcal.calibrate(campaign["pspec"], campaign["pt"], torch.zeros(3), prng.PRNGKey(0),
                       amortized=True)


def test_validate_matches_reference(campaign):
    theta = np.array([0.03, 30.0, 10.0], np.float32)
    x_true = np.array([0.06, 0.02, 0.01], np.float32)
    key = jax.random.PRNGKey(9)
    want = rcal.validate(campaign["rspec"], campaign["rt"], jnp.asarray(theta),
                         jnp.asarray(x_true), key, n_sims=4, n_replicates=2)
    got = pcal.validate(campaign["pspec"], campaign["pt"], torch.from_numpy(theta),
                        torch.from_numpy(x_true), _t(key), n_sims=4, n_replicates=2)
    assert got["coefficients"].shape == (4, 3)
    np.testing.assert_allclose(got["coefficients"], want["coefficients"], rtol=1e-4, atol=1e-6)
    c = got["coefficients"]
    err = np.abs(x_true - c) / np.abs(x_true)
    np.testing.assert_allclose(got["errors"], err, rtol=1e-6)
    np.testing.assert_array_equal(got["median_coef"], np.asarray(jnp.median(jnp.asarray(c), axis=0)))
    np.testing.assert_allclose(got["mean_abs_error"], err.mean(0), rtol=1e-6)
    np.testing.assert_allclose(got["sum_error"], err.sum(1), rtol=1e-6)


def test_calibrate_per_campaign_matches_reference(campaign):
    """calibrate(presim=None) on one campaign: presimulation, training and
    MCMC from the same key in both packages."""
    x = np.array([0.06, 0.02, 0.01], np.float32)
    cfg = dict(SMOKE, n_presim=16, batch_size=8, n_replicates=1)
    want = rcal.calibrate(campaign["rspec"], campaign["rt"], jnp.asarray(x),
                          jax.random.PRNGKey(4), rcal.CalibrationConfig(**cfg))
    got = pcal.calibrate(campaign["pspec"], campaign["pt"], torch.from_numpy(x),
                         prng.PRNGKey(4), pcal.CalibrationConfig(**cfg))
    assert isinstance(got, pcal.CalibrationResult)
    for k, v in want.classifier_params.items():
        np.testing.assert_allclose(got.classifier_params[k].numpy(), np.asarray(v), atol=1e-4)
    assert (np.abs(got.theta_star.numpy() - np.asarray(want.theta_star)) <= BIN * 1.001).all()
    np.testing.assert_allclose(got.posterior_samples.numpy(),
                               np.asarray(want.posterior_samples), rtol=1e-4, atol=1e-3)
    assert float(got.accept_rate) == float(want.accept_rate)
    assert np.isfinite(got.rhat.numpy()).all()


def test_calibration_entry_points_default_to_cuda(fleets, net):
    """Without a device the calibration entry points want CUDA and raise
    where there is none; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    _, port = fleets
    with pytest.raises(RuntimeError, match="CUDA"):
        pcal.make_theta_mapper(port.bank)
    with pytest.raises(RuntimeError, match="CUDA"):
        classifier_from_reference(net[0])


def test_config_defaults_match_reference():
    assert dataclasses.asdict(pcal.CalibrationConfig()) == dataclasses.asdict(rcal.CalibrationConfig())
    assert dataclasses.asdict(pclf.ClassifierConfig()) == dataclasses.asdict(rclf.ClassifierConfig())
    box = pcal.PriorBox.paper()
    np.testing.assert_array_equal(box.high.numpy(), np.asarray(rcal.PriorBox.paper().high))

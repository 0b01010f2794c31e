"""The port's bucketed dispatch (``simulate_bank`` on a ``BucketedBank``)
on the CPU.

Within the port, a bucketed run is bitwise its monolithic run: tick, leap
and stochastic (``bg_sigma`` 1.5), under cost and count packing, with
singleton buckets folded over the replica axis, shard-padded buckets and
per-replica params. Against the reference's bucketed run on the same
layout (leap-cost packing, which both packages compute alike), including
a scale-3 fleet whose long-tail bucket passes T 128: ``done``, ``ticks``,
``transfer_time`` and ``start_tick`` equal, ``conth_mb`` and ``conpr_mb``
within rtol 1e-5 / atol 1e-4."""
import numpy as np
import pytest
import torch

import repro
from repro.core import engine as ref_engine
from repro_torch import Fleet, PriorBox, SimParams, simulate_bank
from repro_torch.core import engine, prng
from repro_torch.core.scenarios import sample_scenarios
from repro_torch.core.workload import PAD_PROFILE, compile_bank

N, R, MAX_TICKS = 8, 4, 400
EXACT = ("done", "ticks", "transfer_time", "start_tick", "size_mb", "profile")
CLOSE = ("conth_mb", "conpr_mb")
STOCHASTIC = dict(bg_mu=2.0, bg_sigma=1.5)


def _assert_bitwise(a, b, msg=""):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), msg + f


def _assert_matches(port, ref, msg=""):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=msg + f)
    for f in CLOSE:
        np.testing.assert_allclose(getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=1e-4, err_msg=msg + f)


def _fleet(leap, **kw):
    return Fleet.from_scenarios(n=N, seed=0, max_ticks=MAX_TICKS, n_buckets=3, leap=leap,
                                device="cpu", **kw)


def _has_singleton(bank):
    return any(b.bank.n_scenarios == 1 for b in bank.buckets)


@pytest.mark.parametrize("stochastic", [False, True], ids=["sigma0", "sigma1.5"])
@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_bucketed_equals_monolithic_bitwise(leap, stochastic):
    fleet = _fleet(leap)
    assert fleet.n_buckets > 1 and _has_singleton(fleet.bank)
    params = fleet.params(**(STOCHASTIC if stochastic else {}))
    engine.STATS["buckets"] = 0
    got = fleet.run(params, replicas=R, window=4)
    assert engine.STATS["buckets"] == fleet.n_buckets
    assert int(got.done.sum()) > 0
    _assert_bitwise(got, fleet.run(params, replicas=R, window=4, bucketed=False))
    if stochastic:
        _assert_bitwise(got, fleet.run(params, replicas=R, window=4, lowering="vmap"), "vmap ")


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_bucketed_matches_reference_on_the_same_layout(leap):
    """Both fleets packed by leap costs (the same plan in both packages),
    run in ``leap`` mode, stochastic."""
    ref_fleet = repro.Fleet.from_scenarios(n=N, seed=0, max_ticks=MAX_TICKS, n_buckets=3,
                                           leap=True)
    fleet = _fleet(True)
    assert [list(b.scenario_ids) for b in fleet.bank.buckets] == [
        list(b.scenario_ids) for b in ref_fleet.bank.buckets]
    want = ref_fleet.run(ref_fleet.params(**STOCHASTIC), replicas=2, leap=leap,
                         lowering="banked", window=8)
    _assert_matches(fleet.run(fleet.params(**STOCHASTIC), replicas=2, leap=leap, window=8), want)


def test_padding_contract_per_bucket():
    """Past each scenario's own legs (its bucket's pads, then the fleet's),
    every leg reads born done, zero transfer and ``PAD_PROFILE``."""
    fleet = _fleet(False)
    res = fleet.run(fleet.params(**STOCHASTIC), replicas=R, window=4)
    n_legs = np.asarray(fleet.bank.n_legs)
    assert any(b.bank.pad_legs < fleet.pad_legs for b in fleet.bank.buckets)
    for b in fleet.bank.buckets:
        for i in b.scenario_ids:
            tail = slice(int(n_legs[i]), None)
            assert bool(res.done[i, :, tail].all())
            assert bool((res.profile[i, :, tail] == PAD_PROFILE).all())
            for f in ("transfer_time", "size_mb", "conth_mb", "conpr_mb", "start_tick"):
                assert bool((getattr(res, f)[i, :, tail] == 0).all()), f


def test_cost_and_count_packing_agree_bitwise():
    cost, count = _fleet(True), _fleet(True, bucket_packing="count")
    assert cost.bank.packing == "cost" and count.bank.packing == "count"
    assert [list(b.scenario_ids) for b in cost.bank.buckets] != [
        list(b.scenario_ids) for b in count.bank.buckets]
    params = cost.params(**STOCHASTIC)
    a = cost.run(params, replicas=R, leap=False, window=4)
    _assert_bitwise(a, count.run(params, replicas=R, leap=False, window=4))
    _assert_bitwise(a, cost.run(params, replicas=R, leap=False, window=4, bucketed=False))


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("replicas", [6, 8])
def test_singleton_folds_and_shard_padded_buckets(replicas, shards):
    """Singleton buckets fold ``[1, R]`` into ``[fold, R / fold]`` (fold 2
    at R 6, 8 at R 8); ``shards=2`` pads every bucket to an even scenario
    count (no fold then). Both bitwise the monolithic run."""
    bank = compile_bank(sample_scenarios(None, N, 0), max_ticks=MAX_TICKS, n_buckets=3,
                        shards=shards)
    assert _has_singleton(bank) == (shards == 1)
    if shards == 2:
        assert any(b.bank.n_scenarios > len(b.scenario_ids) for b in bank.buckets)
    params = engine.make_bank_params(bank, device="cpu", **STOCHASTIC)
    keys = prng.split(prng.PRNGKey(5), N * replicas).reshape(N, replicas, 2)
    got = simulate_bank(bank, params, keys, window=4, device="cpu")
    _assert_bitwise(got, simulate_bank(bank, params, keys, window=4, bucketed=False,
                                       device="cpu"))


def test_per_replica_params_do_not_fold():
    fleet = _fleet(False)
    base = fleet.params(**STOCHASTIC)
    scale = torch.linspace(0.85, 1.0, R)[None, :, None]
    params = SimParams(keep_frac=base.keep_frac[:, None] * scale,
                       bg_mu=base.bg_mu[:, None] * scale, bg_sigma=base.bg_sigma[:, None] * scale)
    got = fleet.run(params, replicas=R, window=4)
    _assert_bitwise(got, fleet.run(params, replicas=R, window=4, bucketed=False))


def test_replica_fold_matches_reference():
    for r in range(1, 17):
        assert engine._replica_fold(r) == ref_engine._replica_fold(r), r


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_long_tail_fleet_past_128_legs_matches_reference(leap):
    """Scale 3 (seeds 14-20): scenario 4 has 140 legs and 140 processes,
    a singleton bucket past the card's narrow kernels."""
    kw = dict(n=7, seed=14, scale=3.0, max_ticks=300, n_buckets=3, leap=True)
    ref_fleet = repro.Fleet.from_scenarios(**kw)
    fleet = Fleet.from_scenarios(**kw, device="cpu")
    assert max(b.bank.pad_legs for b in fleet.bank.buckets) > 128
    want = ref_fleet.run(ref_fleet.params(**STOCHASTIC), replicas=2, leap=leap,
                         lowering="banked", window=8)
    got = fleet.run(fleet.params(**STOCHASTIC), replicas=2, leap=leap, window=8)
    _assert_matches(got, want)
    _assert_bitwise(got, fleet.run(fleet.params(**STOCHASTIC), replicas=2, leap=leap, window=8,
                                   bucketed=False))


def test_presimulate_through_a_bucketed_fleet():
    """Per-(scenario, draw) params ``[N, B, X]`` gathered bucket by bucket:
    the tuples equal the monolithic fleet's bitwise."""
    bucketed = _fleet(True)
    mono = Fleet.from_scenarios(n=N, seed=0, max_ticks=MAX_TICKS, leap=True, device="cpu")
    prior = PriorBox.paper()
    got = bucketed.presimulate(prior, prng.PRNGKey(3), 3, batch=3)
    want = mono.presimulate(prior, prng.PRNGKey(3), 3, batch=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())

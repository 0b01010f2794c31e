"""The port's ``Fleet`` persistence, stream and compile cache on the CPU.

Save / load round trips (monolithic, bucketed, shard-padded singletons)
run bitwise as the saved fleet. Directories cross between the packages in
the reference's format 1: a reference ``Fleet.save`` / ``save_checkpoint``
directory loads in the port and a port one in the reference, each run (or
resumed) within the parity standard of the other package's loaded fleet
(``done``, ``ticks``, ``transfer_time``, ``start_tick`` equal; ``conth_mb``,
``conpr_mb`` within rtol 1e-5 / atol 1e-4). Corrupt directories raise
``ValueError``. Stream chunks equal standalone ``simulate_bank`` runs under
the documented key schedule, and ``prefetch=1`` equals ``prefetch=0``
bitwise."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro
from repro.core import engine as ref_engine
from repro_torch import Fleet, simulate_bank
from repro_torch.core import calibration, engine, fleet as fleet_lib, prng
from repro_torch.core.engine import simulate_bank_stepped
from repro_torch.core.scenarios import sample_scenarios
from repro_torch.core.workload import bank_from_tables, compile_bank, compile_campaign

N, R, MAX_TICKS = 6, 2, 300
EXACT = ("done", "ticks", "transfer_time", "start_tick", "size_mb", "profile")
CLOSE = ("conth_mb", "conpr_mb")
STOCHASTIC = dict(bg_mu=2.0, bg_sigma=1.5)
RUN_OPTS = {"lowering", "leap", "backend", "window", "resolved_window"}


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


def _keys(seed=4):
    return prng.split(prng.PRNGKey(seed), N * R).reshape(N, R, 2)


def _ref_keys(seed=4):
    return jax.random.split(jax.random.PRNGKey(seed), N * R).reshape(N, R, 2)


def _port_fleet(kind):
    if kind == "shard-padded":
        bank = compile_bank(sample_scenarios(None, N, 1), max_ticks=MAX_TICKS, n_buckets=3,
                            shards=2)
        return Fleet(bank, leap=True, device="cpu")
    n_buckets = 3 if kind == "bucketed" else 1
    return Fleet.from_scenarios(n=N, seed=1, max_ticks=MAX_TICKS, n_buckets=n_buckets,
                                leap=True, device="cpu")


@pytest.mark.parametrize("kind", ["monolithic", "bucketed", "shard-padded"])
def test_save_load_round_trip(tmp_path, kind):
    fleet = _port_fleet(kind)
    path = fleet.save(str(tmp_path / "fleet"))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert set(meta["run_opts"]) == RUN_OPTS and meta["run_opts"]["backend"] is None
    assert meta["run_opts"]["resolved_window"] == engine.default_tick_window(True, "cpu")
    loaded = Fleet.load(path, device="cpu")
    assert loaded.leap and loaded.window == meta["run_opts"]["resolved_window"]
    assert loaded.names == fleet.names and loaded.pads == fleet.pads
    assert loaded.n_buckets == fleet.n_buckets
    assert loaded.bucket_pad_floors == fleet.bucket_pad_floors
    if kind != "monolithic":
        assert [b.bank.n_scenarios for b in loaded.bank.buckets] == [
            b.bank.n_scenarios for b in fleet.bank.buckets]
    with pytest.raises(ValueError, match="no source tables"):
        loaded.bank.scenario_table(0)
    params = fleet.params(**STOCHASTIC)
    _assert_bitwise(loaded.run(params, replicas=R), fleet.run(params, replicas=R))
    assert Fleet.load(path, device="cpu", leap=False, window=3).window == 3


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_reference_save_loads_in_the_port(tmp_path, leap):
    rf = repro.Fleet.from_scenarios(n=N, seed=1, max_ticks=MAX_TICKS, n_buckets=3, leap=True,
                                    window=4)
    path = rf.save(str(tmp_path / "ref"))
    ref_loaded = repro.Fleet.load(path)
    loaded = Fleet.load(path, device="cpu")
    assert loaded.window == 4 and loaded.n_buckets == ref_loaded.n_buckets
    assert loaded.bucket_pad_floors == [
        (b.bank.pad_legs, b.bank.pad_procs, b.bank.pad_links) for b in ref_loaded.bank.buckets]
    want = ref_loaded.run(ref_loaded.params(**STOCHASTIC), replicas=R, leap=leap,
                          lowering="banked")
    got = loaded.run(loaded.params(**STOCHASTIC), replicas=R, leap=leap)
    _assert_matches(got, want)
    _assert_bitwise(got, loaded.run(loaded.params(**STOCHASTIC), replicas=R, leap=leap,
                                    bucketed=False))


def test_port_save_loads_in_the_reference(tmp_path):
    fleet = _port_fleet("bucketed")
    path = fleet.save(str(tmp_path / "port"))
    ref_loaded = repro.Fleet.load(path)
    loaded = Fleet.load(path, device="cpu")
    assert ref_loaded.window == loaded.window == 1
    assert [list(b.scenario_ids) for b in ref_loaded.bank.buckets] == [
        list(b.scenario_ids) for b in loaded.bank.buckets]
    want = ref_loaded.run(ref_loaded.params(**STOCHASTIC), replicas=R, lowering="banked")
    _assert_matches(loaded.run(loaded.params(**STOCHASTIC), replicas=R), want)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    rf = repro.Fleet.from_scenarios(n=N, seed=1, max_ticks=MAX_TICKS, window=4)
    ckpts = []
    ref_engine.simulate_bank_stepped(rf.bank, rf.params(**STOCHASTIC), _ref_keys(), window=4,
                                     checkpoint_every=4, on_checkpoint=ckpts.append)
    path = rf.save_checkpoint(str(tmp_path / "ck"), ckpts[len(ckpts) // 2])
    ref_fleet, ref_ck = repro.Fleet.load(path), repro.Fleet.load_checkpoint(path)
    want = ref_engine.simulate_bank_stepped(ref_fleet.bank, ref_fleet.params(**STOCHASTIC),
                                            _ref_keys(), window=4, resume=ref_ck)
    loaded, ck = Fleet.load(path, device="cpu"), Fleet.load_checkpoint(path)
    assert ck.carry.key.dtype == np.int64 and ck.windows_done == ref_ck.windows_done
    np.testing.assert_array_equal(ck.carry.key, np.asarray(ref_ck.carry.key))
    got = simulate_bank_stepped(loaded.bank, loaded.params(**STOCHASTIC), _keys(), window=4,
                                resume=ck, device="cpu")
    _assert_matches(got, want)


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    fleet = Fleet.from_scenarios(n=N, seed=1, max_ticks=MAX_TICKS, window=4, device="cpu")
    params = fleet.params(**STOCHASTIC)
    ckpts = []
    one_shot = simulate_bank_stepped(fleet.bank, params, _keys(), window=4, device="cpu",
                                     checkpoint_every=4, on_checkpoint=ckpts.append)
    path = fleet.save_checkpoint(str(tmp_path / "ck"), ckpts[len(ckpts) // 2])
    with np.load(os.path.join(path, "carry.npz")) as z:
        assert z["key"].dtype == np.uint32
    loaded, ck = Fleet.load(path, device="cpu"), Fleet.load_checkpoint(path)
    got = simulate_bank_stepped(loaded.bank, loaded.params(**STOCHASTIC), _keys(), window=4,
                                resume=ck, device="cpu")
    _assert_bitwise(got, one_shot)
    ref_fleet, ref_ck = repro.Fleet.load(path), repro.Fleet.load_checkpoint(path)
    want = ref_engine.simulate_bank_stepped(ref_fleet.bank, ref_fleet.params(**STOCHASTIC),
                                            _ref_keys(), window=4, resume=ref_ck)
    _assert_matches(got, want)


def test_corrupt_directories_raise_value_error(tmp_path):
    fleet = _port_fleet("monolithic")
    ckpts = []
    simulate_bank_stepped(fleet.bank, fleet.params(), _keys(), window=4, device="cpu",
                          checkpoint_every=2, on_checkpoint=ckpts.append)
    good = fleet.save_checkpoint(str(tmp_path / "good"), ckpts[0])
    with pytest.raises(ValueError):
        Fleet.load(str(tmp_path / "missing"), device="cpu")
    with pytest.raises(ValueError):
        Fleet.load_checkpoint(str(tmp_path / "missing"))

    def broken(name, edit):
        d = tmp_path / name
        fleet.save_checkpoint(str(d), ckpts[0])
        edit(d)
        return str(d)

    truncate = lambda f: lambda d: (d / f).write_bytes((d / f).read_bytes()[:40])
    for d in (broken("meta_format", lambda d: (d / "meta.json").write_text('{"format": 2}')),
              broken("meta_text", lambda d: (d / "meta.json").write_text("{not json")),
              broken("bank_cut", truncate("bank.npz")),
              broken("bank_field", lambda d: np.savez(d / "bank.npz", size_mb=np.zeros(3)))):
        with pytest.raises(ValueError):
            Fleet.load(d, device="cpu")
    for d in (broken("ck_format", lambda d: (d / "checkpoint.json").write_text('{"format": 9}')),
              broken("ck_cut", truncate("carry.npz")),
              broken("ck_field", lambda d: np.savez(d / "carry.npz", t=np.zeros(3)))):
        with pytest.raises(ValueError):
            Fleet.load_checkpoint(d)
    assert Fleet.load_checkpoint(good).windows_done == ckpts[0].windows_done


def test_compile_cache():
    fleet_lib.clear_compile_cache()
    kw = dict(n=3, seed=5, max_ticks=100, device="cpu")
    a = Fleet.from_scenarios(**kw)
    assert Fleet.from_scenarios(**kw).bank is a.bank
    for other in (dict(leap=True), dict(n_buckets=2), dict(max_ticks=120),
                  dict(pad_floors=(64, 1, 1)), dict(bucket_slack=2.0), dict(cache=False)):
        assert Fleet.from_scenarios(**{**kw, **other}).bank is not a.bank, other
    calls = []

    def pairs():
        calls.append(1)
        return sample_scenarios(None, 3, 5)

    b = Fleet.from_pairs(pairs, cache_key="three", max_ticks=100, device="cpu")
    assert Fleet.from_pairs(pairs, cache_key="three", max_ticks=100, device="cpu").bank is b.bank
    assert len(calls) == 1
    for i in range(fleet_lib._COMPILE_CACHE_MAX):
        fleet_lib._cache_put(("filler", i), i)
    assert len(fleet_lib._compile_cache) == fleet_lib._COMPILE_CACHE_MAX
    assert Fleet.from_pairs(pairs, cache_key="three", max_ticks=100,
                            device="cpu").bank is not b.bank  # evicted first in, first out
    assert fleet_lib._cache_get(("filler", 0)) is None
    assert fleet_lib._cache_get(("filler", fleet_lib._COMPILE_CACHE_MAX - 1)) is not None
    fleet_lib.clear_compile_cache()
    assert not fleet_lib._compile_cache


def test_compile_cache_under_threads():
    """Puts from more threads than cores, the interpreter switching threads
    every microsecond: the FIFO bound holds and no put is lost past it."""
    import sys
    import threading

    fleet_lib.clear_compile_cache()
    n_threads, n_puts = 4 * (os.cpu_count() or 1), 200
    errors = []

    def put(k):
        try:
            for i in range(n_puts):
                fleet_lib._cache_put((k, i), i)
                assert len(fleet_lib._compile_cache) <= fleet_lib._COMPILE_CACHE_MAX
        except AssertionError as e:
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=put, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(fleet_lib._compile_cache) == fleet_lib._COMPILE_CACHE_MAX
    fleet_lib.clear_compile_cache()


def test_stream_chunks_equal_standalone_runs():
    pairs = sample_scenarios(None, 7, 3)
    fleet = Fleet.from_pairs(pairs, max_ticks=MAX_TICKS, device="cpu")
    theta = [0.05, 2.0, 1.5]
    runs = {p: list(fleet.stream(iter(pairs), chunk=3, params_or_theta=theta, replicas=R,
                                 key=prng.PRNGKey(7), max_ticks=MAX_TICKS, window=4,
                                 prefetch=p))
            for p in (0, 1)}
    assert [len(c.names) for c in runs[0]] == [3, 3, 1]
    key = prng.PRNGKey(7)
    for i, (c0, c1) in enumerate(zip(runs[0], runs[1])):
        assert c0.names == c1.names == [c.name for _, c in pairs[3 * i:3 * i + 3]]
        _assert_bitwise(c0.result, c1.result, f"chunk {i} ")
        block = pairs[3 * i:3 * i + 3]
        tables = [compile_campaign(g, c) for g, c in block]
        tables += [tables[-1]] * (3 - len(tables))
        cbank = bank_from_tables(tables, max_ticks=MAX_TICKS, pad_legs=fleet.pad_legs,
                                 pad_procs=fleet.pad_procs, pad_links=fleet.pad_links)
        key, sub = prng.split(key, 2)
        keys = prng.split(sub, 3 * R).reshape(3, R, 2)
        params = calibration.make_theta_mapper(cbank, "webdav", missing_ok=True,
                                               device="cpu")(torch.tensor(theta))
        want = simulate_bank(cbank, params, keys, window=4, device="cpu")
        _assert_bitwise(c0.result, type(want)(*(f[:len(block)] for f in want)), f"chunk {i} ")
    with pytest.raises(TypeError, match="fixed SimParams"):
        fleet.stream(iter(pairs), params_or_theta=fleet.params())
    with pytest.raises(ValueError, match="chunk"):
        fleet.stream(iter(pairs), chunk=0)
    small = Fleet.from_pairs(pairs[:2], max_ticks=MAX_TICKS, device="cpu")
    with pytest.raises(ValueError, match="outgrew"):
        list(small.stream(iter(pairs), chunk=7))


def test_fleet_surface():
    fleet = Fleet.from_scenarios(n=N, seed=1, max_ticks=MAX_TICKS, n_buckets=3, leap=True,
                                 lowering="vmap", device="cpu")
    ref_fleet = repro.Fleet.from_scenarios(n=N, seed=1, max_ticks=MAX_TICKS, n_buckets=3,
                                           leap=True)
    assert fleet.names == ref_fleet.names and fleet.pads == ref_fleet.pads
    assert (fleet.pad_legs, fleet.pad_procs, fleet.pad_links) == fleet.pads
    assert fleet.bucket_pad_floors == ref_fleet.bucket_pad_floors
    assert fleet.bucket_scenario_counts == ref_fleet.bucket_scenario_counts
    assert fleet.resident.spec is engine.bank_spec(fleet.bank, "cpu")
    params = fleet.params(**STOCHASTIC)
    _assert_bitwise(fleet.run(params, replicas=R), fleet.run(params, replicas=R,
                                                             lowering="banked"))
    mapper = calibration.make_bank_theta_mapper(fleet.bank, device="cpu")
    want = calibration.make_theta_mapper(fleet.bank, device="cpu")(torch.tensor([0.1, 3.0, 1.0]))
    for g, w in zip(mapper(torch.tensor([0.1, 3.0, 1.0])), want):
        assert g is None and w is None or torch.equal(g, w)

"""The port's serving layer (``repro_torch.serve``) on the CPU.

The reference's serving contracts (``tests/test_serve.py``), held against
the port's own ``Fleet.run``:

- **bitwise parity**: a served result equals a direct ``Fleet.run`` of the
  same scenario with the same theta and keys, bit for bit, tick and leap,
  with stochastic replicas, per-request thetas, coalesced rows, every rung
  of the window ladder, and unused replica lanes;
- **graceful drain**: every submitted request is answered exactly once,
  and a request that can never be admitted raises instead of spinning;
- the slot-template warm store round-trips.

Not carried from the reference: the sharded server (ROADMAP A.9) and the
trace budgets (torch has no traces: A.10's capture budget)."""
import os

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.fleet import Fleet
from repro_torch.core.scenarios import sample_scenarios
from repro_torch.core.workload import compile_campaign
from repro_torch.serve import ServeConfig, SimRequest, SimServer
from repro_torch.serve.cache import pad_signature, quantize_axis


def _server(**cfg):
    return SimServer(ServeConfig(**cfg), device="cpu")


def _assert_served_equals_direct(server, rid, grid, campaign, *, theta=None,
                                 keys=None, replicas=1, seed=0, leap=False):
    """Full bitwise row comparison: a single-scenario fleet at the served
    signature's pads, so every array shape matches exactly."""
    res = server.poll(rid)
    assert res is not None, f"request {rid} not served"
    fleet = Fleet.from_pairs([(grid, campaign)], pad_floors=res.signature, leap=leap,
                             device="cpu")
    if keys is not None:
        direct = fleet.run(theta, keys=torch.as_tensor(np.asarray(keys, np.int64))[None])
    else:
        direct = fleet.run(theta, replicas=replicas, key=prng.PRNGKey(seed))
    for f in direct._fields:
        a = getattr(direct, f)[0]
        b = getattr(res.result, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f"request {rid}: field {f!r} diverged"


# ---------------------------------------------------------------------------
# bitwise parity against Fleet.run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_served_bitwise_equals_fleet_run(leap):
    pairs = sample_scenarios(n=6, seed=0, scale=0.5)
    server = _server(slots=4, replicas=1, leap=leap)
    for i, (g, c) in enumerate(pairs):
        server.submit(SimRequest(rid=i, grid=g, campaign=c, seed=i))
    done = server.drain()
    assert sorted(r.rid for r in done) == list(range(6))
    for i, (g, c) in enumerate(pairs):
        _assert_served_equals_direct(server, i, g, c, seed=i, leap=leap)


def test_served_stochastic_replicas_and_theta():
    pairs = sample_scenarios(n=4, seed=2, scale=0.5)
    theta = np.asarray([0.15, 0.4, 0.2], np.float32)
    ks = prng.split(prng.PRNGKey(7), 4 * 3).reshape(4, 3, 2).numpy().astype(np.uint32)
    server = _server(slots=4, replicas=3)
    for i, (g, c) in enumerate(pairs):
        server.submit(SimRequest(rid=i, grid=g, campaign=c, theta=theta, n_replicas=3,
                                 keys=ks[i]))
    server.drain()
    for i, (g, c) in enumerate(pairs):
        _assert_served_equals_direct(server, i, g, c, theta=theta, keys=ks[i])
    # and against one multi-scenario Fleet.run (union pads): the served rows
    # match on the overlapping extent
    fleet = Fleet.from_pairs(pairs, device="cpu")
    direct = fleet.run(theta, keys=torch.as_tensor(ks.astype(np.int64)))
    for i in range(4):
        served = server.poll(i).result
        for f in direct._fields:
            a = getattr(direct, f)[i]
            b = getattr(served, f)
            sl = tuple(slice(0, min(x, y)) for x, y in zip(a.shape, b.shape))
            assert torch.equal(a[sl], b[sl]), f


def test_mixed_replica_counts_share_a_bank():
    (g1, c1), (g2, c2) = sample_scenarios(n=2, seed=5, scale=0.5)
    server = _server(slots=4, replicas=4)
    server.submit(SimRequest(rid=0, grid=g1, campaign=c1, n_replicas=4, seed=3))
    server.submit(SimRequest(rid=1, grid=g2, campaign=c2, n_replicas=1, seed=4))
    server.drain()
    _assert_served_equals_direct(server, 0, g1, c1, replicas=4, seed=3)
    _assert_served_equals_direct(server, 1, g2, c2, replicas=1, seed=4)


def test_leap_stochastic_parity():
    """Leap mode with a stochastic theta and several replicas: the event
    steps of the resident bank, bitwise the direct leap run."""
    pairs = sample_scenarios(n=3, seed=3, scale=0.5)
    theta = np.asarray([0.05, 2.0, 1.0], np.float32)
    server = _server(slots=2, replicas=2, leap=True)
    for i, (g, c) in enumerate(pairs):
        server.submit(SimRequest(rid=i, grid=g, campaign=c, theta=theta, n_replicas=2,
                                 seed=10 + i))
    server.drain()
    for i, (g, c) in enumerate(pairs):
        _assert_served_equals_direct(server, i, g, c, theta=theta, replicas=2, seed=10 + i,
                                     leap=True)


# ---------------------------------------------------------------------------
# graceful drain and rejections
# ---------------------------------------------------------------------------
def test_graceful_drain_no_request_lost_or_duplicated():
    pairs = sample_scenarios(n=6, seed=4, scale=0.5)
    server = _server(slots=2, replicas=1)
    for i, (g, c) in enumerate(pairs):
        server.submit(SimRequest(rid=i, grid=g, campaign=c, seed=i))
        server.step()
    first = server.drain()
    assert sorted(r.rid for r in first) == list(range(6))
    # drain is exactly-once: a second drain returns nothing new
    assert server.drain() == []
    m = server.metrics()
    assert m["completed"] == 6 and m["queued"] == 0 and m["resident"] == 0


def test_duplicate_rid_and_replica_overflow_rejected():
    (g, c), = sample_scenarios(n=1, seed=6, scale=0.5)
    server = _server(slots=2, replicas=1)
    server.submit(SimRequest(rid=0, grid=g, campaign=c))
    with pytest.raises(ValueError, match="duplicate request id"):
        server.submit(SimRequest(rid=0, grid=g, campaign=c))
    with pytest.raises(ValueError, match="replicas"):
        server.submit(SimRequest(rid=1, grid=g, campaign=c, n_replicas=3))
    with pytest.raises(KeyError):
        server.poll(999)


def test_drain_stall_raises_instead_of_spinning(monkeypatch):
    """A queued request that can never be admitted (every slot reported
    unavailable) ends drain with a message naming the stuck rid."""
    from repro_torch.serve import slots as slots_mod

    (g, c), = sample_scenarios(n=1, seed=11, scale=0.5)
    server = _server(slots=2, replicas=1)
    server.submit(SimRequest(rid=7, grid=g, campaign=c))
    monkeypatch.setattr(slots_mod.SlotBank, "free_slots", lambda self: [])
    with pytest.raises(RuntimeError, match=r"drain stalled.*\[7\]"):
        server.drain()
    assert server.rounds < 10, "stall must be detected immediately"


def test_round_one_rejects_unadmittable_queue_entry():
    """An oversized entry that reaches the queue past submit() fails the
    round loudly instead of being admitted into lanes that do not exist."""
    import dataclasses as dc

    (g, c), = sample_scenarios(n=1, seed=12, scale=0.5)
    server = _server(slots=2, replicas=1)
    server.submit(SimRequest(rid=3, grid=g, campaign=c))
    (sig, queue), = server.queues.items()
    pending = queue[0]
    bad_req = dc.replace(pending.admission.request, n_replicas=5)
    queue[0] = pending._replace(admission=dc.replace(pending.admission, request=bad_req))
    with pytest.raises(ValueError, match="request 3 asks for 5 replicas"):
        server.drain()


def test_server_without_device_wants_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        SimServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        SimServer(ServeConfig(slots=2))


def test_quantize_axis_emits_true_power_of_two_tiers():
    assert quantize_axis(5, 12) == 16
    assert quantize_axis(13, 12) == 16
    assert quantize_axis(17, 12) == 32
    assert quantize_axis(5, 8) == 8
    assert quantize_axis(9, 8) == 16
    assert quantize_axis(1, 1) == 1
    assert quantize_axis(3, 1) == 4
    for floor in (1, 3, 7, 8, 12, 100):
        for n in range(1, 300, 7):
            t = quantize_axis(n, floor)
            assert t >= n and t >= floor and (t & (t - 1)) == 0


def test_metrics_expose_slot_observability():
    pairs = sample_scenarios(n=5, seed=8, scale=0.5)
    server = _server(slots=4, replicas=1)
    for i, (g, c) in enumerate(pairs):
        server.submit(SimRequest(rid=i, grid=g, campaign=c, seed=i))
    server.drain()
    m = server.metrics()
    assert m["submitted"] == m["completed"] == 5
    assert m["mesh_devices"] == 0 and m["window"] == 8 and m["rungs"] == [2, 8, 32]
    assert set(m["wall_split_s"]) == {"admit", "dispatch", "sync", "retire"}
    for bank in m["slot_banks"].values():
        assert 0.0 <= bank["idle_window_fraction"] <= 1.0
        assert bank["occupancy_mean"] <= bank["slots"]
        assert bank["realized_ticks"] > 0
        assert bank["admitted"] == bank["retired"]


# ---------------------------------------------------------------------------
# overlap scheduler: deferred retirement, window ladder, coalescing
# ---------------------------------------------------------------------------
def test_per_request_theta_parity():
    pairs = sample_scenarios(n=3, seed=13, scale=0.5)
    thetas = [
        np.asarray([0.1, 0.3, 0.15], np.float32),
        np.asarray([0.25, 0.5, 0.05], np.float32),
        np.asarray([0.4, 0.2, 0.3], np.float32),
    ]
    server = _server(slots=2, replicas=2)
    for i, (g, c) in enumerate(pairs):
        server.submit(SimRequest(rid=i, grid=g, campaign=c, theta=thetas[i], n_replicas=2,
                                 seed=i))
    server.drain()
    for i, (g, c) in enumerate(pairs):
        _assert_served_equals_direct(server, i, g, c, theta=thetas[i], replicas=2, seed=i)


def test_window_ladder_parity_across_rungs():
    """The same workload through different ladders (one of them a single
    rung) gives bitwise the same results, each bitwise the direct run."""
    pairs = sample_scenarios(n=4, seed=14, scale=0.5)
    results = []
    for rungs in [(8,), (2, 16), (4, 32, 256)]:
        server = _server(slots=2, replicas=1, rungs=rungs)
        for i, (g, c) in enumerate(pairs):
            server.submit(SimRequest(rid=i, grid=g, campaign=c, seed=i))
        server.drain()
        used = server.metrics()["slot_banks"]
        assert all(sum(b["rung_windows"].values()) > 0 for b in used.values())
        results.append({i: server.poll(i).result for i in range(len(pairs))})
        if len(results) == 1:  # the other ladders are held to this one
            for i, (g, c) in enumerate(pairs):
                _assert_served_equals_direct(server, i, g, c, seed=i)
    base = results[0]
    for other in results[1:]:
        for i, res in base.items():
            for f in res._fields:
                assert torch.equal(getattr(res, f), getattr(other[i], f)), (i, f)


def test_coalesced_uptier_slice_parity():
    """A request whose native bank is cold runs up-tier in an existing wider
    bank, and its retired slice, cut back to native pads, is bitwise the
    native-pads ``Fleet.run``."""
    pairs = sample_scenarios(n=6, seed=15, scale=0.5)
    sigs = [pad_signature(compile_campaign(g, c)) for g, c in pairs]
    # the narrowest dominating pair keeps the wide bank small
    doms = [(i, j) for i, a in enumerate(sigs) for j, b in enumerate(sigs)
            if a != b and all(x >= y for x, y in zip(a, b))]
    assert doms, "workload has no dominating signature pair"
    pair = min(doms, key=lambda ij: np.prod(sigs[ij[0]]))
    wide_i, narrow_i = pair
    server = _server(slots=4, replicas=1, coalesce_ratio=1e9)
    server.submit(SimRequest(rid=0, grid=pairs[wide_i][0], campaign=pairs[wide_i][1], seed=0))
    server.drain()
    assert list(server.banks) == [sigs[wide_i]]
    server.submit(SimRequest(rid=1, grid=pairs[narrow_i][0], campaign=pairs[narrow_i][1],
                             seed=1))
    server.drain()
    # the narrow request never built its own bank: it ran up-tier
    assert list(server.banks) == [sigs[wide_i]]
    assert server.coalesced == 1
    (bank_m,) = server.metrics()["slot_banks"].values()
    assert bank_m["coalesced_in"] == 1
    res = server.poll(1)
    assert res.signature == sigs[narrow_i], "served signature must be native"
    _assert_served_equals_direct(server, 1, pairs[narrow_i][0], pairs[narrow_i][1], seed=1)


def test_unused_replica_lanes_are_inert():
    """An ``n_replicas=1`` request on a ``replicas=4`` server leaves lanes
    1..3 born done: they never tick, while the real lane runs."""
    (g, c), = sample_scenarios(n=1, seed=17, scale=0.5)
    server = _server(slots=2, replicas=4)
    server.submit(SimRequest(rid=0, grid=g, campaign=c, n_replicas=1, seed=0))
    server.drain()
    res = server.poll(0)
    (bank,) = server.banks.values()
    _version, _live, full = bank._seen
    ticks = full.ticks  # [S, R]
    assert ticks[res.slot, 0] > 0, "the real replica lane must have run"
    assert ticks[res.slot, 1:].max() == 0, "unused replica lanes ticked"
    _assert_served_equals_direct(server, 0, g, c, replicas=1, seed=0)


# ---------------------------------------------------------------------------
# warm store
# ---------------------------------------------------------------------------
def test_warm_dir_roundtrip(tmp_path):
    warm = str(tmp_path / "warm")
    (g, c), = sample_scenarios(n=1, seed=9, scale=0.5)
    s1 = _server(slots=2, warm_dir=warm)
    s1.submit(SimRequest(rid=0, grid=g, campaign=c, seed=0))
    s1.drain()
    assert s1.cache.warm_loads == 0 and os.listdir(warm)
    s2 = _server(slots=2, warm_dir=warm)
    s2.submit(SimRequest(rid=0, grid=g, campaign=c, seed=0))
    s2.drain()
    assert s2.cache.warm_loads == 1
    _assert_served_equals_direct(s2, 0, g, c, seed=0)

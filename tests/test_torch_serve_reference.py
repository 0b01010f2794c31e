"""The port's serving layer against the reference's, on the CPU.

The same requests go through ``repro.serve.SimServer`` and the port's
``repro_torch.serve.SimServer`` at the same window (each package keeps its
own default for the CPU, so ``window=8`` is passed to both). The two
schedulers agree round for round (signatures, slots, per-request windows,
rounds, rung histograms, coalescing) and their rows agree to the parity
standard: ``done``, ``ticks``, ``transfer_time``, ``start_tick`` equal,
``conth_mb`` and ``conpr_mb`` within rtol 1e-5 / atol 1e-4. The synthetic
workload is the same in both packages, and a slot-template warm store
written by either serves in the other."""
import numpy as np
import pytest

from repro import serve as ref_serve
from repro.core import scenarios as ref_scenarios
from repro.core import workload as ref_workload
from repro_torch import serve
from repro_torch.core import scenarios, workload

EXACT = ("done", "ticks", "transfer_time", "start_tick", "size_mb", "profile")
CLOSE = ("conth_mb", "conpr_mb")
THETA = np.asarray([0.15, 0.4, 0.2], np.float32)
# (serving package, its scenario registry, server keywords): reference first
PACKAGES = ((ref_serve, ref_scenarios, {}), (serve, scenarios, {"device": "cpu"}))


def _assert_matches(port, ref, msg=""):
    for f in EXACT:
        np.testing.assert_array_equal(np.asarray(getattr(port, f)), np.asarray(getattr(ref, f)),
                                      err_msg=msg + f)
    for f in CLOSE:
        np.testing.assert_allclose(np.asarray(getattr(port, f)), np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=1e-4, err_msg=msg + f)


def _serve_both(cfg, n=6, seed=0, scale=0.5, **req_kw):
    """The same ``n`` requests, submitted at once and drained, through the
    reference's server and the port's; both servers."""
    servers = []
    for pkg, scen, kw in PACKAGES:
        server = pkg.SimServer(pkg.ServeConfig(**cfg), **kw)
        pairs = scen.sample_scenarios(n=n, seed=seed, scale=scale)
        for i, (g, c) in enumerate(pairs):
            server.submit(pkg.SimRequest(rid=i, grid=g, campaign=c, seed=i, **req_kw))
        server.drain()
        servers.append(server)
    return servers


def _bank_counters(server):
    return {sig: {k: m[k] for k in ("rung_windows", "windows_total", "admitted", "retired",
                                    "coalesced_in", "realized_ticks")}
            for sig, m in server.metrics()["slot_banks"].items()}


@pytest.mark.parametrize("leap", [False, True], ids=["tick", "leap"])
def test_port_server_matches_reference_round_for_round(leap):
    cfg = dict(slots=4, replicas=2, window=8, leap=leap)
    ref, port = _serve_both(cfg, n_replicas=2, theta=THETA)
    assert port.rounds == ref.rounds and port.coalesced == ref.coalesced
    assert port.rungs == ref.rungs and port.window == ref.window == 8
    assert _bank_counters(port) == _bank_counters(ref)
    for rid in range(6):
        a, b = port.poll(rid), ref.poll(rid)
        assert (a.signature, a.slot, a.windows, a.n_replicas) == (
            tuple(b.signature), b.slot, b.windows, b.n_replicas), rid
        _assert_matches(a.result, b.result, f"request {rid}: ")


def test_synthetic_workload_is_the_same():
    a = ref_serve.synthetic_workload(8, seed=3)
    b = serve.synthetic_workload(8, seed=3)
    assert [t for t, _ in a] == [t for t, _ in b]
    for (_, ra), (_, rb) in zip(a, b):
        assert (ra.rid, ra.name, ra.seed, ra.n_replicas, ra.protocol) == (
            rb.rid, rb.name, rb.seed, rb.n_replicas, rb.protocol)
        ta = ref_workload.compile_campaign(ra.grid, ra.campaign)
        tb = workload.compile_campaign(rb.grid, rb.campaign)
        for f in ("size_mb", "release", "dep", "keep_frac", "protocol_id", "profile",
                  "proc_id", "link_id"):
            x, y = np.asarray(getattr(ta, f)), np.asarray(getattr(tb, f))
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_warm_store_crosses_packages(tmp_path, writer):
    """A ``warm_dir`` written by one package's ``BankSlotCache`` serves in
    the other's server: loaded, not rebuilt, and the rows it serves agree
    with the writer's."""
    warm = str(tmp_path / "warm")
    pkgs = PACKAGES if writer == "reference" else PACKAGES[::-1]
    served = []
    for pkg, scen, kw in pkgs:
        server = pkg.SimServer(pkg.ServeConfig(slots=2, window=8, warm_dir=warm), **kw)
        (g, c), = scen.sample_scenarios(n=1, seed=9, scale=0.5)
        server.submit(pkg.SimRequest(rid=0, grid=g, campaign=c, seed=0))
        server.drain()
        served.append(server)
    assert served[0].cache.warm_loads == 0 and served[1].cache.warm_loads == 1
    port, ref = (served[1], served[0]) if writer == "reference" else served
    _assert_matches(port.poll(0).result, ref.poll(0).result)

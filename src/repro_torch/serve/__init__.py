"""``repro_torch.serve``: the continuous-batching simulation service.

The port of the reference's ``repro.serve``. It serves ``(grid, campaign,
theta, n_replicas)`` requests from a persistent in-process server that
keeps warm **slot banks** resident on the card (one per pad signature),
merges newly admitted scenarios into the running window-loop carry at
window boundaries, and returns each request's result the round its
scenario finishes: continuous batching over simulations.

Entry points:

- :class:`SimServer` (``submit`` / ``poll`` / ``drain`` / ``step``) with
  :class:`ServeConfig`;
- :class:`SimRequest` / :class:`RequestResult`;
- :func:`synthetic_workload`: the seeded open-loop request generator of
  ``repro_torch.launch.serve``.

Invariant: a served result is **bitwise** the port's ``Fleet.run`` of the
same scenario with the same theta and keys; empty slots are inert pad
scenarios, so admission never changes a bank's shape.
"""
from repro_torch.serve.cache import BankSlotCache
from repro_torch.serve.request import RequestResult, SimRequest
from repro_torch.serve.server import ServeConfig, SimServer
from repro_torch.serve.workload import synthetic_workload

__all__ = [
    "BankSlotCache",
    "RequestResult",
    "ServeConfig",
    "SimRequest",
    "SimServer",
    "synthetic_workload",
]

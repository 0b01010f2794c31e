"""Grid topology: data centers, storage elements, worker nodes, links, protocols.

Faithful to GDAPS (Begy et al. 2019, Fig. 4):

- ``StorageElement`` persists replicas of files for the long term.
- ``WorkerNode`` executes computational jobs (performance given in MIPS) and
  stages data into its scratch disk.
- ``Link`` is a *uni-directional* virtual connection between two hosts with a
  fixed physical bandwidth that is fairly allocated among all concurrent
  processes; its latent load is parameterized by a normal distribution
  ``N(bg_mu, bg_sigma)`` resampled once per ``bg_update_period`` ticks.
- ``Protocol`` discards a fixed ``overhead`` fraction of every chunk.
- ``DataCenter`` aggregates storage elements and worker nodes; the ``Grid``
  aggregates data centers and the link set.

Units: file sizes and traffic in **MB**, bandwidth in **MB/tick** (one tick
abstracts one second, as in the paper), background load in (fractional)
process counts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

__all__ = [
    "Protocol",
    "StorageElement",
    "WorkerNode",
    "DataCenter",
    "Link",
    "Grid",
    "LinkTable",
    "GSIFTP",
    "XRDCP",
    "WEBDAV",
]


@dataclasses.dataclass(frozen=True)
class Protocol:
    """A data transfer protocol with a coordination-overhead fraction."""

    name: str
    overhead: float = 0.0

    def __post_init__(self) -> None:
        if not (0.0 <= self.overhead < 1.0):
            raise ValueError(f"protocol overhead must be in [0,1): {self.overhead}")


# The three protocols used in the paper's experiments. Default overheads are
# placeholders until calibration (Section 5 infers the WebDAV overhead).
GSIFTP = Protocol("gsiftp", overhead=0.02)
XRDCP = Protocol("xrdcp", overhead=0.02)
WEBDAV = Protocol("webdav", overhead=0.02)


@dataclasses.dataclass(frozen=True)
class StorageElement:
    name: str
    data_center: str


@dataclasses.dataclass(frozen=True)
class WorkerNode:
    name: str
    data_center: str
    mips: float = 1e4  # million instructions per second (paper, Fig. 4)
    scratch_gb: float = 512.0


@dataclasses.dataclass(frozen=True)
class DataCenter:
    name: str
    storage_elements: Tuple[str, ...] = ()
    worker_nodes: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class Link:
    """Uni-directional virtual link ``src -> dst`` between two hosts.

    ``bandwidth`` is the fixed physical bandwidth in MB/tick. The latent
    background load is ``max(N(bg_mu, bg_sigma), 0)`` processes, resampled
    every ``bg_update_period`` ticks (paper Section 4).
    """

    src: str
    dst: str
    bandwidth: float
    bg_mu: float = 0.0
    bg_sigma: float = 0.0
    bg_update_period: int = 60

    def __post_init__(self) -> None:
        if self.bandwidth <= 0:
            raise ValueError(f"link bandwidth must be positive: {self}")
        if self.bg_update_period <= 0:
            raise ValueError(f"bg_update_period must be positive: {self}")


@dataclasses.dataclass
class LinkTable:
    """Dense per-link parameter arrays compiled from a :class:`Grid`."""

    names: List[Tuple[str, str]]
    bandwidth: np.ndarray  # [L] f32, MB/tick
    bg_mu: np.ndarray  # [L] f32
    bg_sigma: np.ndarray  # [L] f32
    bg_period: np.ndarray  # [L] i32

    @property
    def n_links(self) -> int:
        return len(self.names)

    def index(self, src: str, dst: str) -> int:
        return self.names.index((src, dst))


class Grid:
    """A collection of data centers connected by uni-directional links."""

    def __init__(self) -> None:
        self.data_centers: Dict[str, DataCenter] = {}
        self.storage_elements: Dict[str, StorageElement] = {}
        self.worker_nodes: Dict[str, WorkerNode] = {}
        self.links: Dict[Tuple[str, str], Link] = {}
        self.protocols: Dict[str, Protocol] = {
            p.name: p for p in (GSIFTP, XRDCP, WEBDAV)
        }

    # -- construction -----------------------------------------------------
    def add_data_center(self, name: str) -> DataCenter:
        if name in self.data_centers:
            raise ValueError(f"duplicate data center {name!r}")
        dc = DataCenter(name)
        self.data_centers[name] = dc
        return dc

    def add_storage_element(self, name: str, data_center: str) -> StorageElement:
        self._require_dc(data_center)
        if name in self.storage_elements or name in self.worker_nodes:
            raise ValueError(f"duplicate host {name!r}")
        se = StorageElement(name, data_center)
        self.storage_elements[name] = se
        dc = self.data_centers[data_center]
        self.data_centers[data_center] = dataclasses.replace(
            dc, storage_elements=dc.storage_elements + (name,)
        )
        return se

    def add_worker_node(
        self, name: str, data_center: str, mips: float = 1e4
    ) -> WorkerNode:
        self._require_dc(data_center)
        if name in self.storage_elements or name in self.worker_nodes:
            raise ValueError(f"duplicate host {name!r}")
        wn = WorkerNode(name, data_center, mips=mips)
        self.worker_nodes[name] = wn
        dc = self.data_centers[data_center]
        self.data_centers[data_center] = dataclasses.replace(
            dc, worker_nodes=dc.worker_nodes + (name,)
        )
        return wn

    def add_link(
        self,
        src: str,
        dst: str,
        bandwidth: float,
        bg_mu: float = 0.0,
        bg_sigma: float = 0.0,
        bg_update_period: int = 60,
    ) -> Link:
        """Add a *uni-directional* link (paper Fig. 3: no bi-directional
        throughput symmetry is assumed; the reverse direction must be added
        explicitly with its own parameters).

        Bi-directional links are only legal between two storage elements
        (the simulator models data input exclusively); WN-terminated links
        point at the worker node.
        """
        self._require_host(src)
        self._require_host(dst)
        if src == dst:
            raise ValueError("self-links are not allowed")
        if dst in self.storage_elements and src in self.worker_nodes:
            raise ValueError(
                "links into a storage element from a worker node are not "
                "modeled (GDAPS considers data input only)"
            )
        key = (src, dst)
        if key in self.links:
            raise ValueError(f"duplicate link {key}")
        link = Link(src, dst, bandwidth, bg_mu, bg_sigma, bg_update_period)
        self.links[key] = link
        return link

    def add_protocol(self, name: str, overhead: float) -> Protocol:
        proto = Protocol(name, overhead)
        self.protocols[name] = proto
        return proto

    # -- queries -----------------------------------------------------------
    def host_data_center(self, host: str) -> str:
        if host in self.storage_elements:
            return self.storage_elements[host].data_center
        if host in self.worker_nodes:
            return self.worker_nodes[host].data_center
        raise KeyError(f"unknown host {host!r}")

    def local_storage_elements(self, worker_node: str) -> List[str]:
        dc = self.worker_nodes[worker_node].data_center
        return list(self.data_centers[dc].storage_elements)

    def link(self, src: str, dst: str) -> Link:
        try:
            return self.links[(src, dst)]
        except KeyError:
            raise KeyError(f"no link {src!r} -> {dst!r} in grid") from None

    # -- compilation --------------------------------------------------------
    def link_table(self) -> LinkTable:
        names = sorted(self.links.keys())
        links = [self.links[k] for k in names]
        return LinkTable(
            names=list(names),
            bandwidth=np.array([l.bandwidth for l in links], np.float32),
            bg_mu=np.array([l.bg_mu for l in links], np.float32),
            bg_sigma=np.array([l.bg_sigma for l in links], np.float32),
            bg_period=np.array([l.bg_update_period for l in links], np.int32),
        )

    # -- internals ----------------------------------------------------------
    def _require_dc(self, name: str) -> None:
        if name not in self.data_centers:
            raise KeyError(f"unknown data center {name!r}")

    def _require_host(self, name: str) -> None:
        if name not in self.storage_elements and name not in self.worker_nodes:
            raise KeyError(f"unknown host {name!r}")

"""Cluster control plane over ``torch.distributed`` (the port of
``poseidon_tpu/runtime/cluster.py``'s hostfile and init half).

- ``env_world``: the launcher env contract, ``POSEIDON_PROC_ID`` /
  ``POSEIDON_NUM_PROCS`` / ``POSEIDON_COORDINATOR`` (what
  ``scripts/launch.py --local`` sets). The coordinator is ``host:port``
  (rank 0 serves the rendezvous store there, the name-node role) or a full
  torch ``init_method`` URL such as ``file:///shared/path``.
- ``parse_hostfile``: ``<id> <ip> <port>`` lines, host 0 the coordinator.
- ``init_distributed``: the process group and this rank's device, as a
  ``parallel/mesh.DataGroup``. The backend rule, printed once at start-up
  and never changed behind the caller's back:

  - gloo for CPU tensors;
  - NCCL when every rank has a CUDA device of its own (world <=
    ``torch.cuda.device_count()``; rank r takes ``cuda:r``);
  - gloo when ranks share a card (rank r takes ``cuda:(r % count)``; gloo
    stages CUDA tensors through the host: a correctness path, not a fast
    one).

A single process (world 1, no coordinator) initializes nothing, as in the
JAX package; it is one slice of one rank. A world above 1 without a
coordinator raises rather than training N unsynchronized replicas.
Rendezvous retries with the shared backoff (``runtime/retry.py``),
seeded by rank: under a launcher the coordinator may come up seconds
after its peers.
"""

from __future__ import annotations

import datetime
import os
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from .metrics import log
from .retry import retry_with_backoff

# how long a process keeps redialing the coordinator before giving up
# (env-overridable, as in the JAX package), and the process group's timeout
# for every collective after it
RENDEZVOUS_DEADLINE_S = float(
    os.environ.get("POSEIDON_RENDEZVOUS_DEADLINE_S", "60"))
_COLLECTIVE_TIMEOUT_S = 600.0

# init_process_group reports both a coordinator that is not up yet and a
# permanent misconfiguration as RuntimeError; only these look transient
_TRANSIENT_RENDEZVOUS = ("timed out", "timeout", "refused", "connect",
                         "unavailable", "address already in use")


def env_world() -> Tuple[int, int, Optional[str]]:
    """(rank, n_procs, coordinator) from the launcher env contract. Under
    ``--async_ssp`` the roster is a starting point: a process launched
    with ``POSEIDON_PROC_ID >= POSEIDON_NUM_PROCS`` is an elastic joiner,
    admitted into the live job by the tier's service."""
    return (int(os.environ.get("POSEIDON_PROC_ID", "0")),
            int(os.environ.get("POSEIDON_NUM_PROCS", "1")),
            os.environ.get("POSEIDON_COORDINATOR"))


def is_elastic_joiner(rank: int, n_procs: int) -> bool:
    """True when this process joins a live async-SSP job from outside the
    launch roster (``POSEIDON_PROC_ID >= POSEIDON_NUM_PROCS``)."""
    return rank >= n_procs


@dataclass(frozen=True)
class Host:
    id: int
    ip: str
    port: int


def parse_hostfile(path: str) -> List[Host]:
    hosts: List[Host] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) != 3:
                raise ValueError(f"{path}: bad hostfile line {line!r} "
                                 f"(want '<id> <ip> <port>')")
            hosts.append(Host(int(parts[0]), parts[1], int(parts[2])))
    ids = [h.id for h in hosts]
    if ids != list(range(len(hosts))):
        raise ValueError(f"{path}: host ids must be 0..N-1 in order, got {ids}")
    return hosts


def choose_backend(device: torch.device, rank: int, world: int
                   ) -> Tuple[str, torch.device, str]:
    """(backend, this rank's device, the reason) by the rule above."""
    if device.type == "cpu":
        return "gloo", device, "CPU tensors"
    if device.type != "cuda":
        raise ValueError(f"no collective backend for device {device}")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("a CUDA device was asked for and none is visible")
    if world <= count:
        return ("nccl", torch.device("cuda", rank),
                f"{world} rank(s) on {count} visible GPU(s), one each")
    return ("gloo", torch.device("cuda", rank % count),
            f"{world} ranks share {count} visible GPU(s); gloo stages CUDA "
            f"tensors through the host")


def local_device(device: torch.device, rank: int) -> torch.device:
    """The device of a rank that joins no process group (the async-SSP
    tier's independent processes): ``device`` on the CPU, else
    ``cuda:(rank % count)``, made current."""
    if device.type != "cuda":
        return device
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("a CUDA device was asked for and none is visible")
    dev = torch.device("cuda", rank % count)
    torch.cuda.set_device(dev)
    return dev


def init_method_of(coordinator: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL stays as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def _init_with_retry(backend: str, init_method: str, rank: int, world: int,
                     device: torch.device) -> None:
    import torch.distributed as dist

    class _Transient(OSError):
        pass

    kw = {}
    if backend == "nccl":
        kw["device_id"] = device

    def attempt() -> None:
        try:
            dist.init_process_group(
                backend, init_method=init_method, rank=rank,
                world_size=world,
                timeout=datetime.timedelta(seconds=_COLLECTIVE_TIMEOUT_S),
                **kw)
        except RuntimeError as e:
            if not any(s in str(e).lower() for s in _TRANSIENT_RENDEZVOUS):
                raise            # misconfiguration: fail fast
            raise _Transient(str(e)) from e

    retry_with_backoff(attempt, deadline=RENDEZVOUS_DEADLINE_S, base=0.2,
                       cap=5.0, rng=random.Random(rank),
                       retry_on=(_Transient,))


def _two_tier_groups(rank: int, world: int, slices: int):
    """(this rank's slice group, its cross-slice group), each None where
    it would hold one rank. Every rank creates every group, in the same
    order, as ``new_group`` requires."""
    import torch.distributed as dist

    size = world // slices
    mine_slice = mine_cross = None
    if size > 1:
        for s in range(slices):
            pg = dist.new_group(list(range(s * size, (s + 1) * size)))
            if rank // size == s:
                mine_slice = pg
    if slices > 1:
        for i in range(size):
            pg = dist.new_group(list(range(i, world, size)))
            if rank % size == i:
                mine_cross = pg
    return mine_slice, mine_cross


def build_mesh_groups(cfg, rank: int, device: torch.device,
                      backend: Optional[str], ranks=None):
    """``parallel/mesh.MeshGroups`` of ``cfg`` over the global ``ranks``
    (default: the whole world, which must be ``cfg.n_devices``), its
    groups made with ``new_group``: every rank of the world calls this,
    those outside ``ranks`` too, since ``new_group`` is collective; they
    get None. Groups of one rank get no process group."""
    import torch.distributed as dist

    from ..parallel.mesh import DataGroup, MeshGroups, mesh_axis_ranks

    ranks = list(range(cfg.n_devices)) if ranks is None else list(ranks)
    if len(ranks) != cfg.n_devices:
        raise ValueError(f"mesh {cfg.describe()} needs {cfg.n_devices} "
                         f"ranks, got {len(ranks)}")
    mine = {}
    for axis, groups in mesh_axis_ranks(cfg).items():
        for members in groups:
            glob = [ranks[i] for i in members]
            pg = dist.new_group(glob) if len(glob) > 1 else None
            if rank in glob:
                mine[axis] = DataGroup(rank=glob.index(rank),
                                       world=len(glob), device=device,
                                       backend=backend, pg=pg)
    if rank not in ranks:
        return None
    return MeshGroups(cfg=cfg, data=mine["data"], fsdp=mine["fsdp"],
                      tp=mine["tp"], joint=mine["joint"])


def init_distributed(device: torch.device, rank: Optional[int] = None,
                     world: Optional[int] = None,
                     coordinator: Optional[str] = None, slices: int = 1,
                     mesh_cfg=None):
    """The data group of this process. Arguments override the env
    contract; a coordinator (argument or env) starts a process group, even
    of one rank, which the returned ``DataGroup``'s ``close`` destroys.
    ``slices`` > 1 makes it the two-tier group (``parallel/mesh.py``)
    with its slice and cross-slice process groups; a world it does not
    divide exits, as the JAX CLI's ``--dcn_slices`` does. An active
    ``mesh_cfg`` (``config.MeshConfig``) needs a world of exactly its
    ``n_devices`` ranks (one a device; JAX's message otherwise) and makes
    the group carry the named mesh (``DataGroup.mesh``)."""
    from ..parallel.mesh import DataGroup

    e_rank, e_world, e_coord = env_world()
    rank = e_rank if rank is None else rank
    world = e_world if world is None else world
    coordinator = e_coord if coordinator is None else coordinator
    slices = max(1, int(slices))
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if world % slices:
        raise SystemExit(f"--dcn_slices {slices} does not divide "
                         f"{world} devices")
    if mesh_cfg is not None and mesh_cfg.n_devices != world:
        raise SystemExit(
            f"--mesh {mesh_cfg.describe()} needs {mesh_cfg.n_devices} "
            f"devices; {world} available")
    if coordinator is None:
        if world > 1:
            raise ValueError(
                f"a world of {world} processes needs POSEIDON_COORDINATOR "
                f"(host:port of rank 0, or an init_method URL); without it "
                f"each process would train alone")
        return DataGroup.single(device)
    backend, dev, why = choose_backend(device, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _init_with_retry(backend, init_method_of(coordinator), rank, world, dev)
    log(f"distributed: {world} rank(s), backend {backend} ({why}); rank "
        f"{rank} on {dev}", rank=rank)
    import torch.distributed as dist
    slice_pg, cross_pg = (_two_tier_groups(rank, world, slices)
                          if slices > 1 else (None, None))
    if slices > 1:
        log(f"distributed: two tiers, {slices} slice(s) of "
            f"{world // slices} rank(s); rank {rank} in slice "
            f"{rank // (world // slices)}", rank=rank)
    mesh = None
    if mesh_cfg is not None and mesh_cfg.active:
        mesh = build_mesh_groups(mesh_cfg, rank, dev, backend)
        d, f, t = mesh.coords
        log(f"distributed: mesh {mesh_cfg.describe()}; rank {rank} at "
            f"data {d}, fsdp {f}, tp {t} (batch shard {mesh.batch_index})",
            rank=rank)
    return DataGroup(rank=rank, world=world, device=dev, backend=backend,
                     pg=dist.group.WORLD, slices=slices, slice_pg=slice_pg,
                     cross_pg=cross_pg, mesh=mesh)

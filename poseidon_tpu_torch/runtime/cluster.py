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
JAX package; it is one slice of one rank.

``build_named_groups`` makes the groups of a general named mesh (the
LM's ``("data", "seq")``, ``("data", "model")``, ``("data", "seq",
"model")``; ``parallel/mesh.NamedGroups``) beside ``build_mesh_groups``'
SPMD mesh; ``init_distributed(named=(axes, shape))`` starts it.

The two-tier fabric's half (``train --async_ssp --slice``,
``parallel/fabric.py``): ``slice_env`` and ``slice_world`` read
``POSEIDON_SLICE_ID`` / ``POSEIDON_SLICE_SIZE`` as the JAX package does
(the same results and refusals for the same env), and
``init_slice_group`` makes the slice's OWN process group: its members
rendezvous at a store of their own, one per slice id
(``slice_init_method``: the coordinator's port + 2 + the slice id, since
port + 1 is the async service's; a ``file://`` coordinator's path +
``.slice<k>``), with rank = rank-in-slice and world = slice size. No
global world exists in this mode, so a slice that dies takes no other
slice's group with it, and a joiner slice re-forms its group under its
own id. Where JAX counts devices (a slice member cannot share one), the
port counts them by the backend rule above: gloo ranks may share a card,
NCCL ranks may not. A world above 1 without a
coordinator raises rather than training N unsynchronized replicas.
Rendezvous retries with the shared backoff (``runtime/retry.py``),
seeded by rank: under a launcher the coordinator may come up seconds
after its peers.
"""

from __future__ import annotations

import datetime
import functools
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
# a slice's group: its members wait in the leader's refresh broadcast
# while the leader waits at the async tier's gate, whose first wait may
# last 1800 s (runtime/async_tier.py); the broadcast outlasts it, and
# raises after it
_SLICE_COLLECTIVE_TIMEOUT_S = 2400.0

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
class SliceAssignment:
    """This process's place in the two-tier fabric: its slice, how many
    processes the slice spans, and its rank within the slice (0 = the
    slice's leader, the one process that speaks the async-SSP protocol)."""

    slice_id: int
    slice_size: int
    rank_in_slice: int
    n_slices: int        # whole slices in the launch roster

    @property
    def is_leader(self) -> bool:
        return self.rank_in_slice == 0

    @property
    def is_joiner_slice(self) -> bool:
        """The slice sits outside the launch roster: admitted mid-run, not
        launched (the slice-granular ``is_elastic_joiner``)."""
        return self.slice_id >= self.n_slices


def slice_env(n_visible_devices: Optional[int] = None
              ) -> Optional[Tuple[int, int]]:
    """(slice_id, slice_size) from ``POSEIDON_SLICE_ID`` /
    ``POSEIDON_SLICE_SIZE``, or None when neither is set (the per-process
    path unchanged). Refused loudly: one variable without the other; a
    slice id below 0 or a size below 1; a slice larger than
    ``n_visible_devices`` when the caller counts devices
    (``slice_device_limit``: only where members cannot share one)."""
    sid = os.environ.get("POSEIDON_SLICE_ID")
    ssz = os.environ.get("POSEIDON_SLICE_SIZE")
    if sid is None and ssz is None:
        return None
    if sid is None or ssz is None:
        raise ValueError(
            "POSEIDON_SLICE_ID and POSEIDON_SLICE_SIZE must be set "
            f"together (got SLICE_ID={sid!r}, SLICE_SIZE={ssz!r}); the "
            "slice contract is all-or-nothing")
    slice_id, slice_size = int(sid), int(ssz)
    if slice_id < 0:
        raise ValueError(f"POSEIDON_SLICE_ID must be >= 0, got {slice_id}")
    if slice_size < 1:
        raise ValueError(
            f"POSEIDON_SLICE_SIZE must be >= 1, got {slice_size}")
    if n_visible_devices is not None and slice_size > n_visible_devices:
        raise ValueError(
            f"slice {slice_id} spans {slice_size} processes but only "
            f"{n_visible_devices} device(s) are visible — a slice member "
            f"cannot share a device; shrink POSEIDON_SLICE_SIZE or widen "
            f"the device set")
    return slice_id, slice_size


def slice_world(n_visible_devices: Optional[int] = None
                ) -> Optional[SliceAssignment]:
    """This process's whole slice assignment, or None when the slice env
    is unset. Slice k owns the contiguous ranks [k*size, (k+1)*size), so
    every process derives the assignment from its own env. Refused
    loudly: a launch roster that is not a whole number of slices (orphan
    ranks), and a rank outside its declared slice's block (an
    overlapping assignment). A slice id past the roster is a joiner
    slice; its ranks sit past the roster too."""
    se = slice_env(n_visible_devices)
    if se is None:
        return None
    slice_id, slice_size = se
    rank, n_procs, _ = env_world()
    if n_procs % slice_size:
        raise ValueError(
            f"launch roster of {n_procs} processes is not a whole number "
            f"of {slice_size}-process slices — "
            f"{n_procs % slice_size} rank(s) would belong to no slice")
    rank_in_slice = rank - slice_id * slice_size
    if not (0 <= rank_in_slice < slice_size):
        owner = rank // slice_size
        raise ValueError(
            f"overlapping slice assignment: rank {rank} declares slice "
            f"{slice_id} but the contiguous-block contract puts it in "
            f"slice {owner} (slice k owns ranks [k*{slice_size}, "
            f"(k+1)*{slice_size}))")
    return SliceAssignment(slice_id=slice_id, slice_size=slice_size,
                           rank_in_slice=rank_in_slice,
                           n_slices=n_procs // slice_size)


def slice_device_limit(device: torch.device,
                       backend: Optional[str] = None) -> Optional[int]:
    """The ``n_visible_devices`` a slice is checked against, by the
    backend rule: the visible card count for NCCL ranks (each needs a card
    of its own), None where ranks may share one (CPU tensors, gloo). With
    no backend asked for, the rule picks gloo for a slice larger than the
    card count, so only an explicit NCCL request is ever refused."""
    if device.type != "cuda" or backend != "nccl":
        return None
    return torch.cuda.device_count()


def slice_init_method(coordinator: Optional[str], slice_id: int) -> str:
    """Where slice ``slice_id``'s members rendezvous (the module
    docstring's rule)."""
    if not coordinator:
        raise ValueError(
            "a slice of more than one process needs POSEIDON_COORDINATOR "
            "(host:port or a file:// URL) for its own rendezvous")
    if coordinator.startswith("file://"):
        return f"{coordinator}.slice{slice_id}"
    host, port = coordinator.split("://", 1)[-1].rsplit(":", 1)
    return f"tcp://{host}:{int(port) + 2 + slice_id}"


def init_slice_group(device: torch.device, sw: SliceAssignment,
                     coordinator: Optional[str] = None,
                     backend: Optional[str] = None):
    """The data group of slice ``sw``'s own process group (rank =
    rank-in-slice, world = slice size, ``slice_init_method``'s store). A
    rank takes ``cuda:(global rank % count)``, so the slices of one host
    hold disjoint cards where they fit. The backend: ``backend`` when given
    (NCCL refused where members would share a card), else the rule's
    pick. A slice of one process makes no group."""
    import torch.distributed as dist

    from ..parallel.mesh import DataGroup

    rank, _, e_coord = env_world()
    coordinator = e_coord if coordinator is None else coordinator
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "a CUDA device was asked for and none is visible")
        limit = slice_device_limit(device, backend)
        if limit is not None and sw.slice_size > limit:
            raise ValueError(
                f"slice {sw.slice_id} spans {sw.slice_size} NCCL ranks but "
                f"only {limit} device(s) are visible — NCCL ranks cannot "
                f"share a device (gloo ranks can)")
        dev = torch.device("cuda", rank % count)
        torch.cuda.set_device(dev)
        if backend is None:
            backend = "nccl" if sw.slice_size <= count else "gloo"
        why = (f"{sw.slice_size} rank(s) a slice on {count} visible "
               f"GPU(s)" + (", sharing them" if backend == "gloo" else ""))
    else:
        dev = device
        backend, why = "gloo", "CPU tensors"
    if sw.slice_size == 1:
        return DataGroup.single(dev)
    _init_with_retry(backend, slice_init_method(coordinator, sw.slice_id),
                     sw.rank_in_slice, sw.slice_size, dev,
                     timeout_s=_SLICE_COLLECTIVE_TIMEOUT_S)
    log(f"distributed: slice {sw.slice_id} of {sw.slice_size} rank(s), "
        f"backend {backend} ({why}); rank {rank} is rank-in-slice "
        f"{sw.rank_in_slice} on {dev}", rank=sw.rank_in_slice)
    return DataGroup(rank=sw.rank_in_slice, world=sw.slice_size, device=dev,
                     backend=backend, pg=dist.group.WORLD)


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
                     device: torch.device,
                     timeout_s: float = _COLLECTIVE_TIMEOUT_S) -> None:
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
                timeout=datetime.timedelta(seconds=timeout_s),
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
    (default: the whole world, which must be ``cfg.n_devices``): the
    named groups of ``SPMD_AXES`` with the joint ``(data, fsdp)`` group
    (``build_named_groups``). Every rank of the world calls this, those
    outside ``ranks`` too, since ``new_group`` is collective; they get
    None. Groups of one rank get no process group."""
    from ..parallel.mesh import SPMD_AXES, MeshGroups

    ranks = list(range(cfg.n_devices)) if ranks is None else list(ranks)
    if len(ranks) != cfg.n_devices:
        raise ValueError(f"mesh {cfg.describe()} needs {cfg.n_devices} "
                         f"ranks, got {len(ranks)}")
    return build_named_groups(SPMD_AXES, (cfg.data, cfg.fsdp, cfg.tp),
                              rank, device, backend, ranks,
                              joint=("data", "fsdp"),
                              make=functools.partial(MeshGroups, cfg=cfg))


def build_named_groups(axes, shape, rank: int, device: torch.device,
                       backend: Optional[str], ranks=None, joint=None,
                       make=None):
    """``parallel/mesh.NamedGroups`` of the named mesh ``axes`` x ``shape``
    over the global ``ranks`` (default: ranks 0..prod(shape)-1), its groups
    made with ``new_group`` in ``named_axis_ranks``' order: every rank of
    the world calls this, those outside ``ranks`` too (they get None).
    ``joint`` names the data-like axes (default: every axis but
    ``model``); a joint of one axis is that axis's group. Groups of one
    rank get no process group, so a one-process mesh of ones needs no
    ``torch.distributed`` at all. ``make`` builds the result from
    ``NamedGroups``' fields (``build_mesh_groups`` makes ``MeshGroups``)."""
    from ..parallel.mesh import (DataGroup, NamedGroups, data_like_axes,
                                 named_axis_ranks)

    axes, shape = tuple(axes), tuple(int(n) for n in shape)
    n = 1
    for size in shape:
        n *= size
    ranks = list(range(n)) if ranks is None else list(ranks)
    if len(ranks) != n:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks, "
                         f"got {len(ranks)}")
    joint = data_like_axes(axes) if joint is None else tuple(joint)
    mine = {}
    table = named_axis_ranks(axes, shape,
                             joint=joint if len(joint) > 1 else ())
    for axis, groups in table.items():
        for members in groups:
            glob = [ranks[i] for i in members]
            pg = None
            if len(glob) > 1:
                import torch.distributed as dist
                pg = dist.new_group(glob)
            if rank in glob:
                mine[axis] = DataGroup(rank=glob.index(rank),
                                       world=len(glob), device=device,
                                       backend=backend, pg=pg)
    if rank not in ranks:
        return None
    if len(joint) == 1:
        mine["joint"] = mine[joint[0]]
    elif not joint:
        mine["joint"] = DataGroup.single(device)
    return (make or NamedGroups)(axes=axes, shape=shape,
                                 groups={a: mine[a] for a in axes},
                                 joint=mine["joint"], joint_axes=joint)


def hostfile_world(hostfile: str, node_id: Optional[int]
                   ) -> Tuple[int, int, Optional[str]]:
    """(rank, world, coordinator) of a cluster hostfile (the JAX
    package's ``init_distributed(hostfile=, node_id=)``): host 0's entry
    is the coordinator (the name-node analog), the world is the host
    count and the rank is ``node_id``. A one-host file is one process with
    no coordinator; a multi-host file without ``node_id`` raises."""
    hosts = parse_hostfile(hostfile)
    if len(hosts) == 1:
        return 0, 1, None
    if node_id is None:
        raise ValueError("node_id is required with a multi-host hostfile")
    if not 0 <= node_id < len(hosts):
        raise ValueError(f"node_id {node_id} is not a host of {hostfile} "
                         f"(ids 0..{len(hosts) - 1})")
    return node_id, len(hosts), f"{hosts[0].ip}:{hosts[0].port}"


def init_distributed(device: torch.device, rank: Optional[int] = None,
                     world: Optional[int] = None,
                     coordinator: Optional[str] = None, slices: int = 1,
                     mesh_cfg=None, named=None,
                     hostfile: Optional[str] = None,
                     node_id: Optional[int] = None):
    """The data group of this process. Arguments override the env
    contract, and a ``hostfile`` (``hostfile_world``, with ``node_id``)
    overrides both; a coordinator (argument, hostfile or env) starts a
    process group, even of one rank, which the returned ``DataGroup``'s
    ``close`` destroys.
    ``slices`` > 1 makes it the two-tier group (``parallel/mesh.py``)
    with its slice and cross-slice process groups; a world it does not
    divide exits, as the JAX CLI's ``--dcn_slices`` does. An active
    ``mesh_cfg`` (``config.MeshConfig``) needs a world of exactly its
    ``n_devices`` ranks (one a device; JAX's message otherwise) and makes
    the group carry the named mesh (``DataGroup.mesh``). ``named`` =
    ``(axes, shape)`` makes it carry a general named mesh there instead
    (``build_named_groups``); its ranks must number the world."""
    from ..parallel.mesh import DataGroup

    if hostfile:
        rank, world, coordinator = hostfile_world(hostfile, node_id)
    else:
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
    if named is not None:
        n_named = 1
        for size in named[1]:
            n_named *= int(size)
        if n_named != world:
            raise SystemExit(f"mesh {dict(zip(*named))} needs {n_named} "
                             f"devices; {world} available")
    if coordinator is None:
        if world > 1:
            raise ValueError(
                f"a world of {world} processes needs POSEIDON_COORDINATOR "
                f"(host:port of rank 0, or an init_method URL); without it "
                f"each process would train alone")
        if named is None:
            return DataGroup.single(device)
        return DataGroup(rank=0, world=1, device=torch.device(device),
                         mesh=build_named_groups(*named, 0,
                                                 torch.device(device),
                                                 None))
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
    if named is not None:
        mesh = build_named_groups(*named, rank, dev, backend)
        log(f"distributed: mesh {mesh.describe()}; rank {rank} at "
            + ", ".join(f"{a} {mesh.index(a)}" for a in mesh.axes),
            rank=rank)
    return DataGroup(rank=rank, world=world, device=dev, backend=backend,
                     pg=dist.group.WORLD, slices=slices, slice_pg=slice_pg,
                     cross_pg=cross_pg, mesh=mesh)

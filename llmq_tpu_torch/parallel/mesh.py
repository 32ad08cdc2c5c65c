"""The rank mesh and multi-process bring-up (counterpart of
``llmq_tpu/parallel/mesh.py``).

JAX's mesh is a named array of the devices one controller drives. The
port runs one process per rank (``torch.distributed``), so its mesh is a
named ``(dp, tp)`` view over the world's ranks: the axis sizes, this
process's coordinates on them, and the process groups that stitch the
ranks together. ``group`` carries the model's tp collectives, which the
CUDA graphs capture (NCCL on the card wherever ``tp > 1``, gloo on the
CPU); ``dp_group`` (gloo) joins the ranks of one tp coordinate across the
dp replicas and carries the pages and tokens that move between
replicas, between programs; ``results`` (gloo) joins each replica's
first tp rank and carries the rows' results to the driver; ``control``
is a gloo group over every rank that carries the executor's host
descriptors (the same group where the data plane is already gloo).

``distributed_init`` joins the world from a ``host:port`` coordinator
(JAX's ``jax.distributed.initialize``); a second call is a no-op and any
other failure propagates. Its timeout (``LLMQ_CLUSTER_TIMEOUT`` at the
entry points) stays with the world: every group a mesh makes, and every
mesh's ``timeout_s``, take it. JAX's ``enable_compilation_cache`` has no
counterpart: the port captures its CUDA graphs in each process.
"""

from __future__ import annotations

import datetime
import logging
from typing import Dict, Optional, Sequence, Tuple

log = logging.getLogger("llmq_tpu_torch.mesh")

#: The mesh's axes, outermost first (JAX's ``("dp", "tp")``).
AXES: Tuple[str, ...] = ("dp", "tp")

#: Seconds of a rendezvous and of every collective when the caller gives
#: none (JAX's ``LLMQ_CLUSTER_TIMEOUT`` default).
DEFAULT_TIMEOUT_S = 300.0

#: The joined world's timeout (seconds), set by :func:`distributed_init`.
_world_timeout_s = DEFAULT_TIMEOUT_S


class Mesh:
    """A named view over ranks: ``shape`` maps each axis to its size in
    declaration order (``{"dp": 2, "tp": 4}``), ``size`` is their product
    and the number of ranks, ``rank`` is this process's global rank and
    ``coords`` its index on each axis (row-major over ``shape``, as JAX
    lays its device array out). ``group`` is this rank's ``tp`` group,
    ``control`` the gloo group of the executor's descriptors; both are
    None on a mesh of one rank without a process group, and on a mesh
    made only to describe shapes (``ranks`` given, no world joined).
    ``timeout_s`` bounds a collective on its groups: a follower's wait
    for its driver."""

    def __init__(self, shape: Dict[str, int], rank: int = 0,
                 group=None, control=None, backend: str = "",
                 ranks: Optional[Sequence[int]] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S, dp_group=None,
                 results=None) -> None:
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        self.rank = rank
        #: The global ranks of the mesh, in its row-major order.
        self.ranks = list(ranks) if ranks is not None else list(
            range(self.size))
        self.group = group
        self.control = control
        self.dp_group = dp_group
        self.results = results
        self.backend = backend
        self.timeout_s = float(timeout_s)
        coords, rest = {}, rank
        for name in reversed(self.axis_names):
            coords[name] = rest % self.shape[name]
            rest //= self.shape[name]
        self.coords = {k: coords[k] for k in self.axis_names}

    @property
    def tp(self) -> int:
        return int(self.shape.get("tp", 1))

    @property
    def dp(self) -> int:
        return int(self.shape.get("dp", 1))

    @property
    def tp_rank(self) -> int:
        return int(self.coords.get("tp", 0))

    @property
    def dp_rank(self) -> int:
        """This rank's dp replica (its universe of pages)."""
        return int(self.coords.get("dp", 0))

    def rank_of(self, **coords: int) -> int:
        """The global rank at ``coords`` (axes left out: 0)."""
        return _rank_of(self.shape, self.ranks, coords)

    @property
    def is_driver(self) -> bool:
        """Rank 0 runs the serving process; the other ranks follow."""
        return self.rank == 0

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend or 'none'})")


def _world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(shape: Dict[str, int],
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A named mesh over ``ranks`` (default: every rank of the world
    joined by :func:`distributed_init`, or this one process), e.g.
    ``make_mesh({"tp": 2})``. Axis sizes must multiply to the number of
    ranks; one axis may be -1 (inferred). Over the joined world it makes
    the process groups (every rank must call it, in the same order);
    with ``ranks`` given and no world joined it only describes shapes
    (the partition rules need nothing more)."""
    world, rank = _world()
    explicit = ranks is not None
    rs = list(ranks) if explicit else list(range(world))
    n = len(rs)
    names = list(shape.keys())
    for name in names:
        if name not in AXES:
            raise ValueError(f"mesh axis must be 'dp' or 'tp' (got {name!r})")
    sizes = [int(v) for v in shape.values()]
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        if n % known:
            raise ValueError(f"cannot infer axis: {n} ranks not divisible "
                             f"by {known}")
        sizes[sizes.index(-1)] = n // known
    total = 1
    for s in sizes:
        total *= s
    if total != n:
        raise ValueError(f"mesh shape {dict(zip(names, sizes))} needs "
                         f"{total} ranks, have {n}")
    resolved = dict(zip(names, sizes))
    if explicit and world == 1:
        return Mesh(resolved)
    group = control = dp_group = results = None
    backend = ""
    if world > 1 or _initialized():
        group, control, backend, dp_group, results = _groups(resolved, rs,
                                                             rank)
    mesh = Mesh(resolved, rank=rs.index(rank) if rank in rs else 0,
                group=group, control=control, backend=backend, ranks=rs,
                timeout_s=_world_timeout_s, dp_group=dp_group,
                results=results)
    log.info("mesh: %s over %d rank(s), this rank %d (%s)", resolved, n,
             mesh.rank, backend or "no process group")
    return mesh


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _rank_of(shape: Dict[str, int], ranks: Sequence[int],
             coords: Dict[str, int]) -> int:
    """The rank at ``coords`` of the row-major rank array over
    ``shape``."""
    i = 0
    for name, n in shape.items():
        i = i * n + int(coords.get(name, 0))
    return ranks[i]


def _lines(shape: Dict[str, int], ranks: Sequence[int], axis: str):
    """The ranks along ``axis`` at every coordinate of the other axes:
    one list per line, in row-major order of those coordinates."""
    others = [(k, n) for k, n in shape.items() if k != axis]
    count = 1
    for _k, n in others:
        count *= n
    out = []
    for i in range(count):
        coords, rest = {}, i
        for k, n in reversed(others):
            coords[k] = rest % n
            rest //= n
        out.append([_rank_of(shape, ranks, {**coords, axis: j})
                    for j in range(shape.get(axis, 1))])
    return out


def _groups(shape: Dict[str, int], ranks: Sequence[int], rank: int):
    """(this rank's tp group, the control group, the world's backend,
    its dp group, the results group). Every rank creates every group, in
    one order (``new_group`` is a collective call): the tp lines (the
    world's backend), the dp lines and the results group (gloo, where
    ``dp > 1``), then the control group."""
    import torch.distributed as dist

    backend = str(dist.get_backend())
    timeout = datetime.timedelta(seconds=_world_timeout_s)
    world = dist.get_world_size()

    def make(row, gloo: bool):
        # The gloo groups are always groups of their own: the driver's
        # results receiver waits on its group from a thread of its own.
        if len(row) == world and not gloo:
            return dist.group.WORLD
        return dist.new_group(row, timeout=timeout,
                              backend="gloo" if gloo else None)

    mine = dp_group = results = None
    for row in _lines(shape, ranks, "tp"):
        g = make(row, gloo=False)
        if rank in row:
            mine = g
    if shape.get("dp", 1) > 1:
        for row in _lines(shape, ranks, "dp"):
            g = make(row, gloo=True)
            if rank in row:
                dp_group = g
        firsts = [_rank_of(shape, ranks, {"dp": d})
                  for d in range(shape["dp"])]
        g = make(firsts, gloo=True)
        if rank in firsts:
            results = g
    if backend == "gloo":
        control = dist.group.WORLD
    else:
        control = dist.new_group(list(ranks), backend="gloo",
                                 timeout=timeout)
    return mine, control, backend, dp_group, results


def single_device_mesh(axis_names: Sequence[str] = AXES) -> Mesh:
    """A mesh of one rank with every axis of size 1 (JAX's trivial mesh
    on one device): the same code path, unsharded."""
    return Mesh({name: 1 for name in axis_names})


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     initialization_timeout: Optional[int] = None,
                     device: str = "cuda",
                     backend: Optional[str] = None) -> None:
    """Join the world: ``torch.distributed.init_process_group`` from the
    ``host:port`` coordinator (rank 0 hosts the store there), NCCL when
    ``device`` is a CUDA device (this rank's card, ``cuda:{rank %
    device_count}``, made current), gloo on the CPU. ``backend="gloo"``
    keeps a CUDA world on gloo: a mesh without tp collectives (``tp`` 1)
    moves only host traffic between its ranks, and gloo lets several
    ranks share one card, which NCCL refuses.
    ``initialization_timeout`` (seconds, default
    :data:`DEFAULT_TIMEOUT_S`) bounds the rendezvous and every later
    collective, and is every later mesh's ``timeout_s``. Idempotent: a second call is a no-op. Any other
    failure (a bad address, a rank mismatch, a timeout) propagates: a
    half-joined serving process must fail fast."""
    import torch
    import torch.distributed as dist

    global _world_timeout_s
    if dist.is_available() and dist.is_initialized():
        log.info("torch.distributed already initialised")
        return
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError("distributed_init needs the coordinator, the "
                         "number of processes and this process's id")
    timeout_s = float(DEFAULT_TIMEOUT_S if initialization_timeout is None
                      else initialization_timeout)
    kwargs = {"timeout": datetime.timedelta(seconds=timeout_s)}
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               f"not available; pass device='cpu'")
        index = (dev.index if dev.index is not None
                 else int(process_id) % torch.cuda.device_count())
        torch.cuda.set_device(index)
        # No ``device_id``: an NCCL world bound to its device splits every
        # later group from its communicator, and then a rank outside a
        # gloo group (the dp lines, the results group) waits in a split
        # that the members never join. Each NCCL communicator starts at
        # its first collective instead (warmup's eager runs, before any
        # capture).
        backend = backend or "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)
    _world_timeout_s = timeout_s
    log.info("torch.distributed initialised: process %d of %d (%s)",
             dist.get_rank(), dist.get_world_size(), backend)

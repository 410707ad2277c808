"""Data and coil parallelism over ranks of ``torch.distributed``: the rank
group, the ``(data, coil)`` grid of sub-groups, their collectives, the
divisible sharding rule and the rank launcher.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/parallel/mesh.py``:
``make_mesh`` (:28-33), ``make_recon_mesh`` (:36-53), ``distributed_init``
(:60-79), ``host_major_grid`` (:82-103), ``divisible_spec`` (:122-140) and
``volume_affine_shards`` (:148-172). The JAX package shards a global-view array over a device mesh
and XLA inserts every cross-device sum. Here one process drives one device
(a rank), and every sum over the global batch is an explicit collective:

- :class:`DataGroup` is a rank's handle on its group: world size, rank, its
  device and the process group. :func:`make_mesh` joins one.
- :func:`shard_rows` is ``divisible_spec`` on the batch axis: a batch the
  world divides is cut into equal contiguous shares, rank ``r`` holding
  the ``r``-th; any other batch stays whole on every rank (replicated),
  and the caller then bypasses the collectives, or every sum would count
  the batch ``world`` times. :func:`shard_dim` is the same rule on any
  axis and any group.
- :class:`ReconGrid` is ``make_recon_mesh``'s ``(data, coil)`` grid: rank
  ``d * n_coil + c`` holds data block ``d`` and coil block ``c``, and
  :func:`make_recon_grid` gives it a data sub-group (the ranks of its coil
  block) and a coil sub-group (the ranks of its data block).
- :func:`all_reduce_sum` is differentiable: its backward pass all-reduces
  the upstream gradient too. A rank whose loss holds a global term (a
  BatchNorm statistic, a Dice sum) then receives the gradient of every
  rank's loss through that term, so the gradients of the ``world`` ranks
  *averaged* are the global batch's gradient.
- :func:`gather_rows` gathers row shares into the whole batch on every rank
  as one all-reduce of a zeroed buffer that each rank fills with its rows,
  which is exact (one non-zero addend an element).
- :func:`exchange`, :func:`isend` and :func:`recv` are the point-to-point
  ops of ``parallel/spatial.py`` and ``parallel/pipeline.py`` (JAX's
  ``ppermute``): ``batch_isend_irecv`` inside a group, peers named by
  their global rank, every send counted in ``P2P_COUNTS``.

Ranks run over NCCL, one card each, or over gloo: on the CPU, and where a
caller places several ranks on one card (NCCL refuses two ranks on one
device). gloo's CUDA support is limited to a few collectives, so a CUDA
tensor goes through gloo by an explicit copy to the host and back.
:func:`spawn` starts ``world`` ranks as processes of the ``spawn`` method,
rendezvousing through a file, which needs no free port.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_lib
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class DataGroup:
    """One rank's handle on its data-parallel group."""
    world: int
    rank: int
    device: torch.device
    pg: Any                  # the torch.distributed process group
    backend: str             # "nccl" or "gloo"

    @property
    def primary(self) -> bool:
        """The rank that writes a run's files."""
        return self.rank == 0


def mesh_devices(n: int, device: str = "cuda") -> List[torch.device]:
    """The devices of ``n`` ranks, one card each (``cuda:0`` ..), or ``n``
    CPU ranks; raises as ``make_mesh`` does when the cards are too few."""
    dev = torch.device(device)
    if n < 1:
        raise ValueError(f"requested {n} devices")
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(f"requested {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def choose_backend(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    devs = [torch.device(d) for d in devices]
    own_cards = (all(d.type == "cuda" for d in devs)
                 and len({d.index for d in devs}) == len(devs))
    return "nccl" if own_cards and dist.is_nccl_available() else "gloo"


def make_mesh(world: int, rank: int, device: str | torch.device,
              init_method: str, backend: str = "",
              timeout_s: float = 600.0) -> DataGroup:
    """Join the group of ``world`` ranks as ``rank`` on ``device``, through
    ``init_method`` (``file://...`` or ``tcp://host:port``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.index is None:
            dev = torch.device("cuda", 0)
        if have <= dev.index:
            raise ValueError(f"requested {dev.index + 1} devices, have "
                             f"{have}")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return DataGroup(world, rank, dev, dist.group.WORLD, backend)


# ---------------------------------------------------------------------------
# Multi-host: torchrun's environment
# ---------------------------------------------------------------------------

def distributed_init(device: str = "cuda") -> bool:
    """Join the group that torchrun describes (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``). A no-op returning
    False at world 1; True once joined."""
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    return True


class _Slot:
    """A rank's place: its host and its local rank there."""

    def __init__(self, process_index: int, local: int):
        self.process_index, self.id = process_index, local


def env_group(device: str = "cuda") -> Optional[DataGroup]:
    """The multi-host group of this process after :func:`distributed_init`
    (None at world 1), on ``cuda:LOCAL_RANK``. Every rank's place
    (``GROUP_RANK``, ``LOCAL_RANK``) is gathered, and the ranks must be
    host-major, as :func:`host_major_grid` lays them out, so that
    consecutive ranks share a host."""
    if not distributed_init(device):
        return None
    world, rank = dist.get_world_size(), dist.get_rank()
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device)
    dev = torch.device("cuda", local) if dev.type == "cuda" else dev
    group = DataGroup(world, rank, dev, dist.group.WORLD, dist.get_backend())
    places = torch.zeros((world, 2), dtype=torch.float64, device=dev)
    places[rank] = torch.tensor(
        [float(os.environ.get("GROUP_RANK", "0")), float(local)])
    all_reduce_(places, group)
    slots = [_Slot(int(h), int(lr)) for h, lr in places.cpu().tolist()]
    grid = host_major_grid(slots, len({s.process_index for s in slots}))
    if [grid.ravel()[r] for r in range(world)] != slots:
        raise ValueError(f"ranks are not host-major: (host, local rank) "
                         f"by rank {[(s.process_index, s.id) for s in slots]}")
    return group


def host_major_grid(devices: Sequence, num_hosts: int) -> np.ndarray:
    """``(num_hosts, per_host)`` grid of devices, host-major: sorted by
    ``(process_index, id)`` so that each row is one host's devices."""
    devs = sorted(devices, key=lambda d: (d.process_index, d.id))
    if len(devs) % num_hosts:
        raise ValueError(
            f"{len(devs)} devices do not split over {num_hosts} hosts")
    per_host = len(devs) // num_hosts
    grid = np.empty((num_hosts, per_host), dtype=object)
    for i, d in enumerate(devs):
        row = i // per_host
        if d.process_index != devs[row * per_host].process_index:
            raise ValueError("devices of one host are not contiguous; "
                             "uneven per-host device counts are unsupported")
        grid[row, i % per_host] = d
    return grid


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

def row_slice(batch: int, group: Optional[DataGroup]) -> Optional[slice]:
    """This rank's rows of a ``batch``-row global batch, or None where the
    batch stays whole (no group, or a batch the world does not divide)."""
    if group is None or batch % group.world:
        return None
    share = batch // group.world
    return slice(group.rank * share, (group.rank + 1) * share)


def shard_rows(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """``divisible_spec`` on axis 0: this rank's contiguous rows, or the
    whole ``x`` where the world does not divide it."""
    rows = row_slice(int(x.shape[0]), group)
    return x if rows is None else x[rows]


def volume_affine_shards(vol_sizes: Sequence[int], n_shards: int
                         ) -> List[np.ndarray]:
    """Whole volumes to shards, round-robin by size-descending order onto
    the least loaded, each shard's slice list padded to the longest by
    repeating its first entries (every slice of a volume on one shard;
    equal counts; duplicates are dropped by slice id when aggregated)."""
    sizes = np.asarray(vol_sizes)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    order = np.argsort(-sizes, kind="stable")
    buckets: List[List[int]] = [[] for _ in range(n_shards)]
    loads = np.zeros(n_shards, np.int64)
    for v in order:
        tgt = int(np.argmin(loads))
        buckets[tgt].extend(range(starts[v], starts[v] + sizes[v]))
        loads[tgt] += sizes[v]
    max_len = max(len(b) for b in buckets)
    out = []
    for b in buckets:
        arr = np.asarray(b, np.int64)
        if len(arr) < max_len:
            arr = np.concatenate([arr, np.resize(arr, max_len - len(arr))])
        out.append(arr)
    return out


def shard_dim(x: torch.Tensor, dim: int, group: Optional[DataGroup]
              ) -> torch.Tensor:
    """``divisible_spec`` on axis ``dim``: this rank's contiguous block of
    ``x`` along ``dim``, or the whole ``x`` where the group does not divide
    that axis (or there is no group)."""
    part = row_slice(int(x.shape[dim]), group)
    if part is None:
        return x
    return x.narrow(dim, part.start, part.stop - part.start)


# ---------------------------------------------------------------------------
# The (data, coil) grid
# ---------------------------------------------------------------------------

@dataclass
class ReconGrid:
    """One rank's handle on a ``(data, coil)`` grid of ranks, laid out
    data-major: rank ``d * n_coil + c``. ``data`` joins the ``n_data`` ranks
    of coil block ``c`` (the ranks that hold other rows of the batch),
    ``coil`` the ``n_coil`` ranks of data block ``d`` (the ranks that hold
    other coils of the same rows); a sub-group of one rank is None, so its
    sums are no-ops."""
    world: DataGroup
    data: Optional[DataGroup]
    coil: Optional[DataGroup]

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def primary(self) -> bool:
        return self.world.primary


def make_recon_grid(group: DataGroup, n_data: int, n_coil: int
                    ) -> ReconGrid:
    """This rank's place on the ``(n_data, n_coil)`` grid over ``group``
    and its two sub-groups. ``dist.new_group`` is collective over the
    default group, so every rank makes every sub-group, in one order, also
    those it is not a member of."""
    if n_data < 1 or n_coil < 1 or n_data * n_coil != group.world:
        raise ValueError(f"a ({n_data}, {n_coil}) grid needs "
                         f"{n_data * n_coil} ranks, the group has "
                         f"{group.world}")
    d, c = divmod(group.rank, n_coil)

    def sub(lines: List[List[int]], mine: int) -> Optional[DataGroup]:
        if len(lines[0]) == 1:
            return None
        pgs = [dist.new_group(ranks, backend=group.backend)
               for ranks in lines]
        return DataGroup(len(lines[mine]), lines[mine].index(group.rank),
                         group.device, pgs[mine], group.backend)

    coil = sub([[dd * n_coil + cc for cc in range(n_coil)]
                for dd in range(n_data)], d)
    data = sub([[dd * n_coil + cc for dd in range(n_data)]
                for cc in range(n_coil)], c)
    return ReconGrid(group, data, coil)


def grid_average(tensors: Sequence[torch.Tensor], grid: ReconGrid
                 ) -> List[torch.Tensor]:
    """The gradient rule of a grid step: the mean over every rank of the
    grid. Each coil rank computes the same loss, and the coil sums'
    backward sums the upstream gradient over the coil sub-group, so a
    rank's gradient is that of the sum of its coil ranks' losses with
    respect to its own copy of the weights: their mean over the coil ranks
    is the loss's gradient, and the mean over the data ranks then that of
    the global batch. A mean over the data sub-group alone leaves the coil
    ranks' gradients unequal."""
    return average_flat(tensors, grid.world)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """Sum ``t`` over the group in place (through the host under gloo for
    a CUDA tensor); returns ``t``."""
    if group.backend == "gloo" and t.is_cuda:
        host = t.detach().cpu()
        dist.all_reduce(host, group=group.pg)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group.pg)
    return t


def barrier(group: Optional[DataGroup]) -> None:
    """Return once every rank of ``group`` has reached it, and once the
    work this rank queued on its device before it has run: a one-element
    all-reduce whose result the host reads (under NCCL the collective is
    only queued on a stream, so without the read the host would not
    wait); a no-op without a group."""
    if group is not None:
        all_reduce_(torch.zeros(1, device=group.device), group).item()


def any_rank(flag: bool, group: Optional[DataGroup]) -> bool:
    """True on every rank when ``flag`` is set on any."""
    if group is None:
        return flag
    t = torch.tensor([float(flag)], device=group.device)
    return bool(all_reduce_(t, group).item() > 0)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward pass sums the upstream gradients,
    each rank's loss reaching every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: Optional[DataGroup]
                   ) -> torch.Tensor:
    """Differentiable sum of ``x`` over the group (``x`` itself without
    one)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


# ---------------------------------------------------------------------------
# Point to point
# ---------------------------------------------------------------------------

# sends made by exchange / isend since the last reset_p2p_counts, and bytes
P2P_COUNTS = {"sends": 0, "bytes": 0}


def reset_p2p_counts() -> None:
    P2P_COUNTS.update(sends=0, bytes=0)


def global_rank(group: DataGroup, rank: int) -> int:
    """The default group's rank of ``group``'s rank ``rank`` (a peer of a
    point-to-point op is named by its global rank)."""
    if group.pg is None or group.pg is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group.pg, rank)


def _wire(t: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """``t`` as it goes on the wire: contiguous, and on the host under
    gloo (whose point-to-point ops take CPU tensors)."""
    t = t.detach()
    if group.backend == "gloo" and t.is_cuda:
        return t.cpu()
    return t.contiguous()


def _count(t: torch.Tensor) -> None:
    P2P_COUNTS["sends"] += 1
    P2P_COUNTS["bytes"] += t.numel() * t.element_size()


def exchange(sends: Sequence, recvs: Sequence, group: DataGroup,
             tag: int = 0) -> List[torch.Tensor]:
    """Post every send ``(tensor, peer)`` and every receive ``(like,
    peer)`` (peers as ranks of ``group``) in one ``batch_isend_irecv`` and
    wait for them all; returns the received tensors, each shaped, typed
    and placed as its ``like``. Every rank posts its sends before it waits,
    so ranks that send to each other do not deadlock. A failed op raises
    on every rank that waits on it."""
    ops, bufs = [], []
    for t, peer in sends:
        w = _wire(t, group)
        _count(w)
        ops.append(dist.P2POp(dist.isend, w, global_rank(group, peer),
                              group.pg, tag))
    for like, peer in recvs:
        host = group.backend == "gloo" and like.is_cuda
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if host else like.device)
        ops.append(dist.P2POp(dist.irecv, buf, global_rank(group, peer),
                              group.pg, tag))
        bufs.append(buf)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(like.device) for b, (like, _) in zip(bufs, recvs)]


# sends of isend not yet waited for: (work, the buffer it reads)
_PENDING: list = []


def isend(t: torch.Tensor, peer: int, group: DataGroup, tag: int) -> None:
    """Send ``t`` to ``group``'s rank ``peer`` without waiting; the send is
    waited for by the next :func:`wait_sends` (so a sender never blocks on
    a receiver that is still busy elsewhere)."""
    w = _wire(t, group)
    _count(w)
    _PENDING.append((dist.isend(w, global_rank(group, peer),
                                group=group.pg, tag=tag), w))


def wait_sends() -> None:
    """Wait for every send that :func:`isend` has posted."""
    while _PENDING:
        work, _ = _PENDING.pop(0)
        work.wait()


def recv(like: torch.Tensor, peer: int, group: DataGroup,
         tag: int) -> torch.Tensor:
    """Receive from ``group``'s rank ``peer`` the message of ``tag``, a
    tensor shaped, typed and placed as ``like``; blocks until it is in."""
    return exchange((), [(like, peer)], group, tag)[0]


def gather_rows(local: torch.Tensor, batch: int,
                group: Optional[DataGroup]) -> torch.Tensor:
    """The whole ``batch``-row tensor on every rank from each rank's
    :func:`row_slice` share (``local`` itself where the batch is whole)."""
    rows = row_slice(batch, group)
    if rows is None:
        return local
    full = torch.zeros((batch,) + tuple(local.shape[1:]), dtype=local.dtype,
                       device=local.device)
    full[rows] = local
    return all_reduce_(full, group)


def average_flat(tensors: Sequence[torch.Tensor], group: DataGroup
                  ) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor, through one all-reduce of
    their concatenation (f32, or float64 when one is float64); returns new
    tensors of the inputs' dtypes."""
    dt = torch.float32
    for t in tensors:
        dt = torch.promote_types(dt, t.dtype)
    flat = torch.cat([t.reshape(-1).to(dt) for t in tensors])
    all_reduce_(flat, group).div_(group.world)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


# ---------------------------------------------------------------------------
# Launching ranks
# ---------------------------------------------------------------------------

def _to_host(tree: Any) -> Any:
    """Tensors of a result as numpy arrays, which pickle by value."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _rank_main(rank, fn, world, devices, backend, init_method, threads,
               args, queue):
    try:
        if threads:
            torch.set_num_threads(threads)
        group = make_mesh(world, rank, devices[rank], init_method, backend)
        try:
            out = fn(group, *args)
            barrier(group)      # no rank leaves while another's op runs
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, _to_host(out)))
    except BaseException:           # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, devices: Sequence, args: tuple = (),
          init_file: str = "", backend: str = "", threads: int = 0,
          timeout_s: float = 600.0) -> list:
    """Run ``fn(group, *args)`` on ``world`` new ranks (one process each,
    rank ``r`` on ``devices[r]``) and return their results by rank, tensors
    as numpy arrays. ``fn`` must be importable by name. A CPU rank runs
    ``threads`` threads (by default one: CPU ranks serve tests and
    debugging, often beside other test processes). The ranks meet
    through ``init_file`` (a new file in a temporary directory by
    default); the backend is :func:`choose_backend`'s unless given. Raises
    with the rank's traceback if one fails, and after ``timeout_s``; every
    rank is ended before this returns."""
    import torch.multiprocessing as tmp_mp
    devices = [torch.device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, got "
                         f"{len(devices)}")
    backend = backend or choose_backend(devices)
    if not threads and all(d.type == "cpu" for d in devices):
        threads = 1     # CPU ranks (tests, debugging) must not oversubscribe
    ctx = tmp_mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        path = init_file or os.path.join(tmp, "rendezvous")
        queue = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, fn, world, devices, backend, "file://" + path, threads,
            args, queue)) for r in range(world)]
        for p in procs:
            p.start()
        results, errors = {}, []
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) + len(errors) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout_s} s")
                try:
                    rank, ok, out = queue.get(timeout=min(left, 1.0))
                except queue_lib.Empty:     # poll the ranks
                    dead = [r for r, p in enumerate(procs)
                            if not p.is_alive() and p.exitcode
                            and r not in results]
                    if dead:
                        codes = [procs[r].exitcode for r in dead]
                        raise RuntimeError(f"rank(s) {dead} died with exit "
                                           f"codes {codes}")
                    continue
                if ok:
                    results[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break                   # the others may wait forever
        finally:
            for p in procs:
                p.join(timeout=10 if not errors else 0.5)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return [results[r] for r in range(world)]

"""Ranks, their ("data", "model") layout and the collectives between them
(port of ``openmatch_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a ``Mesh`` of devices. The port
runs one process per rank over ``torch.distributed``, the reference's DDP
shape (OpenMatch's ``src/openmatch/loss.py:35``): ``world = dp x tp``
ranks laid out as JAX's ``np.array(devices).reshape(dp, tp)``, so rank
``r = d * tp + t``. The *data group* of a rank is the ranks with its ``t``
(they hold the same parameter slices and split the batch); the *model
group* the ranks with its ``d`` (they hold one batch shard and split the
tensor-parallel weights, ``parallel/tp.py``).

The backend is chosen once, from what the job has, and never because
something failed: NCCL when every local rank has a card of its own
(``cuda:LOCAL_RANK``), gloo when several ranks share a card or run on the
CPU. gloo passes CUDA tensors through host memory: the collectives here
copy them to the host, run, and copy back, and use only the forms both
backends take (``all_reduce``, ``broadcast`` and the list form of
``all_gather``). Every process group has a timeout, so a hung collective
ends the run.

A serving job's ranks follow rank 0 through ``ControlChannel``: a small
fixed header (an op and a row count) and the query reps, broadcast before
each search; an idle rank 0 sends a keep-alive well inside the groups'
timeout, and "stop" ends the followers (``drivers/serve.py``).

Launch: ``torchrun --nproc_per_node=N -m openmatch_tpu_torch.drivers.train_dr
...``; tests and ``chip_smoke.py`` use ``spawn_ranks``.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing.connection
import os
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
TIMEOUT_S = 600.0  # every process group's collective timeout


def world_size() -> int:
    """The ``torch.distributed`` world size; 1 when it is not initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def env_world_size() -> int:
    """The launcher's ``WORLD_SIZE`` (1 without a launcher)."""
    return max(int(os.environ.get("WORLD_SIZE", "1")), 1)


def _local_world() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", env_world_size()))


def choose_backend(device: torch.device) -> str:
    """NCCL when every local rank has a card of its own, else gloo."""
    if device.type == "cuda" and _local_world() <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(name) -> torch.device:
    """This rank's device for a ``--device`` value. One process: the device
    named. Several: ``cuda`` is ``cuda:LOCAL_RANK`` when every local rank
    has a card, else the card ``LOCAL_RANK % count`` that ranks share; a
    card index is refused, since the launcher's ranks pick theirs."""
    if env_world_size() == 1:
        return resolve_device(name)
    device = torch.device(name)
    if device.type == "cuda":
        if device.index is not None:
            raise ValueError(f"device {name!r}: a job of {env_world_size()} "
                             "ranks takes 'cuda' and gives each rank its card")
        resolve_device("cuda")  # raises without a card
        local = int(os.environ.get("LOCAL_RANK", "0"))
        return torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(name)


def init_distributed(device: torch.device, init_method: Optional[str] = None,
                     timeout_s: float = TIMEOUT_S) -> str:
    """Initialise the default process group of this rank from the
    launcher's ``RANK`` and ``WORLD_SIZE`` (``env://`` rendezvous unless
    ``init_method`` is given) with the backend ``choose_backend`` picks for
    ``device``; returns the backend. Raises if the rank cannot join."""
    backend = choose_backend(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank, world = int(os.environ.get("RANK", "0")), env_world_size()
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("rank %d of %d on %s: backend %s%s", rank, world, device,
                backend, " (collectives through host memory)"
                if backend == "gloo" and device.type == "cuda" else "")
    return backend


@dataclass
class Mesh:
    """This rank's place in a ("data", "model") layout of ``dp x tp``
    ranks. ``shape`` reads as JAX's ``mesh.shape[axis]``. ``groups`` holds
    the process group of each axis (and "world"), or None where the axis
    has one rank: collectives over it are then no-ops."""

    dp: int
    tp: int
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    groups: Dict[str, Any] = field(default_factory=dict)
    stage: bool = False  # gloo over CUDA tensors: collectives via the host

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    def index(self, axis: str) -> int:
        return self.data_index if axis == DATA_AXIS else self.model_index

    def size(self, axis: str) -> int:
        return self.dp * self.tp if axis == "world" else self.shape[axis]

    def group(self, axis: str):
        return self.groups.get(axis)


def make_mesh(dp_size: int = -1, tp_size: int = 1, device="cuda") -> Mesh:
    """The mesh of this rank over every rank of the job (one when
    ``torch.distributed`` is not initialised), on ``device``: the rank's
    card unless the caller names the CPU (``cuda`` without an index is the
    current card, which ``init_distributed`` set). ``dp_size=-1`` takes
    all ranks left after ``tp_size``. Every rank must call it, in the same
    order: it creates the axes' process groups."""
    n = world_size()
    if dp_size == -1:
        if n % tp_size:
            raise ValueError(f"{n} devices not divisible by tp={tp_size}")
        dp_size = n // tp_size
    if dp_size * tp_size != n:
        raise ValueError(f"dp({dp_size}) * tp({tp_size}) != devices({n})")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        resolve_device("cuda")  # raises without a card
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh(dp_size, tp_size, device=resolve_device(device))
    if n == 1:
        return mesh
    mesh.rank = dist.get_rank()
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    mesh.groups["world"] = dist.group.WORLD
    # every rank creates every group, in one order, and keeps its own
    for t in range(tp_size):
        g = dist.new_group([d * tp_size + t for d in range(dp_size)],
                           timeout=timeout)
        if dp_size > 1 and t == mesh.model_index:
            mesh.groups[DATA_AXIS] = g
    for d in range(dp_size):
        g = dist.new_group([d * tp_size + t for t in range(tp_size)],
                           timeout=timeout)
        if tp_size > 1 and d == mesh.data_index:
            mesh.groups[MODEL_AXIS] = g
    mesh.stage = dist.get_backend() == "gloo" and device.type == "cuda"
    return mesh


# ---- collectives -----------------------------------------------------------


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str,
               op: str = "sum") -> torch.Tensor:
    """Sum (or mean, ``op="mean"``) ``t`` in place over the ranks of
    ``axis``; returns ``t``."""
    group = mesh.group(axis)
    if group is None:
        return t
    buf = t.cpu() if mesh.stage else t
    dist.all_reduce(buf, group=group)
    if op == "mean":
        buf /= mesh.size(axis)
    if buf is not t:
        t.copy_(buf)
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The ranks' ``t`` of ``axis`` concatenated along dim 0, in the order
    of their index on the axis."""
    group = mesh.group(axis)
    if group is None:
        return t
    src = t.contiguous()
    if mesh.stage:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def broadcast(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Overwrite ``t`` in place with rank 0's ``t``; returns ``t``."""
    group = mesh.group("world")
    if group is None:
        return t
    buf = t.cpu() if mesh.stage else t
    dist.broadcast(buf, src=0, group=group)
    if buf is not t:
        t.copy_(buf)
    return t


def _flat_apply(tensors: Sequence[torch.Tensor], fn):
    """Run ``fn`` on one flat copy of ``tensors`` and copy the result back:
    one collective for many tensors."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    fn(flat)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.detach().copy_(part.view_as(t))


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh):
    """Rank 0's values into every rank's ``tensors`` (one broadcast)."""
    if mesh.group("world") is not None:
        _flat_apply(tensors, lambda flat: broadcast(flat, mesh))


def flat_all_reduce(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str,
                    op: str = "sum"):
    """``all_reduce`` of every tensor in place, as one flat collective."""
    if mesh.group(axis) is not None:
        _flat_apply(tensors, lambda flat: all_reduce(flat, mesh, axis, op))


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, x.shape[0]
        return all_gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.mesh.index(ctx.axis) * ctx.rows
        return grad[lo:lo + ctx.rows], None, None


def all_gather_rows(x: torch.Tensor, mesh: Mesh,
                    axis: str = DATA_AXIS) -> torch.Tensor:
    """The ranks' ``x`` tiled along dim 0 (JAX ``all_gather(tiled=True)``),
    differentiable: the backward keeps this rank's slice of the incoming
    gradient, as the reference's ``DistributedContrastiveLoss`` keeps the
    local gradient. Each rank's loss over the gathered rows is the global
    loss, so the parameter gradients are summed over ``axis`` afterwards."""
    if mesh.group(axis) is None:
        return x
    return _AllGatherRows.apply(x, mesh, axis)


def reduce_grads(params, mesh: Mesh, extras=(), op: str = "mean") -> list:
    """Every parameter's ``.grad`` (a missing one as zeros) and the scalar
    ``extras`` summed or averaged (``op``) over the data group in one flat
    all-reduce; returns the extras, reduced (fp32, on their device)."""
    extras = [torch.as_tensor(e).detach().reshape(1).float().clone()
              for e in extras]
    if mesh.group(DATA_AXIS) is None:
        return extras
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat_all_reduce([p.grad for p in params] + extras, mesh, DATA_AXIS, op)
    return extras


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *tensors):
        ctx.mesh, ctx.axis = mesh, axis
        out = [t.detach().clone() for t in tensors]
        flat_all_reduce(out, mesh, axis)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.clone() for g in grads]
        flat_all_reduce(grads, ctx.mesh, ctx.axis)
        return (None, None, *grads)


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: Mesh,
                   axis: str = DATA_AXIS) -> list:
    """The ranks' ``tensors`` summed over ``axis`` (one flat collective),
    differentiable: the backward sums the incoming gradients over the axis
    as well, since every rank's sum feeds every rank's loss (JAX ``psum``
    under ``grad``). New tensors; the inputs are left as they are."""
    tensors = list(tensors)
    if mesh.group(axis) is None or not tensors:
        return tensors
    return list(_AllReduceSum.apply(mesh, axis, *tensors))


# ---- the serving control channel -------------------------------------------

OP_SEARCH, OP_KEEPALIVE, OP_STOP = 1, 2, 3
KEEPALIVE_S = TIMEOUT_S / 10  # an idle rank 0 speaks at least this often


class ControlChannel:
    """What rank 0 of a serving job tells the other ranks, over the world
    group: a header of two int64 (the op and a row count ``Q``), then for
    "search" the ``[Q, dim]`` query reps. Rank 0 calls ``send``; every
    other rank waits in ``receive`` and then runs what rank 0 runs (a
    search's collectives included), in the same order. A rank waiting
    here longer than the group's timeout fails, so an idle rank 0 sends
    "keep-alive" every ``KEEPALIVE_S`` (``RetrievalService``), and "stop"
    ends the followers' loop. The reps travel as their bytes (gloo takes
    no bf16), so the form works on gloo and NCCL alike, bit for bit."""

    def __init__(self, mesh: Mesh, dim: int, dtype: torch.dtype):
        self.mesh, self.dim, self.dtype = mesh, dim, dtype

    def _header(self, op: int = 0, rows: int = 0) -> Tuple[int, int]:
        h = torch.tensor([op, rows], dtype=torch.int64,
                         device=self.mesh.device)
        broadcast(h, self.mesh)
        return int(h[0]), int(h[1])

    @staticmethod
    def _wire(x: torch.Tensor) -> torch.Tensor:
        return x.view(torch.uint8)

    def send(self, op: int, reps: Optional[torch.Tensor] = None):
        """Rank 0: ``op`` (with ``reps`` [Q, dim] for ``OP_SEARCH``)."""
        self._header(op, 0 if reps is None else reps.shape[0])
        if reps is not None:
            broadcast(self._wire(reps.to(self.dtype).contiguous()),
                      self.mesh)

    def receive(self) -> Tuple[int, Optional[torch.Tensor]]:
        """Any other rank: (op, reps or None), as rank 0 sent them."""
        op, rows = self._header()
        if op != OP_SEARCH:
            return op, None
        reps = torch.empty((rows, self.dim), dtype=self.dtype,
                           device=self.mesh.device)
        broadcast(self._wire(reps), self.mesh)
        return op, reps


# ---- batches ---------------------------------------------------------------


def shard_batch(batch, mesh: Mesh, axis: str = DATA_AXIS):
    """This rank's contiguous rows of a global batch: data index ``d``
    holds rows ``d*B/dp ... (d+1)*B/dp`` of every array, as JAX's
    ``P("data")`` places them. Nested dicts (``QPCollator``'s query and
    passage parts, ``PairCollator``'s pairs) are sliced leaf by leaf, so
    each query's passages stay with it."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, axis) for v in batch)
    n, parts = batch.shape[0], mesh.size(axis)
    if n % parts:
        raise ValueError(f"batch of {n} rows does not split over {parts} "
                         f"ranks of '{axis}'")
    rows = n // parts
    lo = mesh.index(axis) * rows
    return batch[lo:lo + rows]


# ---- launching ranks -------------------------------------------------------


def _rank_entry(fn, rank: int, world: int, device: str, tmp: str,
                args: tuple, timeout_s: float):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        dev = rank_device(device)
        init_distributed(dev, "file://" + os.path.join(tmp, "rendezvous"),
                         timeout_s)
        result = fn(dev, *args)
        torch.save(result, os.path.join(tmp, f"result{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args: tuple = (),
                device: str = "cpu", timeout_s: float = TIMEOUT_S) -> list:
    """Run ``fn(device, *args)`` on ``world`` ranks, each a fresh process
    (``torch.multiprocessing``, start method ``spawn``) whose default
    process group joined through a ``file://`` rendezvous in a temporary
    directory (no port, so concurrent jobs never collide). ``fn`` must be
    importable by name; ``device`` is ``"cpu"`` or ``"cuda"`` (each rank
    then initialises CUDA itself). Returns each rank's return value, in
    rank order. Raises if any rank exits non-zero (the others are stopped
    at once) or if the ranks are not done within ``timeout_s``."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        procs = [ctx.Process(target=_rank_entry,
                             args=(fn, r, world, device, tmp, args,
                                   timeout_s))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            _join(procs, tmp, time.monotonic() + timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           weights_only=False) for r in range(world)]


def _join(procs, tmp: str, deadline: float, grace_s: float = 5.0):
    """Wait for every rank; raise at the first that fails (after a short
    grace for the others to exit, so the error that came first is among
    those reported), or at the deadline."""
    while True:
        failed = [(r, p.exitcode) for r, p in enumerate(procs)
                  if p.exitcode not in (None, 0)]
        if failed:
            alive = [p.sentinel for p in procs if p.exitcode is None]
            end = time.monotonic() + grace_s
            while alive and time.monotonic() < end:
                multiprocessing.connection.wait(
                    alive, timeout=end - time.monotonic())
                alive = [p.sentinel for p in procs if p.exitcode is None]
            texts = []  # each rank that exited non-zero or wrote an error
            for r, p in enumerate(procs):
                path = os.path.join(tmp, f"error{r}.txt")
                if p.exitcode not in (None, 0) or os.path.exists(path):
                    texts.append(f"rank {r} of {len(procs)} failed (exit "
                                 f"code {p.exitcode})\n" + (
                                     open(path).read()
                                     if os.path.exists(path) else ""))
            raise RuntimeError("\n".join(texts))
        alive = [p for p in procs if p.exitcode is None]
        if not alive:
            return
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"{len(alive)} of {len(procs)} ranks still "
                               "running at the deadline")
        multiprocessing.connection.wait([p.sentinel for p in alive],
                                        timeout=left)

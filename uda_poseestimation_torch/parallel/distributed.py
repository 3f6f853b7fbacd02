"""Multi-process data parallelism on ``torch.distributed``.

The counterpart of ``uda_poseestimation_tpu/parallel/distributed.py``. The
JAX package runs one GSPMD program over a mesh that spans every process;
the port runs one process per GPU (NCCL) or per CPU run (gloo), each with
its contiguous rows of the global batch, and keeps the whole-batch meaning
of every batch reduction itself:

- W ranks, each given rows ``local_rows(B, rank, W)`` of a global batch B,
  compute what one process computes on B: integer decisions exactly, floats
  up to the order of the collectives' sums;
- BatchNorm statistics are taken over the global batch
  (``parallel/sync_bn.py``, whenever a group of more than one process is
  up); the confidence mask's kth value over the gathered activations; the
  per-sample draws (occlusion, ``--device-aug`` views) for the global batch
  from the synchronized generator, of which a rank keeps its rows
  (``global_draw``); gradients and metrics are averaged;
- the control stream (style gates and alphas, the per-epoch generator
  seed) is ``control_rng(seed, epoch)`` on every rank when W > 1;
- the training loaders take DistributedSampler semantics
  (``data/loader.py::PartitionSampler``, JAX's ``DataLoader(partition=)``);
- only rank 0 writes logs, checkpoints and images; every rank waits at
  ``barrier("best_pt")`` before the pretrain->adapt reload (a shared
  filesystem, as in JAX).

With no ``--dist-coordinator`` no group is made and the program runs the
single-process code. At W = 1 with a group the step runs its collectives
(identities at one rank) and keeps the single-process data order, control
stream and BatchNorm.

The partition arithmetic (``local_batch_size``, ``local_rows``) is a pure
function of (rank, world) when both are given, so it can be held against
JAX's without a group.
"""

from __future__ import annotations

import datetime
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from ..device import DeviceLike, resolve_device
from ..tools.launch_distributed import free_port  # noqa: F401 (the coordinator port)

# the trainers' rendezvous and collective timeout: a rank may wait that long
# for another that still builds its datasets
DEFAULT_TIMEOUT_S = 1800.0

_INITIALIZED = None  # (coordinator, world, rank) of the group this module made


def _init_method(coordinator: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a ``tcp://`` or ``file://`` URL
    passes as it is (the CPU tests rendezvous through a file)."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def rank_device(process_id: int, device: DeviceLike = None) -> torch.device:
    """A rank's device: ``cuda:{process_id % device_count}`` for a CUDA
    run, the CPU for a CPU run."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def initialize(coordinator: str, num_processes: int, process_id: int,
               device: DeviceLike = None, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group: NCCL for a CUDA run, gloo on the CPU (or as
    ``backend`` says). Call before the first CUDA use. Idempotent; joining
    again with another topology raises. Returns the rank's device."""
    global _INITIALIZED
    spec = (coordinator, num_processes, process_id)
    if _INITIALIZED:
        if _INITIALIZED != spec:
            raise RuntimeError(f"torch.distributed already initialized as {_INITIALIZED}; "
                               f"got {spec}")
        return rank_device(process_id, device)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside {num_processes} processes")
    dev = rank_device(process_id, device)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        kwargs["device_id"] = dev
    tdist.init_process_group(backend, init_method=_init_method(coordinator),
                             world_size=num_processes, rank=process_id,
                             timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _INITIALIZED = spec
    return dev


def shutdown():
    """Leave the group this module joined (a no-op without one)."""
    global _INITIALIZED
    if _INITIALIZED and tdist.is_initialized():
        tdist.destroy_process_group()
    _INITIALIZED = None


def maybe_initialize_from_args(args) -> bool:
    """The trainers' hook: join the group when ``--dist-coordinator`` is
    given (``--dist-num-processes`` alone changes nothing, as in JAX).
    The global batch must split evenly over the processes (checked before
    joining). Without ``--seed`` it warns and uses 0, since the ranks'
    control streams derive from it. Returns whether a group is up."""
    spec = getattr(args, "dist_coordinator", None)
    if not spec:
        return False
    local_batch_size(args.batch_size, args.dist_num_processes)
    if getattr(args, "seed", None) is None:
        warnings.warn("multi-process training requires a seed for "
                      "process-synchronized control RNG; using --seed 0")
        args.seed = 0
    initialize(spec, args.dist_num_processes, args.dist_process_id,
               device=getattr(args, "device", None))
    return True


def is_active() -> bool:
    """Whether a process group is up (of any size)."""
    return tdist.is_available() and tdist.is_initialized()


def process_count() -> int:
    return tdist.get_world_size() if is_active() else 1


def process_index() -> int:
    return tdist.get_rank() if is_active() else 0


def is_primary() -> bool:
    return process_index() == 0


def is_multiprocess() -> bool:
    return process_count() > 1


def control_rng(seed: int, epoch: int = 0) -> np.random.RandomState:
    """The process-synchronized stream of the control draws (style gates
    and alphas, the per-epoch generator seed): the same on every rank,
    another per epoch (JAX's formula)."""
    return np.random.RandomState((int(seed) * 1000003 + epoch) % (2 ** 31 - 1))


def local_batch_size(global_batch: int, world: Optional[int] = None) -> int:
    """A rank's share of a global batch, which must split evenly."""
    world = process_count() if world is None else world
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by {world} processes")
    return global_batch // world


def local_rows(n: int, rank: Optional[int] = None, world: Optional[int] = None) -> slice:
    """The contiguous rows of a rank in a size-n global batch axis."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    per = local_batch_size(n, world)
    return slice(rank * per, (rank + 1) * per)


def global_draw(draw, b_local: int, axis: int = 0):
    """``draw(n)`` for the global batch of a local batch of ``b_local``
    (``n = b_local * world``), sliced to this rank's rows along ``axis``:
    every rank draws the same from its synchronized generator, so that a
    sample's draw does not depend on how the batch is split. Without a
    group, ``draw(b_local)`` as it is."""
    if not is_active():
        return draw(b_local)
    n = b_local * process_count()
    return take_rows(draw(n), local_rows(n), axis)


def take_rows(tree, rows: slice, axis: int = 0):
    """Every tensor of a dict tree sliced to ``rows`` along ``axis`` (views)."""
    if isinstance(tree, torch.Tensor):
        return tree[(slice(None),) * axis + (rows,)]
    return {k: take_rows(v, rows, axis) for k, v in tree.items()}


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the card for
    NCCL, the CPU for gloo."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place; every rank gets the same bits."""
    tdist.all_reduce(t)
    return t


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` (equal shapes) in rank order along axis 0.
    Each rank writes its rows into a zero buffer and the buffers are summed:
    adding zeros is exact, and an all-reduce is capturable in a CUDA graph
    under NCCL and runs on CUDA tensors under gloo."""
    world, rank = process_count(), process_index()
    out = t.new_zeros((world * t.shape[0],) + tuple(t.shape[1:]))
    out[rank * t.shape[0]:(rank + 1) * t.shape[0]] = t
    return all_reduce_sum(out)


def _by_dtype(tensors):
    buckets = {}
    for t in tensors:
        buckets.setdefault(t.dtype, []).append(t)
    return buckets.values()


def all_reduce_mean_(tensors):
    """Average ``tensors`` over the ranks in place, one flat bucket per
    dtype (the gradients after ``backward``)."""
    world = process_count()
    for bucket in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        all_reduce_sum(flat).div_(world)
        at = 0
        for t in bucket:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()


def broadcast_(tensors, src: int = 0):
    """Overwrite ``tensors`` with rank ``src``'s, one flat bucket per dtype."""
    for bucket in _by_dtype(tensors):
        flat = torch.cat([t.detach().reshape(-1) for t in bucket])
        tdist.broadcast(flat, src)
        at = 0
        for t in bucket:
            t.detach().copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()


def broadcast_modules(*modules, src: int = 0):
    """Rank ``src``'s parameters and buffers in every rank's ``modules``
    (after ``create_state`` and after a restore)."""
    if not is_active():
        return
    tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
    with torch.no_grad():
        broadcast_(tensors, src)


def broadcast_str(value: str, max_len: int = 256) -> str:
    """Rank 0's ``value`` on every rank (the checkpoint directory's
    timestamp)."""
    if not is_active():
        return value
    buf = torch.zeros(max_len, dtype=torch.uint8)
    raw = value.encode()[:max_len]
    buf[:len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    buf = buf.to(_comm_device())
    tdist.broadcast(buf, 0)
    out = buf.cpu().numpy()
    return bytes(out[out != 0]).decode()


def barrier(name: str = "barrier"):
    """Wait for every rank (before reading a file that rank 0 wrote).
    ``name`` says where, for a reader of a hang."""
    if is_multiprocess():
        t = torch.zeros(1, device=_comm_device())
        all_reduce_sum(t)
        t.cpu()  # waits for the collective


def warm_up(stream: torch.cuda.Stream):
    """One collective on ``stream`` (eagerly), so that an NCCL communicator
    exists before a CUDA graph captures collectives on that stream."""
    if not is_active():
        return
    t = torch.zeros(1, device=_comm_device())
    with torch.cuda.stream(stream):
        all_reduce_sum(t)
    torch.cuda.current_stream(t.device).wait_stream(stream)
    t.cpu()


def graph_capturable() -> bool:
    """Whether the group's collectives may be captured in a CUDA graph:
    NCCL's may, gloo's may not."""
    return not is_active() or tdist.get_backend() == "nccl"


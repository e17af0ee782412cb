"""The ranks of the sharded cohort step (twin of ``grid_tpu/parallel/mesh.py``).

The cohort (sample) axis is the data-parallel axis, as in the JAX package:
each rank holds one block of B = ceil(N / W) rows (the last blocks padded
with invalid rows), and the collectives of :class:`CohortGroup` exchange
what the rows of other ranks contribute: column statistics
(:meth:`CohortGroup.all_reduce_sum`), the ring kNN's visiting block
(:meth:`CohortGroup.ring_shift`) and per-row vectors
(:meth:`CohortGroup.all_gather_rows`). Where the JAX package names a device
mesh, the port names a number of ranks, W, each a process.

Placement and transport. Rank r runs on ``cuda:{r % device_count}`` (or on
the CPU under ``platform="cpu"``). The transport follows from that placement,
once, and is logged: NCCL where every rank has a card of its own; gloo where
ranks share a card (W ranks on one H100) or run on the CPU. NCCL refuses two
ranks on one device, and gloo takes CUDA tensors for broadcast, all_reduce
and barrier only, so under gloo the ranks' card tensors travel through
pinned host buffers. A transport that fails raises; nothing switches
transport or device on a failure.

Running the ranks (:func:`run_ranks`): W processes of ``torch.multiprocessing``'s
spawn context (a process that has touched CUDA cannot fork it). Their inputs
and outputs are CPU tensors that every rank maps from one file of a
temporary directory (:class:`RankWorkspace`), so a rank writes its rows'
outputs in place and nothing is gathered to rank 0; the directory also holds
the process group's ``FileStore``, so runs side by side never compete for a
port. The ranks inherit the parent's environment, the build cache's
directory among it (``utils/device.py``), but not ``GRID_TPU_PROFILE_DIR``. A rank's exception reaches the parent, which raises
:class:`RankFailure` after the other ranks are stopped. The parent loads the
kernel libraries before it spawns, so the ranks do not each run nvcc.
``<wrapper>.launches`` counts per process: each rank reports its counts, the
parent adds them to its own and returns them rank by rank.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import tempfile
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

from grid_tpu_torch import native
from grid_tpu_torch.ops import gpu_kernels, gpu_select, phasing
from grid_tpu_torch.utils.logging import log
from grid_tpu_torch.utils.timing import PROFILE_ENV

# the kernel wrappers whose launches a rank reports
COUNTED = {
    "masked_column_stats": gpu_kernels.masked_column_stats,
    "zprep_gram": gpu_kernels.zprep_gram,
    "zprep_split": gpu_kernels.zprep_split,
    "zprep_gram_panel": gpu_kernels.zprep_gram_panel,
    "zprep_gram_cross": gpu_kernels.zprep_gram_cross,
    "dipcn_from_distances_gpu": gpu_select.dipcn_from_distances_gpu,
    "sorted_smallest_k_gpu": gpu_select.sorted_smallest_k_gpu,
    "phase_sweeps_gpu": phasing.phase_sweeps_gpu,
}


class RankFailure(RuntimeError):
    """A rank raised or died; the message holds its traceback."""


def choose_transport(world: int, platform: str) -> str:
    """``"nccl"`` where each of the ``world`` ranks has a card of its own,
    ``"gloo"`` where ranks share a card or run on the CPU."""
    if platform == "cpu":
        return "gloo"
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("the sharded step was asked to run on the card, but CUDA has no device")
    return "nccl" if world <= cards else "gloo"


def init_distributed(world: int, rank: int, backend: str, store_path: str | None = None) -> None:
    """Join the ranks' process group, once per process: through a
    ``FileStore`` at ``store_path`` where one is given (the ranks of
    :func:`run_ranks`, so runs side by side never compete for a port), else
    through ``env://`` (a process that torchrun started, with its
    ``MASTER_ADDR`` and ``MASTER_PORT``). A run of one rank forms a group
    of one too, so its collectives take the transport's code as at W > 1."""
    if dist.is_initialized():
        return
    if store_path is None:
        dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
        return
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, world_size=world, rank=rank)


class CohortGroup:
    """One rank's view of the sharded cohort: the world size, its rank,
    its ``torch.device`` and the transport, with the collectives of the
    sharded step (the JAX package's mesh axis and its ``psum``,
    ``ppermute`` and all-gathers)."""

    def __init__(self, world: int, rank: int, device: torch.device, transport: str):
        self.world, self.rank, self.device, self.transport = world, rank, device, transport
        self._pinned: dict = {}  # gloo's host copies of card tensors, reused step to step

    def _staged(self) -> bool:
        """Whether card tensors must travel through host buffers (gloo)."""
        return self.transport == "gloo" and self.device.type == "cuda"

    def _host(self, slot: str, t: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer shaped as ``t``, kept for ``slot``."""
        buf = self._pinned.get(slot)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[slot] = buf
        return buf

    def barrier(self) -> None:
        """Wait until every rank has reached this call."""
        dist.barrier(**({"device_ids": [self.device.index]} if self.transport == "nccl" else {}))

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """[B, ...] on every rank -> [W * B, ...], the ranks' blocks in rank
        order, on every rank."""
        t = t.contiguous()
        wire = t.view(torch.uint8) if t.dtype == torch.bool else t
        if self.transport == "nccl":
            out = torch.empty((self.world * wire.shape[0], *wire.shape[1:]), dtype=wire.dtype,
                              device=wire.device)
            dist.all_gather_into_tensor(out, wire)
        else:
            src = self._host("gather_in", wire).copy_(wire) if self._staged() else wire
            parts = [torch.empty_like(src) for _ in range(self.world)]
            dist.all_gather(parts, src)
            out = torch.cat(parts).to(t.device)
        return out.view(torch.bool) if t.dtype == torch.bool else out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``t``, on every rank: an all-gather, then
        the ranks' tensors added in rank order. A ring all-reduce adds each
        chunk of a buffer in another rank order, so two columns with equal
        partial sums could come out a rounding apart; here every entry is
        added in one order, and every rank gets the same bits. bfloat16 is
        added in float32 and rounded once, as XLA's ``psum`` sums it (added
        in bfloat16 rank by rank, a sum rounds at every add)."""
        parts = self.all_gather_rows(t.reshape(1, -1))
        half = t.dtype == torch.bfloat16
        total = parts[0].float() if half else parts[0].clone()
        for part in parts[1:]:
            total += part
        return total.to(t.dtype).view(t.shape)

    def ring_shift(self, tensors) -> list:
        """Send each tensor to rank (rank + 1) % W and receive its like from
        rank (rank - 1) % W, as one batch of point-to-point operations (the
        JAX ring's ``ppermute``). Returns the received tensors."""
        if self.world == 1:
            return list(tensors)
        to, frm = (self.rank + 1) % self.world, (self.rank - 1) % self.world
        tensors = [t.contiguous() for t in tensors]
        wires = [t.view(torch.uint8) if t.dtype == torch.bool else t for t in tensors]
        if self._staged():
            sends = [self._host(f"send{i}", w).copy_(w) for i, w in enumerate(wires)]
            recvs = [self._host(f"recv{i}", w) for i, w in enumerate(wires)]
        else:
            sends, recvs = wires, [torch.empty_like(w) for w in wires]
        ops = [dist.P2POp(dist.isend, s, to) for s in sends]
        ops += [dist.P2POp(dist.irecv, r, frm) for r in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = []
        for t, r in zip(tensors, recvs):
            got = r.to(t.device, copy=self._staged())
            out.append(got.view(torch.bool) if t.dtype == torch.bool else got)
        return out


def pad_rows(t: torch.Tensor, rows: int, fill=0) -> torch.Tensor:
    """``t`` with axis 0 padded to ``rows`` by ``fill``."""
    extra = rows - t.shape[0]
    if extra == 0:
        return t
    return torch.cat([t, t.new_full((extra, *t.shape[1:]), fill)])


def block_rows(n: int, world: int) -> int:
    """B, the rows of each rank's block: N padded to a multiple of W, over W."""
    return -(-n // world)


def shard_cohort_inputs(group: CohortGroup, values, mask, reads, reads_valid, dtype=None,
                        reads_dtype=None):
    """This rank's block of the host arrays, padded and on its device.

    Args:
        values, mask: [N, R] host tensors or arrays (every rank's view).
        reads, reads_valid: [N].
        dtype: the float type of values (and of reads, unless
            ``reads_dtype`` names theirs) on the device (default: as given).
        reads_dtype: the float type of reads (bfloat16 values take the
            step dtype's reads: ``parallel/pcohort.py``).

    Returns (values [B, R], mask [B, R] bool, reads [B], reads_valid [B]
    bool, row_valid [B] bool, row0): padding rows are masked out, and row0
    is the block's first row in the cohort.
    """
    n = values.shape[0]
    b = block_rows(n, group.world)
    row0 = group.rank * b
    lo, hi = min(row0, n), min(row0 + b, n)

    def block(a, fill, dt=None):
        t = pad_rows(torch.as_tensor(a[lo:hi]), b, fill)
        return t.to(device=group.device, dtype=dt)

    row_valid = (torch.arange(row0, row0 + b) < n).to(group.device)
    return (block(values, 0, dtype), block(mask, False, torch.bool),
            block(reads, 0, reads_dtype or dtype),
            block(reads_valid, False, torch.bool), row_valid, row0)


class SharedTensor(NamedTuple):
    """A CPU tensor that every rank maps from one file (MAP_SHARED): what a
    rank writes into it, the parent reads."""

    path: str
    shape: tuple
    dtype: torch.dtype

    def open(self) -> torch.Tensor:
        numel = math.prod(self.shape)
        if numel == 0:
            return torch.empty(self.shape, dtype=self.dtype)
        return torch.from_file(self.path, shared=True, size=numel, dtype=self.dtype).view(
            self.shape)


class RankWorkspace:
    """The files of one run of ranks, in a temporary directory removed on
    exit: the process group's FileStore and the shared tensors. A tensor
    opened in the parent stays readable after the exit (the mapping
    outlives the file)."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="grid_tpu_torch_ranks_")
        self._count = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        shutil.rmtree(self.dir, ignore_errors=True)

    def empty(self, shape, dtype) -> SharedTensor:
        """A zero-filled shared tensor."""
        self._count += 1
        handle = SharedTensor(os.path.join(self.dir, f"t{self._count}"), tuple(shape), dtype)
        handle.open()  # the file exists, at its size, before any rank maps it
        return handle

    def put(self, array, dtype=None) -> SharedTensor:
        """A shared copy of ``array`` (a tensor or an array), in ``dtype``."""
        t = torch.as_tensor(array)
        handle = self.empty(t.shape, dtype or t.dtype)
        handle.open().copy_(t)
        return handle


def _rank_main(rank, fn, world, platform, transport, run_dir, shapes, dtype, args, spawned_at):
    """A spawned rank: join the group, run ``fn(group, *args)``, write its
    report to ``rank<r>.json`` in ``run_dir``. An exception is written,
    with the time, to ``rank<r>.error`` there: the rank that failed first
    names the cause, the others' lost connections follow from it."""
    try:
        _rank_body(rank, fn, world, platform, transport, run_dir, shapes, dtype, args, spawned_at)
    except BaseException:
        with open(os.path.join(run_dir, f"rank{rank}.error"), "w") as f:
            f.write(f"{time.time_ns()}\n{traceback.format_exc()}")
        raise


def _rank_body(rank, fn, world, platform, transport, run_dir, shapes, dtype, args, spawned_at):
    # a rank's spans write no trace: W ranks would write W traces of one
    # name over each other (utils/timing.py)
    os.environ.pop(PROFILE_ENV, None)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if platform == "cpu":
        device = torch.device("cpu")
    else:
        device = torch.device(f"cuda:{rank % torch.cuda.device_count()}")
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    init_distributed(world, rank, transport, os.path.join(run_dir, "store"))
    try:
        # the transport's connections (NCCL's communicator) are made, and the
        # kernels the parent built are loaded, outside the time of fn
        dist.barrier(**({"device_ids": [device.index]} if transport == "nccl" else {}))
        if device.type == "cuda":
            load_kernels(device, shapes, dtype)
        group = CohortGroup(world, rank, device, transport)
        for wrapper in COUNTED.values():
            wrapper.launches = 0
        started = time.time() - spawned_at
        t0 = time.perf_counter()
        extra = fn(group, *args) or {}
        peak = 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device)
        report = {name: wrapper.launches for name, wrapper in COUNTED.items()}
        report.update(peak_bytes=peak, seconds=time.perf_counter() - t0,
                      start_seconds=started, **extra)
        with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def _failure_message(run_dir: str, world: int, exc: ProcessException) -> str:
    """The ranks' errors, the first in time first (the cause; the others
    mostly lost their connection to it), or spawn's own report where no
    rank wrote one (a rank killed by a signal)."""
    errors = []
    for rank in range(world):
        path = os.path.join(run_dir, f"rank{rank}.error")
        if os.path.exists(path):
            stamp, _, text = open(path).read().partition("\n")
            errors.append((int(stamp), rank, text))
    if not errors:
        return f"a rank of {world} failed:\n{exc}"
    errors.sort()
    first = errors[0]
    msg = f"rank {first[1]} of {world} failed first:\n{first[2]}"
    for _, rank, text in errors[1:]:
        msg += f"\nthen rank {rank}:\n{text}"
    return msg


def load_kernels(device: torch.device, shapes=(), dtype: torch.dtype = torch.float32) -> None:
    """Build and load the Gram kernel's library of ``dtype`` (float32's, and
    float64's or bfloat16's where the step runs in them), and compile the
    Triton kernels in ``dtype`` for the ``(rows, columns)`` of each rank's
    column statistics: in the parent so that the ranks find them built, in
    each rank (from the caches) so that its first launch times no
    loading."""
    native.load("zprep_gram")
    native.load(gpu_kernels._gram_lib(dtype)[0])
    for rows, cols in shapes:
        gpu_kernels.compile_masked_column_stats(rows, cols, device, dtype)


def run_ranks(fn, world: int, args, platform: str, workspace: RankWorkspace, console=None,
              shapes=(), dtype: torch.dtype = torch.float32) -> list:
    """Run ``fn(group, *args)`` on ``world`` spawned ranks and wait for all.

    ``fn`` must be importable (a module-level function) and its ``args``
    picklable: :class:`SharedTensor` handles of ``workspace`` for the data;
    ``platform`` is ``"cuda"`` or ``"cpu"``. On the card the parent first
    loads the kernels (:func:`load_kernels`, with ``shapes`` and the step's
    ``dtype``).

    Returns one dict per rank: the launches of each counted wrapper (also
    added to this process's counts), ``peak_bytes`` of device memory,
    ``seconds`` of ``fn`` on the rank's host clock after a device sync,
    ``start_seconds`` from the spawn to ``fn``'s start (the interpreter,
    the imports, the group, the card's context and the kernels' loading),
    and what ``fn`` returned (a dict of numbers, or None). Raises
    :class:`RankFailure` when a rank raises or dies.
    """
    if world < 1:
        raise ValueError(f"world={world} must be >= 1")
    transport = choose_transport(world, platform)
    where = "the CPU" if platform == "cpu" else (
        f"{min(world, torch.cuda.device_count())} card(s)")
    log(console, f"sharded step: {world} rank(s) on {where}, transport {transport}",
        style="info")
    if platform != "cpu":
        load_kernels(torch.device("cuda"), shapes, dtype)
    try:
        torch.multiprocessing.start_processes(
            _rank_main,
            args=(fn, world, platform, transport, workspace.dir, shapes, dtype, args, time.time()),
            nprocs=world, join=True, start_method="spawn")
    except ProcessException as e:
        raise RankFailure(_failure_message(workspace.dir, world, e)) from e
    reports = []
    for rank in range(world):
        with open(os.path.join(workspace.dir, f"rank{rank}.json")) as f:
            reports.append(json.load(f))
    for name, wrapper in COUNTED.items():
        native.count_launch(wrapper, sum(rep[name] for rep in reports))
    return reports

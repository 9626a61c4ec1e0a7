"""Process groups, named meshes and collectives (counterpart of
calipsync_tpu/core/mesh.py).

The process model: one process a card (a "rank"), every rank running the
same program and joined by one ``torch.distributed`` process group, as
every JAX process runs the same program over a multi-host mesh. The mesh
names its axes with JAX's names through a
``torch.distributed.device_mesh.DeviceMesh``: ``("data",)``,
``("host", "data")`` (process-major, as ``make_hybrid_mesh``), ``("data",
"model")``, ``("model",)`` and ``("expert",)``. Where a JAX function runs
under ``shard_map`` with ``P(axis)``, the port's counterpart runs on every
rank with that rank's block of rows and calls the collectives below.

The backend is the caller's: NCCL where each rank has its own card, gloo
on the CPU, or gloo for several ranks that share one card (NCCL refuses
two ranks on one device). Nothing falls back: a backend that fails raises.
gloo runs only ``broadcast`` and ``all_reduce`` on CUDA tensors, so the
collective helpers here stage the other collectives of a gloo group
through host memory; the choice is made from the group's backend, in this
module only.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile
import time
import traceback
import warnings
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

AxisNames = Union[str, Tuple[str, ...]]


# ---------------------------------------------------------------- runtime

def maybe_initialize_distributed(
        coordinator_address: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None) -> bool:
    """Join the process group described by the environment; a no-op
    (returns False) when it describes one process. Idempotent.

    Reads ``CALIPSYNC_COORDINATOR`` (``host:port``, ``tcp://host:port`` or
    ``file://path``), ``CALIPSYNC_NUM_PROCESSES``, ``CALIPSYNC_PROCESS_ID``
    and ``CALIPSYNC_DIST_TIMEOUT_S`` as the JAX package does, or torchrun's
    ``MASTER_ADDR``/``WORLD_SIZE``/``RANK`` when ``CALIPSYNC_COORDINATOR``
    is unset. ``CALIPSYNC_DIST_BACKEND`` names the backend: ``nccl`` by
    default where CUDA is available, else ``gloo``.
    ``CALIPSYNC_LOCAL_DEVICE`` (torchrun's ``LOCAL_RANK`` otherwise, else
    the rank modulo the visible cards) is the card a NCCL rank takes
    (``torch.cuda.set_device``)."""
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator = coordinator_address or env.get("CALIPSYNC_COORDINATOR")
    if coordinator:
        nproc = (num_processes if num_processes is not None
                 else int(env.get("CALIPSYNC_NUM_PROCESSES", "0") or 0))
        rank = (process_id if process_id is not None
                else int(env.get("CALIPSYNC_PROCESS_ID", "-1")))
        init = (coordinator if "://" in coordinator
                else f"tcp://{coordinator}")
    elif int(env.get("WORLD_SIZE", "1")) > 1 and "MASTER_ADDR" in env:
        nproc, rank, init = (int(env["WORLD_SIZE"]), int(env["RANK"]),
                             "env://")
    else:
        return False
    if nproc <= 1:
        return False
    if rank < 0 or rank >= nproc:
        raise ValueError(f"process id {rank} outside [0, {nproc})")
    backend = (env.get("CALIPSYNC_DIST_BACKEND")
               or ("nccl" if torch.cuda.is_available() else "gloo"))
    if backend == "nccl":
        local = env.get("CALIPSYNC_LOCAL_DEVICE", env.get("LOCAL_RANK"))
        torch.cuda.set_device(int(local) if local is not None
                              else rank % max(1, torch.cuda.device_count()))
    kwargs = {}
    timeout_s = env.get("CALIPSYNC_DIST_TIMEOUT_S")
    if timeout_s:
        kwargs["timeout"] = datetime.timedelta(seconds=int(timeout_s))
    dist.init_process_group(backend, init_method=init, world_size=nproc,
                            rank=rank, **kwargs)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


# ---------------------------------------------------------------- meshes

@dataclass(frozen=True)
class Mesh:
    """A named mesh over ranks: the ``DeviceMesh`` and, for a tuple of
    axes, the group that spans them. ``shape`` maps axis name -> size, as
    ``jax.sharding.Mesh.shape`` does."""

    device_mesh: object
    groups: dict

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.device_mesh.shape))

    @property
    def size(self) -> int:
        return int(np.prod(self.device_mesh.shape))

    def is_member(self) -> bool:
        return self.device_mesh.get_coordinate() is not None

    def axis_size(self, axes: AxisNames) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def axis_index(self, axes: AxisNames) -> int:
        """This rank's index along ``axes`` (row-major over a tuple, as
        ``jax.lax.axis_index``)."""
        coord = dict(zip(self.axis_names, self.device_mesh.get_coordinate()))
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + coord[a]
        return idx

    def group(self, axes: AxisNames):
        return self.groups[_axes(axes)]


def _axes(axes: AxisNames) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _build(ranks: np.ndarray, names: Sequence[str]) -> Mesh:
    """Build a mesh over the ``ranks`` array (every rank of the group
    calls this, members or not)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start the ranks with core.mesh.launch, "
            "torchrun or the CALIPSYNC_* variables "
            "(maybe_initialize_distributed)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type, torch.as_tensor(ranks),
                    mesh_dim_names=tuple(names))
    member = dm.get_coordinate() is not None
    groups = {(n,): dm.get_group(n) for n in names} if member else {}
    if len(names) > 1:
        # every rank of the process group creates it, in the same order
        group = dist.new_group(sorted(int(r) for r in ranks.ravel()))
        if member:
            groups[tuple(names)] = group
    return Mesh(dm, groups)


def make_mesh(data: int = -1, axis_name: str = "data") -> Mesh:
    """A 1-D ``(axis_name,)`` mesh over the first ``data`` ranks (-1: all
    of them)."""
    n = world_size()
    data = n if data == -1 else data
    if data > n:
        raise ValueError(f"requested {data} ranks, the group has {n}")
    return _build(np.arange(data), (axis_name,))


def make_named_mesh(shape: Sequence[int], names: Sequence[str],
                    first: int = 0) -> Mesh:
    """A mesh of ``shape`` over ranks ``[first, first + prod(shape))``,
    named ``names`` (row-major: the last axis varies fastest)."""
    n, need = world_size(), int(np.prod(shape))
    if first + need > n:
        raise ValueError(f"a {tuple(shape)} mesh from rank {first} needs "
                         f"{first + need} ranks, the group has {n}")
    return _build(first + np.arange(need).reshape(tuple(shape)), names)


def make_hybrid_mesh(data: int = -1, dcn: int = -1,
                     axis_name: str = "data",
                     dcn_axis_name: str = "host") -> Mesh:
    """2-D ``(host, data)`` mesh, process-major: host h holds ranks
    ``[h*per_host, (h+1)*per_host)``, of which the first ``data``. With
    ``dcn=-1`` a host is a node (``LOCAL_WORLD_SIZE`` ranks, or all
    ranks on one node)."""
    n = world_size()
    if dcn == -1:
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        dcn = max(1, n // per_node)
    if n % dcn:
        raise ValueError(f"{n} ranks not divisible into {dcn} hosts")
    per_host = n // dcn
    data = per_host if data == -1 else data
    if data > per_host:
        raise ValueError(f"requested {data} ranks a host, have {per_host}")
    ranks = np.arange(n).reshape(dcn, per_host)[:, :data]
    return _build(ranks, (dcn_axis_name, axis_name))


def build_mesh(cfg) -> Mesh:
    """MeshConfig -> its mesh: 1-D ``(data,)`` for ``dcn == 1``, the 2-D
    ``(host, data)`` hybrid otherwise; joins the process group the
    environment describes first."""
    maybe_initialize_distributed()
    if not dist.is_initialized():
        if cfg.data not in (-1, 1) or cfg.dcn not in (-1, 1):
            raise RuntimeError(
                f"mesh.data={cfg.data}, mesh.dcn={cfg.dcn} need that many "
                "ranks: launch one process a card (torchrun, or the "
                "CALIPSYNC_* variables)")
        return None
    if cfg.dcn == 1:
        return make_mesh(cfg.data, cfg.axis_name)
    return make_hybrid_mesh(cfg.data, cfg.dcn, cfg.axis_name,
                            cfg.dcn_axis_name)


def batch_axes(mesh: Mesh) -> AxisNames:
    """The axis name(s) a data batch shards over: every mesh axis."""
    names = mesh.axis_names
    return names[0] if len(names) == 1 else names


def local_batch_size(global_batch: int, mesh: Mesh,
                     axis_name: AxisNames = "data") -> int:
    n = mesh.axis_size(axis_name)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{axis_name}={n}")
    return global_batch // n


def shard_rows(x, mesh: Mesh, axes: Optional[AxisNames] = None):
    """This rank's contiguous rows ``[r*B/D, (r+1)*B/D)`` of ``x``, as
    ``P(axes)`` places them."""
    axes = axes or batch_axes(mesh)
    n = local_batch_size(x.shape[0], mesh, axes)
    r = mesh.axis_index(axes)
    return x[r * n:(r + 1) * n]


def shard_batch(batch, mesh: Mesh, axes: Optional[AxisNames] = None):
    """A dict (or one array) of global host rows -> this rank's rows."""
    if isinstance(batch, dict):
        return {k: shard_rows(v, mesh, axes) for k, v in batch.items()}
    return shard_rows(batch, mesh, axes)


def replicate(tensors, mesh: Mesh, axes: Optional[AxisNames] = None):
    """Broadcast from index 0 of ``axes`` (every mesh axis by default) in
    place: a tensor, a list of tensors or a module's parameters and
    buffers; returns the argument."""
    axes = axes or batch_axes(mesh)
    if isinstance(tensors, torch.nn.Module):
        items = list(tensors.parameters()) + list(tensors.buffers())
    elif isinstance(tensors, torch.Tensor):
        items = [tensors]
    else:
        items = list(tensors)
    with torch.no_grad():
        for t in items:
            broadcast(t.data, mesh, axes, src_index=0)
    return tensors


# ----------------------------------------------------------- collectives

def _host_staged(t: torch.Tensor, group) -> bool:
    """gloo runs only broadcast and all_reduce on CUDA tensors: every
    other collective of a gloo group goes through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def broadcast(t: torch.Tensor, mesh: Mesh, axes: AxisNames,
              src_index: int = 0) -> torch.Tensor:
    """In place, from index ``src_index`` of ``axes``."""
    group = mesh.group(axes)
    dist.broadcast(t, dist.get_process_group_ranks(group)[src_index],
                   group=group)
    return t


def all_reduce(t: torch.Tensor, mesh: Mesh, axes: AxisNames,
               op: str = "sum") -> torch.Tensor:
    """Sum (or ``op="mean"``) over ``axes``, in place; returns ``t``."""
    dist.all_reduce(t, group=mesh.group(axes))
    if op == "mean":
        t.div_(mesh.axis_size(axes))
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axes: AxisNames
               ) -> torch.Tensor:
    """Concatenate every rank's ``t`` along dim 0 in index order (JAX's
    ``all_gather(tiled=True)``)."""
    group = mesh.group(axes)
    n = mesh.axis_size(axes)
    src = t.contiguous()
    staged = _host_staged(src, group)
    if staged:
        src = src.cpu()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # as reduce_scatter
        dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device, non_blocking=True) if staged else out


def reduce_scatter(t: torch.Tensor, mesh: Mesh, axes: AxisNames
                   ) -> torch.Tensor:
    """Sum over ``axes``, then this rank's 1/D block of dim 0 (JAX's
    ``psum_scatter(tiled=True)``)."""
    group = mesh.group(axes)
    n = mesh.axis_size(axes)
    if t.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(t.shape)} not divisible by {n}")
    src = t.contiguous()
    staged = _host_staged(src, group)
    if staged:
        src = src.cpu()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    with warnings.catch_warnings():
        # renamed reduce_scatter_single in newer releases; this name is in
        # every release the port runs on
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device, non_blocking=True) if staged else out


def all_to_all(t: torch.Tensor, mesh: Mesh, axes: AxisNames
               ) -> torch.Tensor:
    """Block i of dim 0 goes to index i; the result holds, at block j,
    what index j sent here (JAX's ``all_to_all(split_axis=0,
    concat_axis=0, tiled=True)``)."""
    group = mesh.group(axes)
    src = t.contiguous()
    staged = _host_staged(src, group)
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device, non_blocking=True) if staged else out


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]], mesh: Mesh,
             axes: AxisNames) -> None:
    """Point-to-point: send each ``(tensor, index)`` and receive into each
    ``(buffer, index)`` along ``axes``, all posted at once (a ring hop
    posts one of each, so no pair waits on another)."""
    group = mesh.group(axes)
    ranks = dist.get_process_group_ranks(group)
    staged = any(_host_staged(t, group) for t, _ in list(sends) + list(recvs))
    ops, landing = [], []
    for t, i in sends:
        src = t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, src.cpu() if staged else src,
                              ranks[i], group))
    for buf, i in recvs:
        dst = torch.empty(buf.shape, dtype=buf.dtype) if staged else buf
        landing.append((buf, dst))
        ops.append(dist.P2POp(dist.irecv, dst, ranks[i], group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if staged:
        for buf, dst in landing:
            buf.copy_(dst)


class _AllMean(torch.autograd.Function):
    """Mean over a group with its gradient: the backward of a mean of
    replicas is the mean of their gradients (the transpose of JAX's
    ``pmean``)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(t.clone(), mesh, axes, "mean")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, ctx.axes, "mean"), None, None


def all_mean_with_grad(t: torch.Tensor, mesh: Mesh,
                       axes: AxisNames) -> torch.Tensor:
    return _AllMean.apply(t, mesh, axes)


# --------------------------------------------------------------- launcher

# the bytes of a rank's output that a launch error quotes: its last ones
_LOG_TAIL = 4000


def _rank_main(rank: int, fn, args, world: int, init: str, backend: str,
               out_dir: str, dist_timeout_s: float) -> None:
    # the rank's output goes to its own file, which the parent prints (and
    # quotes the end of when a rank fails or the wait runs out)
    log = os.open(os.path.join(out_dir, f"rank{rank}.log"),
                  os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(log, 1)
    os.dup2(log, 2)
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(
                                seconds=dist_timeout_s))
    try:
        result = fn(*args)
        err = None
    except Exception:  # shipped to the parent, which raises it
        result, err = None, traceback.format_exc()
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump((result, err), f)
    os.replace(path + ".tmp", path)
    if err is None:
        dist.barrier()
    dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    # the result is on disk: leave without the interpreter's teardown, so
    # that a native library's destructor or a library's leftover thread
    # cannot turn a finished rank into a failed one
    os._exit(1 if err is not None else 0)


def _tail(path: str) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - _LOG_TAIL))
            return f.read().decode(errors="replace")
    except FileNotFoundError:
        return ""


def launch(fn: Callable, n: int, *args, backend: str = "gloo",
           timeout_s: float = 3600.0, dist_timeout_s: float = 600.0
           ) -> list:
    """Run ``fn(*args)`` on ``n`` new ranks joined by a ``file://`` group
    and return each rank's result, in rank order. ``fn`` must be a
    module-level function of an importable module (the ranks are spawned
    interpreters); its results travel back pickled, so return numpy
    arrays or CPU tensors. Each rank runs on one intra-op thread; with
    ``backend="nccl"`` rank r takes card r.

    Every wait is bounded. A collective waits at most ``dist_timeout_s``
    for its peers (the process group's timeout), and the ranks together
    at most ``timeout_s``. When a rank fails, the others get a few
    seconds to fail with it and are then killed; when ``timeout_s`` runs
    out, every rank is killed. Either raises, with each rank's exit code
    and the end of its output (a rank's exception raises with its
    traceback). The ranks' output is printed here when they end."""
    import multiprocessing
    import multiprocessing.connection

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="calipsync_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=False,
                             args=(r, fn, args, n, init, backend, tmp,
                                   dist_timeout_s))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed, timed_out = None, False  # failed: the first rank to fail
        try:
            running = {p.sentinel: r for r, p in enumerate(procs)}
            while running and failed is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    timed_out = True
                    break
                for s in multiprocessing.connection.wait(list(running),
                                                         timeout=left):
                    r = running.pop(s)
                    procs[r].join()
                    if procs[r].exitcode != 0 and failed is None:
                        failed = r
            if failed is not None:  # the others fail on broken connections
                grace = time.monotonic() + 10.0
                for p in procs:
                    p.join(max(0.0, grace - time.monotonic()))
        finally:
            killed = [r for r, p in enumerate(procs) if p.is_alive()]
            for r in killed:
                procs[r].kill()
                procs[r].join()
        logs = [_tail(os.path.join(tmp, f"rank{r}.log")) for r in range(n)]
        if timed_out or failed is not None:
            path = os.path.join(tmp, f"rank{failed}.pkl")
            if failed is not None and os.path.exists(path):
                with open(path, "rb") as f:
                    _, err = pickle.load(f)
                raise RuntimeError(f"rank {failed} failed:\n{err}")
            what = (f"did not end within {timeout_s:g} s" if timed_out
                    else f"failed: rank {failed} exited first")
            raise RuntimeError(
                f"launch of {n} ranks {what}; exit codes "
                f"{[p.exitcode for p in procs]}, killed here: ranks "
                f"{killed}\n" + "\n".join(
                    f"--- rank {r}, the end of its output:\n{t}"
                    for r, t in enumerate(logs)))
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.log"), errors="replace"
                      ) as f:
                text = f.read()
            if text:
                print(f"--- rank {r}:\n{text}", end="" if
                      text.endswith("\n") else "\n")
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                result, err = pickle.load(f)
            if err is not None:
                raise RuntimeError(f"rank {r} failed:\n{err}")
            results.append(result)
        return results

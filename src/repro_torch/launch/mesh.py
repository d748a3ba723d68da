"""Process meshes for the topic-sharded engine (PyTorch port of
``repro.launch.mesh.make_host_mesh`` and ``repro.parallel.compat.make_mesh``).

The JAX package runs the sharded FOEM step as one program over a device
mesh (``shard_map``); the port runs it SPMD: one process (rank) per mesh
position, joined by ``torch.distributed``.  A :class:`Mesh` is this rank's
view of a ``(data, model)`` grid of ranks, rank ``r = d·model + m`` at
coordinates ``(d, m)``:

* ``mesh.model`` — the :class:`MeshAxis` over the ranks that share this
  rank's data index (the topic shards of one document shard);
* ``mesh.data``  — the :class:`MeshAxis` over the ranks that share its model
  index (the document shards of one topic shard);
* ``mesh.device`` — where this rank's tensors live.

The port's collectives are :meth:`MeshAxis.all_reduce`, a sum — the
counterpart of ``lax.psum`` — and :meth:`MeshAxis.all_to_all`, the tiled
``lax.all_to_all`` of the expert-parallel MoE; ``parallel.collectives``
builds the others on an axis's process group.  :func:`spawn_mesh` starts a
mesh of ranks on this host and returns what each rank's function returned.

:class:`AbstractMesh` is a mesh without ranks or devices (the counterpart
of ``compat.abstract_mesh``), and :func:`make_production_mesh` the JAX
package's production meshes as such descriptions: the sharding rules
(``parallel.sharding``) size a cell per device on them.  A rank's
:class:`Mesh` answers the same ``axis_names`` and ``shape``, so one set of
rules serves both.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.runtime.device import Device, resolve_device


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of a :class:`Mesh`, seen from one rank: its name, its size,
    this rank's coordinate along it and the process group of the ranks
    along it (``None`` when the axis has size 1)."""

    name: str
    size: int
    index: int
    group: Any = None

    def all_reduce(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Sum each tensor over the ranks of this axis, in ONE collective.

        The tensors (one dtype, any shapes) travel as one flat buffer; the
        sums come back in the input shapes, on the input device, and every
        rank of the axis receives the same bits.  On an axis of size 1 the
        inputs come back as they are (``lax.psum`` over one device).

        Transport: gloo takes CPU tensors, so on a gloo group a CUDA buffer
        is copied to the host, reduced there and copied back.  The copy
        carries the (D, L)-sized normalisers; the arithmetic of the step
        stays on the card.  An NCCL group reduces CUDA buffers in place;
        that branch has not run yet (it needs a card per rank).
        """
        if self.size == 1:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        host = (flat.device.type != "cpu"
                and dist.get_backend(self.group) == "gloo")
        buf = flat.cpu() if host else flat
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        if host:
            flat = buf.to(flat.device)
        out, lo = [], 0
        for t in tensors:
            out.append(flat[lo:lo + t.numel()].reshape(t.shape))
            lo += t.numel()
        return tuple(out)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """The tiled all-to-all over this axis, ``lax.all_to_all(x, axis,
        split_axis=0, concat_axis=0, tiled=True)``: x's leading axis is cut
        into ``size`` equal blocks, block j goes to the rank at coordinate
        j, and the blocks received come back in x's shape, concatenated in
        the senders' order.  On an axis of size 1, x comes back as it is.

        One ``all_to_all_single`` over the axis's group, on x's bytes (the
        collective moves them and adds nothing, so any type travels
        exactly).  On a gloo group a CUDA buffer goes through the host, as
        in :meth:`all_reduce`.
        """
        if self.size == 1:
            return x
        if x.shape[0] % self.size:
            raise ValueError(f"all_to_all over {self.size} ranks needs a "
                             f"leading axis that they divide, got "
                             f"{tuple(x.shape)}")
        src = x.contiguous().reshape(-1).view(torch.uint8)
        host = (src.device.type != "cpu"
                and dist.get_backend(self.group) == "gloo")
        send = src.cpu() if host else src
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        if host:
            recv = recv.to(src.device)
        return recv.view(x.dtype).view(x.shape)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a ``(data, model)`` mesh of ranks."""

    data: MeshAxis
    model: MeshAxis
    device: torch.device

    @property
    def rank(self) -> int:
        return self.data.index * self.model.size + self.model.index

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return {"data": self.data.size, "model": self.model.size}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of devices described by its axes alone: names and sizes, no
    ranks, no process groups (``compat.abstract_mesh``).  ``shape`` maps
    each name to its size, in ``axis_names`` order."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The JAX package's production meshes, described: one pod is (data 16,
    model 16), 256 devices; ``multi_pod`` is (pod 2, data 16, model 16),
    512.  Nothing runs on them: the dry run sizes a cell per device."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device: Device = "cuda") -> Mesh:
    """This rank's :class:`Mesh` over ``data × model`` ranks.

    Call it on every rank of an initialised process group of exactly
    ``data · model`` ranks (rank ``d·model + m`` sits at ``(d, m)``): every
    rank creates every group, in the same order, as ``dist.new_group``
    requires.  A 1 × 1 mesh needs no process group.  ``device`` defaults to
    ``"cuda"``, which raises on a host without a GPU.
    """
    dev = resolve_device(device)
    if data < 1 or model < 1:
        raise ValueError(f"mesh sizes must be >= 1, got ({data}, {model})")
    world = data * model
    if not dist.is_initialized():
        if world != 1:
            raise RuntimeError(
                f"a ({data}, {model}) mesh needs an initialised process "
                f"group of {world} ranks (see spawn_mesh)")
        return Mesh(MeshAxis("data", 1, 0), MeshAxis("model", 1, 0), dev)
    if dist.get_world_size() != world:
        raise RuntimeError(
            f"a ({data}, {model}) mesh needs {world} ranks, the process "
            f"group has {dist.get_world_size()}")
    d, m = divmod(dist.get_rank(), model)
    model_groups = [dist.new_group([i * model + j for j in range(model)])
                    for i in range(data)] if model > 1 else [None] * data
    data_groups = [dist.new_group([i * model + j for i in range(data)])
                   for j in range(model)] if data > 1 else [None] * model
    return Mesh(MeshAxis("data", data, d, data_groups[m]),
                MeshAxis("model", model, m, model_groups[d]), dev)


class RankError(RuntimeError):
    """A rank of :func:`spawn_mesh` raised; carries its traceback."""


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, data, model, init_method, backend, device, timeout_s,
               fn, args, results):
    try:
        world = data * model
        if device.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        else:
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        mesh = make_host_mesh(data, model, device=device)
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_mesh(fn: Callable, data: int = 1, model: int = 1, *,
               device: Device = "cuda", args: Sequence = (),
               timeout: float = 900.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``data × model`` ranks of this host.

    Each rank is a process started with the ``spawn`` method (``fn`` and
    ``args`` must pickle); the ranks meet at a free ``127.0.0.1`` TCP port,
    gloo over the loopback device.  Returns the ranks' return values in
    rank order.  If a rank raises, the others are stopped and
    :class:`RankError` re-raises its traceback here; so does a rank that
    dies without a result, or a mesh that runs past ``timeout`` seconds.
    Every process started is stopped before this returns.

    Backend: NCCL when ``device`` is CUDA and there is a card per rank
    (rank r on ``cuda:r``); gloo otherwise — on the CPU, and for ranks that
    share one card (NCCL refuses two ranks on one device).  One line says
    which.  The NCCL branch has not run yet: it waits for a cell of several
    cards.
    """
    dev = resolve_device(device)
    world = data * model
    own_card = dev.type == "cuda" and torch.cuda.device_count() >= world
    backend = "nccl" if own_card else "gloo"
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    devices = [torch.device("cuda", r) if backend == "nccl" else dev
               for r in range(world)]
    why = ("a card per rank" if backend == "nccl" else
           "ranks share one card" if dev.type == "cuda" else "CPU ranks")
    print(f"spawn_mesh: {world} ranks (data={data}, model={model}) on "
          f"{devices[0] if backend == 'gloo' else 'one card each'}, "
          f"backend {backend} ({why})", flush=True)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(
        r, data, model, init, backend, devices[r], timeout, fn, tuple(args),
        results)) for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in out]
            try:
                # a rank that died has flushed what it sent: wait for it
                rank, ok, value = results.get(timeout=2.0 if dead else 0.5)
            except queue.Empty:
                if dead:
                    raise RankError(
                        f"rank {dead[0]} died (exit code "
                        f"{procs[dead[0]].exitcode}) without a result")
                if time.monotonic() > deadline:
                    raise RankError(f"the mesh ran past {timeout} s")
                continue
            if not ok:
                raise RankError(f"rank {rank} raised:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join()
        results.close()
    return [out[r] for r in range(world)]

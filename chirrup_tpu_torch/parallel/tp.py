"""Tensor-parallel serving over torch.distributed: one process a rank.

The JAX package runs one controller over its tp chips (a GSPMD mesh, the
forward inside one shard_map, chirrup_tpu/parallel/mesh.py). A torch process
drives one NCCL rank, so here rank r is a process of its own that owns
device r:

- rank 0 runs the Worker, AsyncEngineCore and the server; each
  device-touching ServingModel call it makes is first sent to every other
  rank (`send_call`), as its name, its host inputs (numpy arrays, task
  parameters) and references to the carries and pools it names;
- ranks > 0 run `follow`: they receive each call and run it on their own
  shard, in the same order, so their collectives meet rank 0's;
- the calls travel on a gloo group of their own (`ctrl`) beside the data
  group (`group`: NCCL on CUDA, gloo on the CPU or where asked for);
- both groups are process-group objects of the group's own, built on a
  TCPStore that rank 0 serves (`start`), never the default process group:
  one process can be rank 0 of several groups (one a worker, on disjoint
  devices) and hold a lockstep hosts' vote group (parallel/hosts.py)
  besides; their collectives go through the group object
  (`pg.allreduce([t]).wait()`), as c10d's functions take only groups it
  registered;
- every rank samples from the same gathered logits with the same generator,
  so every rank's tokens agree and no token is sent (an NCCL all-reduce
  gives every rank the same bits).

The layout (mesh.param_shardings, carry_shardings, pool_shardings in the
JAX package) becomes slicing on each rank (`shard_params`):

  column-parallel (output axis split): att Wr, Wk, Wv, the second LoRA
      factors w2 a2 v2 g2, the per-head vectors w0 a0 v0 k_k k_a ln_x_w
      ln_x_b and r_k (its head axis), FFN Wk, the head (logits (B, V/tp));
      an Mm8Weight's per-column scales mx, rx go with the columns;
  row-parallel (input axis split): att Wo and FFN Wv, with their per-row
      scales my, ry; their outputs are partial sums, all-reduced (two
      all-reduces a layer);
  replicated: emb, the layer norms, the token-shift mixes x_*, the first
      LoRA factors, ln_out.

State per rank: shift (L, 2, B, C) replicated; wkv (L, B, N, H*N/tp) with
the rank's heads (the last axis holds heads h*N.. in order, so rank r's
block is columns r*C/tp..); elapsed replicated. A state pool's rows follow
the same layout, and one pool row index names the same row on every rank.
Each rank merges its own R/K/V and packs its own LoRA after slicing, so the
JAX package's column interleave for a merged weight under tp
(mm8.merge_stacked(tp)) has no counterpart.

Nothing here switches backend or device: NCCL on CUDA unless a backend is
given, and a failing collective raises.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import itertools
import multiprocessing
import os
import pickle
import sys
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from chirrup_tpu_torch.ops.mm8 import MM8_FIELDS, mm8_fields
# att leaves split on their output (last) axis; r_k (L, H, N) on its head axis
_ATT_COL = frozenset({"Wr", "Wk", "Wv", "w2", "a2", "v2", "g2", "w0", "a0", "v0",
                      "k_k", "k_a", "ln_x_w", "ln_x_b"})
# the control group waits for rank 0's next call as long as the server idles
CTRL_TIMEOUT = datetime.timedelta(days=365)
# the address rank 0's group store binds (the ranks of a group share a host)
STORE_HOST = "127.0.0.1"


# ------------------------------------------------------------------ layout

def _kind(path: Tuple[str, ...]) -> Optional[str]:
    """"col", "row", "heads" or None (replicated) for a leaf of the raw tree."""
    if path == ("head",):
        return "col"
    if len(path) == 3 and path[:2] == ("blocks", "att"):
        if path[2] == "r_k":
            return "heads"
        if path[2] in _ATT_COL:
            return "col"
        return "row" if path[2] == "Wo" else None
    if len(path) == 3 and path[:2] == ("blocks", "ffn"):
        return {"Wk": "col", "Wv": "row"}.get(path[2])
    return None


def shard_axis(path: Tuple[str, ...], field: Optional[str] = None) -> Optional[int]:
    """The axis (negative) along which the leaf at `path` of the raw tree is
    split over the ranks, or None where it is replicated. `field` names an
    Mm8Weight's part: q follows the weight; the per-column scales mx, rx
    split only under column parallelism, the per-row my, ry only under row
    parallelism."""
    kind = _kind(path)
    if kind is None:
        return None
    if kind == "heads":
        return -2
    if field in (None, "q"):
        return -1 if kind == "col" else -2
    if field in ("mx", "rx"):
        return -1 if kind == "col" else None
    return -1 if kind == "row" else None


def shard_leaf(path: Tuple[str, ...], leaf, rank: int, world: int, field: Optional[str] = None):
    """Rank `rank`'s block of one leaf (numpy array, memmap or tensor), as a
    view; the leaf itself where it is replicated."""
    axis = shard_axis(path, field)
    if axis is None or world == 1:
        return leaf
    n = leaf.shape[axis]
    if n % world:
        raise ValueError(f"tp: {'.'.join(path)}{'.' + field if field else ''} has "
                         f"{n} along axis {axis}, not a multiple of {world} ranks")
    step = n // world
    index = [slice(None)] * leaf.ndim
    index[axis] = slice(rank * step, (rank + 1) * step)
    return leaf[tuple(index)]


def _contiguous(x):
    return x.contiguous() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x)


def shard_params(tree, rank: int, world: int, path: Tuple[str, ...] = ()):
    """Rank `rank`'s shard of a raw parameter tree (the tree params_from_numpy
    takes, of numpy arrays or tensors; an INT8 weight as an Mm8Weight of
    either package or a dict of its parts), each split leaf copied to a
    contiguous array; replicated leaves are the tree's own. The rules are
    the JAX package's param_shardings (module docstring); reassembling the
    ranks' shards along shard_axis gives the tree back. `path`: where `tree`
    lies in the whole tree (a subtree or one leaf)."""
    fields = mm8_fields(tree)
    if fields is not None:
        out = {f: _shard_one(path, fields[f], rank, world, f) for f in MM8_FIELDS}
        if isinstance(tree, dict):
            return out
        cls = type(tree)
        return cls(**out) if dataclasses.is_dataclass(cls) else out
    if isinstance(tree, dict):
        return {k: shard_params(v, rank, world, path + (k,)) for k, v in tree.items()}
    return _shard_one(path, tree, rank, world, None)


def _shard_one(path, leaf, rank, world, field):
    out = shard_leaf(path, leaf, rank, world, field)
    return out if out is leaf else _contiguous(out)


def is_full(params, n_embd: int) -> bool:
    """Whether a parameter tree is whole (not yet a rank's shard): its
    per-head GroupNorm weight spans all n_embd channels."""
    return params["blocks"]["att"]["ln_x_w"].shape[-1] == n_embd


# ---------------------------------------------------------------- context

class _Ref:
    """A carry or pool named in a call: rank 0's object, each follower's own."""

    __slots__ = ("oid",)

    def __init__(self, oid: int):
        self.oid = oid


def _words(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bits as 32-bit integers (a sum with zeros over
    them is exact, and gloo reduces int32 on every device)."""
    if t.element_size() * t.shape[-1] % 4:
        raise ValueError(f"tp: cannot gather {tuple(t.shape)} {t.dtype} as 32-bit words")
    return t.view(torch.int32)


@dataclasses.dataclass(eq=False)
class TPContext:
    """One rank's view of a tensor-parallel group: its rank and the world,
    its device, the data group (NCCL or gloo) and the gloo control group
    that carries rank 0's calls; on rank 0 the follower processes it
    started, whose exit it checks before every call."""

    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any
    ctrl: Any
    processes: Sequence[Any] = ()
    # the group's store (rank 0 serves it; kept for the group's life)
    store: Any = dataclasses.field(default=None, repr=False)
    _oids: Dict[int, int] = dataclasses.field(default_factory=dict, repr=False)
    _keep: List[Any] = dataclasses.field(default_factory=list, repr=False)
    # ids of collected carries, sent with the next call (finalizers append
    # from any thread)
    _released: Any = dataclasses.field(default_factory=collections.deque, repr=False)
    _counter: Any = dataclasses.field(default_factory=itertools.count, repr=False)
    closed: bool = False

    # ------------------------------------------------------- collectives

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks, in place (the reduce_fn of the forward)."""
        self.group.allreduce([t]).wait()
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world, *t.shape): every rank's t, by rank. NCCL gathers; gloo,
        which offers only all_reduce and broadcast on CUDA tensors, sums
        each rank's t placed in a zeroed buffer, over its 32-bit words."""
        t = t.contiguous()
        if self.backend == "nccl":
            out = torch.empty((self.world,) + tuple(t.shape), dtype=t.dtype, device=t.device)
            self.group._allgather_base(out, t).wait()
            return out
        out = torch.zeros((self.world,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        out[self.rank].copy_(t)
        self.group.allreduce([_words(out)]).wait()
        return out

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """The column-parallel head's (B, V/tp) logits -> (B, V) on every rank."""
        g = self.all_gather(logits)
        return g.permute(1, 0, 2).reshape(logits.shape[0], -1)

    def gather_heads(self, t: torch.Tensor) -> torch.Tensor:
        """A wkv block (..., H*N/tp) of this rank's heads -> (..., H*N)."""
        g = self.all_gather(t)
        return g.movedim(0, -2).reshape(*t.shape[:-1], -1)

    def local_heads(self, t):
        """This rank's heads of a whole wkv row (..., H*N)."""
        step = t.shape[-1] // self.world
        return t[..., self.rank * step:(self.rank + 1) * step]

    def gather_object(self, obj) -> Optional[List[Any]]:
        """Every rank's obj, by rank, on rank 0 (None elsewhere)."""
        out = gather_objects(self.ctrl, self.rank, self.world, obj)
        return out if self.rank == 0 else None

    # ----------------------------------------------------------- calls

    def check_followers(self) -> None:
        """Raise if a follower process has exited."""
        for r, p in enumerate(self.processes, start=1):
            if not p.is_alive():
                raise RuntimeError(f"tp: rank {r} (pid {p.pid}) exited with code "
                                   f"{p.exitcode}; the group cannot serve")

    def ref(self, obj) -> _Ref:
        oid = self._oids.get(id(obj))
        if oid is None:
            raise ValueError(f"tp: a {type(obj).__name__} that no mirrored call made")
        return _Ref(oid)

    def knows(self, obj) -> bool:
        return id(obj) in self._oids

    def register(self, obj, oid: int) -> None:
        """Name rank 0's `obj` (a carry or pool a call made) by `oid`; the
        followers drop theirs once it is collected."""
        key = id(obj)
        self._oids[key] = oid
        try:
            weakref.finalize(obj, self._release, key, oid)
        except TypeError:   # a dict: kept for the group's life
            self._keep.append(obj)

    def _release(self, key: int, oid: int) -> None:
        if self._oids.get(key) == oid:
            del self._oids[key]
        self._released.append(oid)

    def send_call(self, name: str, args, kwargs, returns: bool = False) -> Optional[int]:
        """Rank 0: send one call to every follower (after checking that each
        is alive); returns the id its result will be known by when
        `returns`."""
        self.check_followers()
        oid = next(self._counter) if returns else None
        released = [self._released.popleft() for _ in range(len(self._released))]
        broadcast_object(self.ctrl, 0, (name, args, kwargs, oid, released))
        return oid

    def recv_call(self):
        return broadcast_object(self.ctrl, self.rank)

    def close(self) -> None:
        """Rank 0: tell the followers to stop; every rank: leave the group."""
        if self.closed:
            return
        self.closed = True
        try:
            if all(p.is_alive() for p in self.processes):
                if self.device.type == "cuda":
                    # every collective this rank queued completes before the abort
                    torch.cuda.synchronize(self.device)
                if self.rank == 0 and self.world > 1:
                    broadcast_object(self.ctrl, 0, None)
        finally:
            shutdown_group(self.group, self.backend)
            shutdown_group(self.ctrl, "gloo")


# ------------------------------------------------------------------ groups

def new_group(store, rank: int, world: int, backend: str, timeout: float):
    """A process-group object of `world` ranks on `store` (a PrefixStore of
    its own), NCCL or gloo, that c10d does not register: collectives go
    through its methods. NCCL creates its communicator at the first
    collective, on the device of that collective's tensor."""
    delta = datetime.timedelta(seconds=timeout)
    if backend == "gloo":
        return dist.ProcessGroupGloo(store, rank, world, delta)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = delta
        return dist.ProcessGroupNCCL(store, rank, world, opts)
    raise ValueError(f"process group backend {backend!r}: one of nccl, gloo")


def shutdown_group(pg, backend: str) -> None:
    """Release a group's connections (a group whose peer died may refuse).
    NCCL's communicators are aborted: its graceful shutdown at world 2 (two
    groups of one process, or a lockstep host's group, on H100s) did not
    return."""
    stop = getattr(pg, "abort" if backend == "nccl" else "shutdown", None)
    if stop is not None:
        with contextlib.suppress(RuntimeError):
            stop()


def broadcast_object(pg, rank: int, obj=None):
    """Rank 0's picklable `obj` on every rank of a gloo group (length, then
    bytes, both on the host)."""
    if rank == 0:
        data = pickle.dumps(obj)
        n = torch.tensor([len(data)], dtype=torch.int64)
    else:
        n = torch.zeros(1, dtype=torch.int64)
    pg.broadcast([n]).wait()
    buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8) if rank == 0
           else torch.empty(int(n), dtype=torch.uint8))
    pg.broadcast([buf]).wait()
    return obj if rank == 0 else pickle.loads(buf.numpy().tobytes())


def gather_objects(pg, rank: int, world: int, obj) -> List[Any]:
    """Every rank's picklable `obj`, by rank, on every rank of a gloo group
    (each rank's bytes in its own row of a zeroed buffer, summed)."""
    data = pickle.dumps(obj)
    sizes = torch.zeros(world, dtype=torch.int64)
    sizes[rank] = len(data)
    pg.allreduce([sizes]).wait()
    buf = torch.zeros((world, int(sizes.max())), dtype=torch.uint8)
    buf[rank, :len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    pg.allreduce([buf]).wait()
    return [pickle.loads(buf[r, :int(sizes[r])].numpy().tobytes()) for r in range(world)]


def serve_store(timeout: float) -> dist.TCPStore:
    """Rank 0's store for one group, on a free local port (`.port`)."""
    return dist.TCPStore(STORE_HOST, 0, is_master=True, wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=timeout))


def connect_store(port: int, timeout: float) -> dist.TCPStore:
    return dist.TCPStore(STORE_HOST, port, is_master=False,
                         timeout=datetime.timedelta(seconds=timeout))


def init_context(rank: int, world: int, device, backend: str, store,
                 timeout: float = 300.0, processes: Sequence[Any] = ()) -> TPContext:
    """Join the group on `store` as `rank` (blocks until every rank has
    joined): the data group on `backend` and a gloo control group, each on
    a prefix of the store. A CUDA rank selects its device first, in the
    calling thread (the thread that makes every call of this rank); one
    eager all-reduce warms the communicator (NCCL must have it before a
    CUDA graph captures a collective)."""
    device = torch.device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"tp backend {backend!r}: one of nccl, gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"tp: nccl needs CUDA devices, not {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    group = new_group(dist.PrefixStore("data", store), rank, world, backend, timeout)
    ctrl = None
    try:
        ctrl = new_group(dist.PrefixStore("ctrl", store), rank, world, "gloo",
                         CTRL_TIMEOUT.total_seconds())
        ctx = TPContext(rank=rank, world=world, device=device, backend=backend,
                        group=group, ctrl=ctrl, processes=list(processes), store=store)
        ctx.all_reduce(torch.zeros(1, device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except BaseException:
        shutdown_group(group, backend)
        if ctrl is not None:
            shutdown_group(ctrl, "gloo")
        raise
    return ctx


# ---------------------------------------------------------------- followers

def follow(model, ctx: TPContext) -> None:
    """A follower's loop: run each call rank 0 sends on this rank's model, in
    order, until rank 0 closes the group. A failing call raises (and the
    process exits), which rank 0 sees at its next collective or call."""
    objects: Dict[int, Any] = {}

    def resolve(a):
        if isinstance(a, _Ref):
            return objects[a.oid]
        if isinstance(a, (list, tuple)):
            return type(a)(resolve(x) for x in a)
        return a

    while True:
        msg = ctx.recv_call()
        if msg is None:
            return
        name, args, kwargs, oid, released = msg
        for r in released:
            objects.pop(r, None)
        result = getattr(model, name)(*resolve(args), **{k: resolve(v) for k, v in kwargs.items()})
        if oid is not None:
            objects[oid] = result


def _follower_main(rank: int, world: int, device: str, backend: str, port: int,
                   timeout: float, build: Callable[[TPContext], Any]) -> None:
    ctx = None
    if torch.device(device).type == "cpu":
        # CPU ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    try:
        ctx = init_context(rank, world, device, backend, connect_store(port, timeout), timeout)
        follow(build(ctx), ctx)
    except BaseException:
        traceback.print_exc()
        if ctx is not None:
            ctx.close()
        raise
    # rank 0 closed the group: leave at once, and let the exit release the
    # groups. A follower that closed its NCCL group itself did not return
    # from the close at world 2 on H100s, and the interpreter's teardown
    # destroys the groups' objects (and their C++ threads) in an order of
    # its own
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def start(world: int, build: Callable[[TPContext], Any], devices: Sequence[Any],
          backend: Optional[str] = None, timeout: float = 300.0, name: str = ""
          ) -> Tuple[Callable[[], TPContext], List[Any]]:
    """Start ranks 1..world-1 as spawned processes, each joining the group,
    building its model with `build(ctx)` (a picklable callable; it must make
    the same ServingModel as rank 0's) and following rank 0's calls. Returns
    rank 0's `connect()` (join the group, in the thread that will make the
    calls) and the follower processes. devices[r] is rank r's device; the
    backend is NCCL on CUDA devices and gloo otherwise unless one is given.
    The group's store is served here, on a port of its own, so one process
    can start several groups. `name` tells the processes of several groups
    apart."""
    devices = [torch.device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"tp: {world} ranks need {world} devices, got {len(devices)}")
    if backend is None:
        backend = "nccl" if devices[0].type == "cuda" else "gloo"
    store = serve_store(timeout)
    spawn = multiprocessing.get_context("spawn")
    procs = [spawn.Process(target=_follower_main, name=f"chirrup_tpu_torch:{name}tp{r}",
                           daemon=True,
                           args=(r, world, str(devices[r]), backend, store.port, timeout, build))
             for r in range(1, world)]
    for p in procs:
        p.start()

    def connect() -> TPContext:
        return init_context(0, world, devices[0], backend, store, timeout, processes=procs)

    return connect, procs


def stop(processes: Sequence[Any], timeout: float = 30.0) -> List[Optional[int]]:
    """Join the follower processes within `timeout` seconds, killing any
    left; returns their exit codes."""
    deadline = time.monotonic() + timeout
    for p in processes:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in processes:
        if p.is_alive():
            p.kill()
            p.join(5.0)
    return [p.exitcode for p in processes]

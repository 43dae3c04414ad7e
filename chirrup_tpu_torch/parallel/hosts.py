"""Lockstep hosts over torch.distributed: the hosts' world and vote group.

The JAX package's lockstep serving runs one SPMD program over a global mesh
whose dp axis spans the hosts (jax.distributed); its shutdown vote is a
reduction inside the decode block, and complex admissions take
vote-coordinated rounds of fixed-shape programs. In the port no program
spans hosts: host i's model is a whole replica (or its own tensor-parallel
group's shards) over its own rows `slot_range` of the global batch, so its
rows never meet another host's in any kernel. What the hosts share is one
gloo group, the vote group, on which each host's lockstep worker
all-reduces its decode block's vote sums once a loop (engine/worker.py).

The hosts' world comes from torch.distributed's environment: MASTER_ADDR,
MASTER_PORT, WORLD_SIZE and RANK, as `torchrun --nnodes N
--nproc-per-node 1` sets them for each host's process. Without them a
lockstep engine is one host (dp 1) and votes alone.
"""

from __future__ import annotations

import datetime
import itertools
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from chirrup_tpu_torch.parallel import tp as tp_mod

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
# seconds a host waits at the vote for the slowest host's loop (a first
# CUDA graph capture included) before it raises
VOTE_TIMEOUT = 300.0

_store = None                  # the hosts' store, one a process
_groups = itertools.count()    # vote groups made in this process, in order


def host_world() -> Optional[Tuple[int, int]]:
    """(this host's rank, the number of hosts) from the environment, or None
    where none of its variables is set."""
    present = [k for k in ENV if k in os.environ]
    if not present:
        return None
    if len(present) < len(ENV):
        raise ValueError(f"lockstep hosts: {', '.join(k for k in ENV if k not in present)} "
                         f"missing from the environment (set all of {', '.join(ENV)})")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if not 0 <= rank < world:
        raise ValueError(f"lockstep hosts: RANK {rank} outside WORLD_SIZE {world}")
    return rank, world


def sampler_seed(seed: int, host: int) -> int:
    """Host `host`'s sampler seed: the seed itself on host 0 (a single host
    samples as without lockstep), distinct on every other host."""
    if host == 0:
        return seed
    return int(np.random.SeedSequence([seed, host]).generate_state(1, np.uint64)[0] >> 2)


class VoteGroup:
    """The hosts' gloo group: one all-reduce of a few int64 counts a loop.
    A peer that died makes it raise at once (its connection closes), a
    peer that hangs within `timeout` seconds."""

    def __init__(self, rank: int, world: int, timeout: float = VOTE_TIMEOUT):
        global _store
        if _store is None:
            _store, _, _ = next(dist.rendezvous(
                "env://", timeout=datetime.timedelta(seconds=timeout)))
        self.rank, self.world = rank, world
        name = f"chirrup_tpu_torch/vote{next(_groups)}"
        self.pg = tp_mod.new_group(dist.PrefixStore(name, _store), rank, world, "gloo", timeout)

    def all_reduce(self, counts) -> np.ndarray:
        t = torch.from_numpy(np.array(counts, np.int64))
        self.pg.allreduce([t]).wait()
        return t.numpy()

    def close(self) -> None:
        tp_mod.shutdown_group(self.pg, "gloo")


def vote_group(timeout: float = VOTE_TIMEOUT) -> Optional[VoteGroup]:
    """Join the hosts' vote group (blocks until every host has joined), or
    None without the environment's hosts. Every host makes its groups in the
    same order (each has a name of its own on the hosts' one store)."""
    world = host_world()
    if world is None:
        return None
    return VoteGroup(*world, timeout=timeout)

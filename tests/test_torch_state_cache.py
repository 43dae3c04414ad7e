"""chirrup_tpu_torch's prefix state cache (engine/state_cache.py) and the
state pool's allocator and handles (engine/structures.py): the counterparts
of tests/test_state_cache.py and the allocator cases of
tests/test_state_pool.py, run on both packages where both have the function,
and one regression test for each defect of the JAX package's allocator and
cache that the port leaves out:

- a handle released to zero refs, or revoked, stays in the evictable
  registry (chirrup_tpu/engine/structures.py:127);
- a revocation whose freed row another allocation takes first makes
  evict_lru_and_alloc revoke the next row too (structures.py:139-160);
- a trie node whose has_state flag has no LRU entry behind it makes check()
  walk to it again and again (chirrup_tpu/engine/state_cache.py:91).
"""

import asyncio
import sys
import threading

import numpy as np
import pytest
import torch

from chirrup_tpu.engine import state_cache as j_state_cache
from chirrup_tpu.engine import structures as j_structures
from chirrup_tpu_torch.engine import state_cache as t_state_cache
from chirrup_tpu_torch.engine import structures as t_structures
from chirrup_tpu_torch.engine.state_cache import PrefixStateCache
from chirrup_tpu_torch.engine.structures import PoolHandle, RequestState, StatePoolAllocator

# the same cases run on both packages' cache; the pool cases on both
# packages' allocator and handle
PACKAGES = {"jax": (j_state_cache, j_structures), "port": (t_state_cache, t_structures)}


def _state(tag: int, structures=t_structures):
    if structures is t_structures:
        return RequestState(shift=torch.full((1, 2, 4), float(tag)),
                            wkv=torch.full((1, 4, 8), float(tag)), elapsed=tag)
    return structures.RequestState(shift=np.full((1, 2, 4), tag, np.float32),
                                   wkv=np.full((1, 4, 8), tag, np.float32), elapsed=tag)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """(PrefixStateCache, a state maker, structures module) of one package."""
    cache_mod, structures = PACKAGES[request.param]
    return cache_mod.PrefixStateCache, (lambda tag: _state(tag, structures)), structures


def test_check_walk_semantics(pkg):
    """The reference's doctest scenario (state_cache.py:218-235)."""
    Cache, state, _ = pkg
    c = Cache(max_size=3)
    c.cache([1, 2, 3, 4], state(1))
    c.cache([1, 2, 3, 4, 5, 6, 7], state(2))
    c.cache([1, 2, 3, 6, 5, 6, 7, 8], state(3))

    rem, st, n = c.check([1, 2, 3, 4])
    assert (rem, st, n) == ([1, 2, 3, 4], None, 0)  # a full match is never returned
    rem, st, n = c.check([1, 2, 3, 4, 5])
    assert rem == [5] and st.elapsed == 1 and n == 4
    rem, st, n = c.check([1, 2, 3, 4, 5, 6, 7])
    assert rem == [5, 6, 7] and st.elapsed == 1
    rem, st, n = c.check([1, 2, 3, 4, 5, 6, 7, 8])
    assert rem == [8] and st.elapsed == 2
    rem, st, n = c.check([1, 2, 3, 6, 5])
    assert rem == [1, 2, 3, 6, 5] and st is None
    rem, st, n = c.check([1, 2, 3, 6, 5, 6, 7, 8, 9])
    assert rem == [9] and st.elapsed == 3


def test_lru_eviction_prunes_branch(pkg):
    Cache, state, _ = pkg
    c = Cache(max_size=2)
    c.cache([1, 2, 3], state(1))
    c.cache([9, 8], state(2))
    c.cache([5, 5, 5], state(3))  # evicts [1, 2, 3]
    assert c.check([1, 2, 3, 4])[1] is None
    assert 1 not in c.root.children  # branch pruned
    assert c.check([9, 8, 7])[1].elapsed == 2
    assert len(c) == 2


def test_eviction_keeps_shared_prefix(pkg):
    Cache, state, _ = pkg
    c = Cache(max_size=2)
    c.cache([1, 2], state(1))
    c.cache([1, 2, 3, 4], state(2))
    c.cache([7], state(3))  # evicts [1, 2], which [1, 2, 3, 4] passes through
    assert c.check([1, 2, 9])[1] is None
    assert c.check([1, 2, 3, 4, 5])[1].elapsed == 2


def test_remove(pkg):
    Cache, state, _ = pkg
    c = Cache(max_size=5)
    c.cache([1, 2, 3], state(1))
    assert c.remove([1, 2, 3])
    assert not c.remove([1, 2, 3])
    assert c.check([1, 2, 3, 4])[1] is None
    assert not c.root.children


def test_total_bytes(pkg):
    """A snapshot's bytes: the port's float32 tensors count as the JAX
    package's float32 arrays do."""
    Cache, state, _ = pkg
    c = Cache(max_size=5)
    c.cache([1], state(1))
    assert c.total_bytes() == state(1).nbytes() == (8 + 32) * 4 + 8
    assert c.stats()["entries"] == 1 and c.stats()["bytes"] == c.total_bytes()


def test_prefill_dedup(pkg):
    """The leader claims; a follower waits; the cache event wakes it with the
    leader's state (reference state_cache.py:85-136)."""
    Cache, state, _ = pkg

    async def go():
        c = Cache(max_size=5)
        tokens = [1, 2, 3, 4, 5, 6]
        pad = 2
        rem, st, n = await c.check_and_wait_prefill(tokens, pad)
        assert st is None and rem == tokens  # leader
        results = {}

        async def follower():
            results["follower"] = await c.check_and_wait_prefill(list(tokens), pad)

        ftask = asyncio.create_task(follower())
        await asyncio.sleep(0.05)
        assert not ftask.done()
        node = c.cache(tokens[:-pad], state(9), return_trie_node=True)
        await c.awake_hang_up_prefills(node)
        await asyncio.wait_for(ftask, timeout=5)
        rem2, st2, n2 = results["follower"]
        assert rem2 == tokens[-pad:] and st2.elapsed == 9 and n2 == len(tokens) - pad
        rem3, st3, _ = await c.check_and_wait_prefill(list(tokens), pad)
        assert rem3 == tokens[-pad:] and st3.elapsed == 9

    asyncio.run(asyncio.wait_for(go(), timeout=20))


def test_prefill_dedup_padding_zero(pkg):
    """Padding 0 snapshots at tokens[:-1] (the last token is the first decode
    input): the claim and the followers' lookup use that boundary, and the
    follower's resume counts as a hit."""
    Cache, state, _ = pkg

    async def go():
        c = Cache(max_size=5)
        tokens = [1, 2, 3, 4, 5, 6]
        rem, st, n = await c.check_and_wait_prefill(tokens, 0)
        assert st is None and rem == tokens
        results = {}

        async def follower():
            results["f"] = await c.check_and_wait_prefill(list(tokens), 0)

        ftask = asyncio.create_task(follower())
        await asyncio.sleep(0.05)
        assert not ftask.done()
        node = c.cache(tokens[:-1], state(7), return_trie_node=True)
        assert await c.awake_hang_up_prefills(node)
        await asyncio.wait_for(ftask, timeout=5)
        rem2, st2, n2 = results["f"]
        assert rem2 == tokens[-1:] and st2.elapsed == 7 and n2 == 5
        assert c.hits == 1 and c.misses == 1
        rem3, st3, _ = await c.check_and_wait_prefill(list(tokens), 0)
        assert rem3 == tokens[-1:] and st3.elapsed == 7

    asyncio.run(asyncio.wait_for(go(), timeout=20))


def test_prefill_full_hit_short_circuits(pkg):
    Cache, state, _ = pkg

    async def go():
        c = Cache(max_size=5)
        tokens = [4, 5, 6, 7]
        c.cache(tokens[:-1], state(1))
        rem, st, n = await c.check_and_wait_prefill(tokens, 1)
        assert rem == [7] and st.elapsed == 1 and n == 3

    asyncio.run(asyncio.wait_for(go(), timeout=10))


def test_abandoned_leader_releases_followers(pkg):
    """A leader that ends without caching releases its claim: the follower
    prefills itself and claims nothing; a stale claim cannot clear a newer
    leader's."""
    Cache, _, _ = pkg

    async def go():
        c = Cache(max_size=4)
        tokens = [5, 6, 7, 8]
        rem, st, n, claim = await c.check_and_wait_prefill(list(tokens), 0,
                                                           return_claim=True)
        assert claim is not None and st is None

        async def follower():
            return await asyncio.wait_for(
                c.check_and_wait_prefill(list(tokens), 0, return_claim=True), timeout=30)

        task = asyncio.create_task(follower())
        await asyncio.sleep(0.05)
        assert not task.done()
        assert await c.release_claim(claim) is True
        rem2, st2, n2, claim2 = await task
        assert st2 is None and list(rem2) == tokens and claim2 is None
        assert await c.release_claim(claim) is False
        _, _, _, claim3 = await c.check_and_wait_prefill(list(tokens), 0, return_claim=True)
        assert claim3 is not None
        assert await c.release_claim(claim) is False
        assert claim3[0].prefill_condition is claim3[1]
        assert await c.release_claim(claim3) is True

    asyncio.run(asyncio.wait_for(go(), timeout=60))


def test_check_falls_back_to_shallower_prefix_after_revocation(pkg):
    """A revoked pool entry turns into a miss at lookup, and check() walks
    again to the next shallower cached prefix."""
    Cache, _, structures = pkg
    alloc = structures.StatePoolAllocator(2)
    cache = Cache(max_size=10)
    h1 = structures.PoolHandle(row=alloc.alloc(), worker_id="w", allocator=alloc,
                               device_bytes=10)
    cache.cache((1, 2), h1)
    h2 = structures.PoolHandle(row=alloc.alloc(), worker_id="w", allocator=alloc,
                               device_bytes=10)
    cache.cache((1, 2, 3, 4), h2)
    assert h2.try_revoke()
    remaining, st, n = cache.check([1, 2, 3, 4, 5])
    assert st is h1 and n == 2 and remaining == [3, 4, 5]
    assert cache.check([1, 2, 3, 4, 5])[2] == 2


def test_check_returns_node_at_cached_depth(pkg):
    Cache, state, _ = pkg
    cache = Cache(max_size=10)
    cache.cache((1, 2, 3, 4), state(1))
    _, st, n, node = cache.check([1, 2, 9, 9], return_trie_node=True)
    assert st is None and n == 0 and node is cache.root
    _, st, n, node = cache.check([1, 2, 3, 4, 5], return_trie_node=True)
    assert n == 4 and st is not None and node is cache._find((1, 2, 3, 4))


# ------------------------------------------------ the pool's allocator and handles

def test_pool_handle_refcount_and_cache_eviction(pkg):
    """Counterpart of tests/test_state_pool.py:53: the cache's eviction frees
    a row; an in-flight resume's reference keeps it until released."""
    Cache, _, structures = pkg
    alloc = structures.StatePoolAllocator(2)
    cache = Cache(max_size=1)
    handle = lambda: structures.PoolHandle(row=alloc.alloc(), worker_id="w0",
                                           allocator=alloc, device_bytes=100)
    h1 = handle()
    cache.cache((1, 2), h1)
    assert alloc.available() == 1
    cache.cache((3, 4), handle())  # evicts h1: row recycled
    assert alloc.available() == 1 and h1.refs == 0
    h2 = cache.check([3, 4, 5])[1]
    assert h2.try_acquire()         # an in-flight resume
    cache.cache((5, 6), handle())   # evicts h2: the cache's reference goes...
    assert h2.refs == 1 and alloc.available() == 0  # ...the resume's stays
    h2.release()
    assert alloc.available() == 1
    assert cache.total_bytes() == 100


def test_evict_on_exhaustion_revokes_lru_cache_row(pkg):
    """Counterpart of tests/test_state_pool.py:80: the allocator revokes the
    cache's least recently used row (recency follows the cache's hits), the
    entry turns into a miss, a revoked handle's release frees nothing, and a
    row pinned by a resume is never revoked."""
    Cache, _, structures = pkg
    alloc = structures.StatePoolAllocator(2)
    cache = Cache(max_size=10)
    h1 = structures.PoolHandle(row=alloc.alloc(), worker_id="w0", allocator=alloc,
                               device_bytes=100)
    cache.cache((1, 2), h1)
    h2 = structures.PoolHandle(row=alloc.alloc(), worker_id="w0", allocator=alloc,
                               device_bytes=100)
    cache.cache((3, 4), h2)
    assert alloc.available() == 0 and alloc.alloc() is None
    assert cache.check([1, 2, 9])[1] is h1  # h1 most recent: h2 is the victim
    row = alloc.evict_lru_and_alloc()
    assert row == h2.row and h2.revoked and not h2.alive and not h2.try_acquire()
    _, st, n = cache.check([3, 4, 9])
    assert st is None and n == 0
    before = alloc.available()
    h2.release()
    assert alloc.available() == before
    alloc.free(row)
    assert h1.try_acquire()
    assert alloc.alloc() is not None
    assert alloc.evict_lru_and_alloc() is None  # h1 pinned
    h1.release()
    assert alloc.evict_lru_and_alloc() == h1.row


def test_released_handle_leaves_the_registry():
    """A handle released to zero refs, or revoked, leaves the evictable
    registry at once, so the registry holds only rows the cache still has
    (the JAX allocator keeps dead handles there until a pool exhaustion
    walks past them)."""
    alloc = StatePoolAllocator(3)
    cache = PrefixStateCache(max_size=1)
    h1 = PoolHandle(row=alloc.alloc(), worker_id="w", allocator=alloc)
    cache.cache((1,), h1)
    assert len(alloc._evictable) == 1
    h2 = PoolHandle(row=alloc.alloc(), worker_id="w", allocator=alloc)
    cache.cache((2,), h2)  # evicts (1,): h1 released to zero refs
    assert not h1.alive and len(alloc._evictable) == 1
    assert h2.try_revoke()
    assert len(alloc._evictable) == 0 and alloc.available() == 3
    h3 = PoolHandle(row=alloc.alloc(), worker_id="w", allocator=alloc)
    h3.release()          # never cached, released: registered nowhere
    h3.mark_evictable()   # a dead handle is not registered
    assert len(alloc._evictable) == 0 and alloc.available() == 3


class _RacingAllocator(StatePoolAllocator):
    """An allocator whose free list hands every row returned to it to a
    competing caller at once: the allocation that wins a race with the
    caller that freed the row."""

    def __init__(self, size):
        super().__init__(size)
        self.taken = []

    def free(self, row):
        super().free(row)
        self.taken.append(super().alloc())


def test_lost_race_revokes_at_most_one_row():
    """One evict_lru_and_alloc revokes one row, and that row goes to its
    caller: revocation and claim are one step under the allocator's lock,
    so no competing allocation can take the row between them (the JAX
    allocator frees the row, then allocates, and revokes the next row when
    it loses that race)."""
    alloc = _RacingAllocator(3)
    cache = PrefixStateCache(max_size=10)
    handles = [PoolHandle(row=alloc.alloc(), worker_id="w", allocator=alloc)
               for _ in range(3)]
    for i, h in enumerate(handles):
        cache.cache((i,), h)
    row = alloc.evict_lru_and_alloc()
    assert row == handles[0].row and not alloc.taken
    assert [h.revoked for h in handles] == [True, False, False]
    assert cache.check([1, 5])[1] is handles[1]


def test_concurrent_evictions_revoke_one_row_each():
    """Threads evicting for snapshots and threads allocating, with a short
    switch interval: every revoked row went to one evicting caller, and no
    plain allocation got a revoked row."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            n = 24
            alloc = StatePoolAllocator(n)
            handles = [PoolHandle(row=alloc.alloc(), worker_id="w", allocator=alloc)
                       for _ in range(n)]
            for h in handles:
                alloc.note_evictable(h)
            evicted, plain = [], []
            barrier = threading.Barrier(16)

            def evict():
                barrier.wait()
                for _ in range(2):
                    evicted.append(alloc.evict_lru_and_alloc())

            def grab():
                barrier.wait()
                for _ in range(4):
                    plain.append(alloc.alloc())

            threads = [threading.Thread(target=f) for f in [evict] * 8 + [grab] * 8]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert not any(t.is_alive() for t in threads)
            revoked = sorted(h.row for h in handles if h.revoked)
            assert sorted(r for r in evicted if r is not None) == revoked
            assert all(r is None for r in plain)
    finally:
        sys.setswitchinterval(interval)


def test_stale_has_state_flag_ends_as_a_miss():
    """A trie node flagged has_state with no LRU entry behind it (the trie
    and the LRU out of step): check() clears the flag and reports the next
    shallower entry or a miss, and returns (in the JAX cache the retry loop
    finds the same node on every pass and never returns)."""
    c = PrefixStateCache(max_size=5)
    c.cache([1, 2], _state(1))
    c.cache([1, 2, 3, 4], _state(2))
    del c._lru[(1, 2, 3, 4)]  # the trie still says (1, 2, 3, 4) has a state
    c.cache([7, 8, 9], _state(3))
    del c._lru[(7, 8, 9)]
    out = {}

    def walk():
        out["deep"] = c.check([1, 2, 3, 4, 5])
        out["other"] = c.check([7, 8, 9, 1])

    t = threading.Thread(target=walk, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "check() did not return"
    rem, st, n = out["deep"]
    assert st.elapsed == 1 and n == 2 and rem == [3, 4, 5]
    assert out["other"] == ([7, 8, 9, 1], None, 0)
    assert not c._find((1, 2, 3, 4)).has_state
    assert c.check([1, 2, 3, 4, 5])[2] == 2

"""Prefix state cache: a token trie and an LRU over request-state snapshots.

RWKV-7's recurrent state is O(1) in sequence length, so the state after a
prompt prefix lets any request that shares the prefix skip its prefill: the
RWKV counterpart of prefix KV-cache reuse. Semantics follow the reference
(chirrup's utils/state_cache.py):

- check(tokens) walks the trie and returns the deepest cached prefix strictly
  shorter than the query (generation needs at least one token to forward);
- check_and_wait_prefill() also deduplicates concurrent identical prefills:
  the first request claims the path (an asyncio.Condition), followers wait
  until the leader's snapshot lands, then resume from the cache;
- cache() refcounts trie nodes, so LRU eviction prunes exactly the branch
  that no remaining entry depends on.

A snapshot is a host RequestState or a PoolHandle to a row of a worker's
device state pool (structures.py); the cache releases a handle it drops and
treats a handle the worker revoked as a miss.
"""

from __future__ import annotations

import asyncio
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple, Union

from chirrup_tpu_torch.engine.structures import PoolHandle, RequestState

Snapshot = Union[RequestState, PoolHandle]


def _release(state: Snapshot) -> None:
    """Drop the cache's reference to an evicted or replaced snapshot: a
    PoolHandle's row is recycled once no in-flight resume still reads it; a
    host RequestState needs nothing."""
    if isinstance(state, PoolHandle):
        state.release()


class _TrieNode:
    __slots__ = ("children", "has_state", "refcount", "prefill_condition")

    def __init__(self):
        self.children: Dict[int, _TrieNode] = {}
        self.has_state = False
        self.refcount = 0
        self.prefill_condition: Optional[asyncio.Condition] = None


class PrefixStateCache:
    def __init__(self, max_size: int = 100):
        if max_size <= 0:
            raise ValueError("max_size must be positive")
        self.max_size = max_size
        self.root = _TrieNode()
        self._lru: "OrderedDict[Tuple[int, ...], Snapshot]" = OrderedDict()
        self.prefill_lock = asyncio.Lock()
        # lookup accounting: hits = lookups that found a usable cached prefix;
        # tokens_saved = prompt tokens those lookups did not have to prefill
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0

    # ------------------------------------------------------------------ stats

    def __len__(self) -> int:
        return len(self._lru)

    def total_bytes(self) -> int:
        return sum(s.nbytes() for s in self._lru.values())

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._lru), "bytes": self.total_bytes(),
                "hits": self.hits, "misses": self.misses,
                "tokens_saved": self.tokens_saved}

    # ------------------------------------------------------------------ check

    def check(self, tokens: List[int], return_trie_node: bool = False):
        """Longest cached proper prefix of `tokens`.

        Returns (remaining_tokens, state_or_None, cached_len[, node]), node
        being the trie node at depth cached_len (the root on a miss).

        The walk is retried when the deepest entry turns out dead: a pool
        row the worker revoked, or a node whose has_state flag has no LRU
        entry behind it. _lru_get clears either (the entry and its path, or
        the flag), so the re-walk finds the next shallower cached prefix
        instead of reporting a miss, and every pass removes one dead mark:
        the loop ends."""
        while True:
            node = self.root
            best = 0
            best_node = self.root
            i = 0
            while i < len(tokens):
                if node.has_state:
                    best = i
                    best_node = node
                child = node.children.get(tokens[i])
                if child is None or (child.refcount == 0
                                     and not child.prefill_condition):
                    break
                node = child
                i += 1

            state = self._lru_get(tuple(tokens[:best])) if best else None
            if best == 0 or state is not None:
                break

        if state is None:
            best = 0
            best_node = self.root
            remaining = tokens
            self.misses += 1
        else:
            remaining = tokens[best:]
            self.hits += 1
            self.tokens_saved += best
        # the node AT depth `best`: check_and_wait_prefill grafts the claim
        # path tokens[best:eff] under it, and a deeper walk-stop node would
        # graft a detached path whose cache event never finds the followers
        if return_trie_node:
            return remaining, state, best, best_node
        return remaining, state, best

    async def check_and_wait_prefill(self, tokens: List[int],
                                     cache_prefill_padding: int,
                                     return_claim: bool = False,
                                     can_lead: bool = True):
        """check() plus the deduplication of concurrent identical prefills.

        return_claim=True also returns the (node, condition) this caller
        claimed as prefill leader (None otherwise). The caller must release
        it with release_claim() when its request ends: the snapshot's cache
        event normally does (awake_hang_up_prefills), but a leader that is
        aborted never caches, and an unreleased claim leaves every later
        identical prompt waiting. release_claim compares the Condition, so
        a slow leader cannot clear a newer leader's claim on the same node.
        can_lead=False (a request that will not snapshot) never claims."""
        def ret(res, claim=None):
            return (*res, claim) if return_claim else res

        async with self.prefill_lock:
            remaining, state, cached_len, node = self.check(tokens,
                                                            return_trie_node=True)
            # the leader's snapshot ends max(padding, 1) tokens before the
            # prompt's end (padding 0 keeps the last token as the first
            # decode input), so the claim and the followers' lookup use it
            eff = len(tokens) - max(cache_prefill_padding, 1)
            if cached_len >= eff:
                return ret((remaining, state, cached_len))  # nothing to lead

            for token in tokens[cached_len:eff]:
                child = node.children.get(token)
                if child is None:
                    child = _TrieNode()
                    node.children[token] = child
                node = child
            if node.prefill_condition is None:
                if not can_lead:
                    return ret((remaining, state, cached_len))
                node.prefill_condition = asyncio.Condition()
                return ret((remaining, state, cached_len),
                           claim=(node, node.prefill_condition))  # leader

        # follower: wait for the leader's snapshot
        async with node.prefill_condition:
            await node.prefill_condition.wait()
        eff = len(tokens) - max(cache_prefill_padding, 1)
        cached = self._lru_get(tuple(tokens[:eff])) if eff > 0 else None
        if cached is not None:
            # check() counted this lookup as a miss before the wait
            self.misses -= 1
            self.hits += 1
            self.tokens_saved += eff
            return ret((tokens[eff:], cached, eff))
        return ret((remaining, state, cached_len))  # leader failed; we prefill

    async def release_claim(self, claim) -> bool:
        """Release a leader claim from check_and_wait_prefill(return_claim=True)
        if it is still installed. claim: (node, condition). No-op when the
        node has no condition (the cache event released it) or another one
        (a newer leader's)."""
        if claim is None:
            return False
        node, condition = claim
        if node.prefill_condition is not condition:
            return False
        return await self.awake_hang_up_prefills(node)

    async def awake_hang_up_prefills(self, node: Optional[_TrieNode]) -> bool:
        """Wake the followers waiting on a just-cached prefix."""
        if node is None or node.prefill_condition is None:
            return False
        async with node.prefill_condition:
            node.prefill_condition.notify_all()
        node.prefill_condition = None
        return True

    # ------------------------------------------------------------------ cache

    def cache(self, tokens, state: Snapshot, return_trie_node: bool = False):
        """Insert a snapshot; evict the LRU entry (pruning its now
        unreferenced branch) past max_size."""
        tokens = tuple(tokens)
        if not tokens:
            return None

        if tokens in self._lru:
            old = self._lru[tokens]
            if old is not state:
                _release(old)
            self._lru.move_to_end(tokens)
            self._lru[tokens] = state
            node = self._find(tokens)
        else:
            node = self.root
            self.root.refcount += 1
            for token in tokens:
                child = node.children.get(token)
                if child is None:
                    child = _TrieNode()
                    node.children[token] = child
                child.refcount += 1
                node = child
            node.has_state = True
            self._lru[tokens] = state
            if len(self._lru) > self.max_size:
                old_key, old_state = self._lru.popitem(last=False)
                _release(old_state)
                self._remove_path(old_key)
        if isinstance(state, PoolHandle):
            state.mark_evictable()  # revocable under snapshot pressure

        if return_trie_node:
            return node
        return None

    def remove(self, tokens) -> bool:
        tokens = tuple(tokens)
        if tokens not in self._lru:
            return False
        _release(self._lru.pop(tokens))
        self._remove_path(tokens)
        return True

    # ---------------------------------------------------------------- private

    def _lru_get(self, key: Tuple[int, ...]) -> Optional[Snapshot]:
        state = self._lru.get(key)
        if state is None:
            # a has_state flag with no entry behind it: clear it (and prune
            # the nodes it kept), or check() would find the same node again
            self._clear_stale_flag(key)
            return None
        if isinstance(state, PoolHandle) and state.revoked:
            # a pool row the worker revoked under snapshot pressure: the
            # entry turns into a miss here
            self._lru.pop(key)
            self._remove_path(key)
            return None
        self._lru.move_to_end(key)
        if isinstance(state, PoolHandle):
            state.touch_evictable()  # the allocator's eviction order == this LRU
        return state

    def _find(self, tokens) -> Optional[_TrieNode]:
        node = self.root
        for t in tokens:
            node = node.children.get(t)
            if node is None:
                return None
        return node

    def _clear_stale_flag(self, tokens: Tuple[int, ...]) -> None:
        path = []
        node = self.root
        for t in tokens:
            child = node.children.get(t)
            if child is None:
                return
            path.append((node, t, child))
            node = child
        node.has_state = False
        self._prune(path)

    def _remove_path(self, tokens: Tuple[int, ...]):
        self.root.refcount -= 1
        node = self.root
        path = []
        for t in tokens:
            child = node.children.get(t)
            if child is None:
                return
            path.append((node, t, child))
            child.refcount -= 1
            node = child
        node.has_state = False
        self._prune(path)

    @staticmethod
    def _prune(path) -> None:
        """From the leaf up, drop nodes that serve no entry and no claim."""
        for parent, token, child in reversed(path):
            if child.refcount <= 0 and not child.children and not child.has_state \
                    and not child.prefill_condition:
                del parent.children[token]
            else:
                break

"""The host side of the WKV decode-step kernel (ops/wkv7_cuda.py step_plan)
and of the penalty tail (ops/sampling_cuda.py tail_plan), on the CPU, and a
numpy model of how the tail splits a row's vocabulary over the CTAs of a
cluster and merges their partial results.

Both kernels (csrc/wkv7_step.cu, csrc/penalty_tail.cu) take raw pointers and
fix their launch in the source, so what they rely on is checked here: that the
step launch gives every state element of a head to exactly one thread, joins
each row's threads within a warp and writes each output row once; that the
tail's split covers every column once in whole 128-column chunks with no CTA
left empty; that the kernel's order of (max, sum-exp) merges gives the row's
logsumexp within 1e-4; and that ties resolve to the lower column in the
sampler's greedy path. The kernels' own results are checked on the card by
chip_smoke.py; the plain versions against the JAX package by
tests/test_torch_wkv7.py and tests/test_torch_sampling.py.
"""

import re

import numpy as np
import pytest
import torch

from chirrup_tpu_torch.ops import _kernels, sampling_cuda, wkv7_cuda

BATCHES = [1, 37, 64, 512]
WIDTHS = [768, 2048, 4096]
# the served vocabulary, one that leaves a partial last chunk (a multiple of
# 4: the vector path), one that is not a multiple of 4 (one load an element)
# and one under a chunk
VOCABS = [65536, 65536 - 64, 65536 - 64 - 3, 100]


def _step_slots(plan, t):
    """Thread t's head slot, first row and first column in its block."""
    group = t // plan.threads_per_row
    return (group % plan.heads_per_block,
            group // plan.heads_per_block * plan.rows_per_thread,
            64 // plan.threads_per_row * (t % plan.threads_per_row))


def _step_owners(plan):
    """How many threads hold each (head slot, row, column) of a block:
    thread t holds rows i0 .. i0 + RI - 1 and 64 / P consecutive columns of
    its head slot."""
    seen = np.zeros((plan.heads_per_block, 64, 64), np.int64)
    for t in range(plan.threads):
        hs, i0, c = _step_slots(plan, t)
        seen[hs, i0:i0 + plan.rows_per_thread, c:c + 64 // plan.threads_per_row] += 1
    return seen


def _step_writers(plan):
    """How many threads write each output row of a block's heads: lane t % P
    of a row group writes its rows q with q % P == t % P."""
    P = plan.threads_per_row
    seen = np.zeros((plan.heads_per_block, 64), np.int64)
    for t in range(plan.threads):
        hs, i0, _ = _step_slots(plan, t)
        for q in range(plan.rows_per_thread):
            if q % P == t % P:
                seen[hs, i0 + q] += 1
    return seen


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("C", WIDTHS)
def test_step_plan_serving_shapes(B, C):
    """At every serving batch and width: whole warps; every state element
    of each head slot held by exactly one thread, a row's threads
    neighbouring lanes of one warp (its shuffles) holding 8 consecutive
    columns each (one 16-byte bf16 load), and a warp's lane groups on the
    same rows of neighbouring heads (one load instruction reads a row of
    every head it holds, contiguous bytes); each output row written once;
    every head in exactly one block slot, one block row per request."""
    plan = wkv7_cuda.step_plan(B, C)
    P, HB = plan.threads_per_row, plan.heads_per_block
    assert plan.threads == HB * 64 // plan.rows_per_thread * P
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert 32 % P == 0 and 64 // P == 8 and (32 // P) % HB == 0
    assert (_step_owners(plan) == 1).all()
    assert (_step_writers(plan) == 1).all()
    for warp in range(plan.threads // 32):
        slots = [_step_slots(plan, t) for t in range(32 * warp, 32 * warp + 32)]
        assert len({i0 for _, i0, _ in slots}) == 1  # one set of rows a warp
        assert sorted({hs for hs, _, _ in slots}) == list(range(HB))
    H = C // 64
    assert plan.grid == (-(-H // HB), B, 1)
    assert plan.grid[0] * HB >= H > (plan.grid[0] - 1) * HB


def test_step_plan_choice():
    """The launch measured fastest on the H100 with cold state at batch 64:
    four heads a block, sixteen rows a thread and eight threads a row,
    whatever the batch and width."""
    for B, C in ((64, 4096), (1, 768), (512, 2048), (3, 320)):
        plan = wkv7_cuda.step_plan(B, C)
        assert (plan.heads_per_block, plan.rows_per_thread, plan.threads_per_row,
                plan.threads) == (4, 16, 8, 128)


def _constants(source, pattern):
    """The integers that `pattern`'s groups match in csrc/<source>.cu."""
    text = (_kernels.CSRC / f"{source}.cu").read_text()
    found = re.search(pattern, text)
    assert found, f"csrc/{source}.cu no longer holds {pattern!r}"
    return tuple(int(g) for g in found.groups())


def test_step_plan_matches_the_source():
    """step_plan describes the launch csrc/wkv7_step.cu fixes (its entry
    refuses any other on the card): heads a block, rows a thread, threads a
    row and threads a block."""
    HB, RI, P = _constants("wkv7_step", r"constexpr int HB = (\d+), RI = (\d+), P = (\d+),")
    for B, C in ((64, 4096), (1, 768)):
        plan = wkv7_cuda.step_plan(B, C)
        assert (plan.heads_per_block, plan.rows_per_thread, plan.threads_per_row) == (HB, RI, P)
        assert plan.threads == HB * 64 // RI * P


def test_tail_plan_matches_the_source():
    """tail_plan and tail_shape describe what csrc/penalty_tail.cu runs (its
    entry refuses anything else on the card): its threads a CTA, chunks in
    flight a warp and the largest cluster."""
    (PT,), (U,), (MAX_SPLIT,) = (_constants("penalty_tail", rf"constexpr int {name} = (\d+)")
                                 for name in ("PT", "U", "MAX_SPLIT"))
    assert sampling_cuda.MAX_SPLIT == MAX_SPLIT
    for plan in (sampling_cuda.tail_plan(64, 65536), sampling_cuda.tail_shape(512, 1000, 8)):
        assert (plan.threads, plan.chunks_in_flight) == (PT, U)


@pytest.mark.parametrize("case,args", [
    ("no requests", (0, 4096)),
    ("more requests than a grid dimension", (65536, 4096)),
    ("width not in heads", (64, 4000)),
    ("width under one head", (64, 0)),
])
def test_step_plan_refuses(case, args):
    with pytest.raises(ValueError):
        wkv7_cuda.step_plan(*args)


def _cta_chunks(plan, V):
    """The chunks each CTA of a row owns, in rank order."""
    n = -(-V // 128)
    per = plan.chunks_per_cta
    return [list(range(r * per, min((r + 1) * per, n))) for r in range(plan.split)]


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("V", VOCABS)
def test_tail_plan_covers_the_row(B, V):
    """Every column of a row in exactly one CTA, no 128-column chunk split
    between CTAs, no CTA without a chunk, at most 8 CTAs a row (the portable
    cluster), and a grid of whole clusters, one a row."""
    plan = sampling_cuda.tail_plan(B, V)
    assert 1 <= plan.split <= sampling_cuda.MAX_SPLIT
    assert plan.threads % 32 == 0 and plan.chunks_in_flight >= 1
    owners = _cta_chunks(plan, V)
    assert all(len(c) >= 1 for c in owners)
    cols = np.zeros(V, np.int64)
    for chunks in owners:
        for ch in chunks:
            cols[ch * 128:min(ch * 128 + 128, V)] += 1
    assert (cols == 1).all()
    chunk_owner = np.concatenate([[r] * len(c) for r, c in enumerate(owners)])
    assert len(chunk_owner) == -(-V // 128)  # each chunk once: never split
    assert plan.grid == (plan.split * B, 1, 1) and plan.cluster == (plan.split, 1, 1)


def test_tail_plan_choice():
    """The split chosen from the H100's timings at V 65536 (the fastest of
    1, 2, 4 and 8 CTAs a row at each batch timed): 8 at batch 1 and 8, 4 at
    32, 2 at 64 and 128, 1 at 256 and 512; powers of two between those
    batches; never more CTAs than the row has chunks."""
    splits = {1: 8, 8: 8, 32: 4, 64: 2, 128: 2, 256: 1, 512: 1, 16: 8, 37: 2, 129: 1}
    assert {B: sampling_cuda.tail_plan(B, 65536).split for B in splits} == splits
    assert sampling_cuda.tail_plan(64, 65536).chunks_per_cta == 256
    assert sampling_cuda.tail_plan(1, 100).split == 1
    assert sampling_cuda.tail_plan(1, 300).split == 3


@pytest.mark.parametrize("split", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("V", VOCABS)
def test_tail_shape_covers_the_row(split, V):
    """At any split the kernel takes, the launch covers every column of a
    row once in whole 128-column chunks, with no CTA empty and never more
    CTAs than asked for."""
    plan = sampling_cuda.tail_shape(37, V, split)
    owners = _cta_chunks(plan, V)
    assert 1 <= plan.split <= split and all(len(c) >= 1 for c in owners)
    assert [ch for c in owners for ch in c] == list(range(-(-V // 128)))
    assert plan.grid == (plan.split * 37, 1, 1) and plan.cluster == (plan.split, 1, 1)


@pytest.mark.parametrize("split", [0, -1, 9, 16])
def test_tail_shape_refuses(split):
    with pytest.raises(ValueError):
        sampling_cuda.tail_shape(64, 65536, split)


@pytest.mark.parametrize("case,args", [
    ("no rows", (0, 65536)), ("no columns", (64, 0)), ("columns past int32", (64, 2 ** 31)),
    ("rows past the grid", (2 ** 28, 65536)),
])
def test_tail_plan_refuses(case, args):
    with pytest.raises(ValueError):
        sampling_cuda.tail_plan(*args)


def _lse_merge(m, s, m2, s2):
    """The kernel's online merge of (max, sum-exp) pairs, in float32."""
    if m2 == -np.inf:
        return m, s
    nm = np.maximum(m, m2)
    return nm, np.float32(s * np.exp(np.float32(m - nm)) + s2 * np.exp(np.float32(m2 - nm)))


def _tail_model(adj, plan):
    """The kernel's pass over one row of adjusted logits (float32, (V,)),
    in its order: per chunk, each lane's maximum and first argmax over its 4
    columns (strict >), the warp's shuffles keeping the lower column on
    ties, and the chunk's sum-exp; the warp's online pair over its chunks,
    the CTA's merge over its warps, the cluster's over its ranks. Returns
    (cval, cidx, lse)."""
    V = adj.shape[0]
    n = -(-V // 128)
    pad = np.full(n * 128, -np.inf, np.float32)
    pad[:V] = adj
    cval = np.empty(n, np.float32)
    cidx = np.empty(n, np.int64)
    warps, U = plan.threads // 32, plan.chunks_in_flight
    pairs = []
    for chunks in _cta_chunks(plan, V):
        first, end = chunks[0], chunks[-1] + 1
        warp_pairs = []
        for w in range(warps):
            m, s = np.float32(-np.inf), np.float32(0)
            for c0 in range(first + w * U, end, warps * U):
                for ch in range(c0, min(c0 + U, end)):
                    lanes = pad[ch * 128:(ch + 1) * 128].reshape(32, 4)
                    best, best_i = lanes[:, 0].copy(), ch * 128 + 4 * np.arange(32)
                    for e in range(1, 4):
                        up = lanes[:, e] > best
                        best = np.where(up, lanes[:, e], best)
                        best_i = np.where(up, ch * 128 + 4 * np.arange(32) + e, best_i)
                    for off in (16, 8, 4, 2, 1):
                        ov, oi = best[np.arange(32) ^ off], best_i[np.arange(32) ^ off]
                        take = (ov > best) | ((ov == best) & (oi < best_i))
                        best, best_i = np.where(take, ov, best), np.where(take, oi, best_i)
                    cval[ch], cidx[ch] = best[0], best_i[0]
                    cs = np.float32(0)
                    if best[0] != -np.inf:
                        cs = np.exp(lanes - best[0]).astype(np.float32).sum(dtype=np.float32)
                    m, s = _lse_merge(m, s, best[0], cs)
            warp_pairs.append((m, s))
        m, s = np.float32(-np.inf), np.float32(0)
        for pair in warp_pairs:
            m, s = _lse_merge(m, s, *pair)
        pairs.append((m, s))
    m, s = np.float32(-np.inf), np.float32(0)
    for pair in pairs:
        m, s = _lse_merge(m, s, *pair)
    return cval, cidx, np.float32(m + np.log(s))


def _tail_row(rng, V, low_cta=None, plan=None):
    """A row of random penalized logits; with low_cta, that CTA's columns
    all lie ~1,000 below the row's maximum."""
    adj = (rng.standard_normal(V) * 3).astype(np.float32)
    if low_cta is not None:
        chunks = _cta_chunks(plan, V)[low_cta]
        adj[chunks[0] * 128:min((chunks[-1] + 1) * 128, V)] -= 1000.0
    return adj


@pytest.mark.parametrize("B", [1, 64, 512])
@pytest.mark.parametrize("V", [65536, 65536 - 64 - 3, 1000])
def test_tail_model_merges_to_the_logsumexp(B, V):
    """The kernel's merge order, modelled in float32, is within 1e-4 of
    torch.logsumexp, also when one CTA's columns all lie far below the
    row's maximum (its pair scales to ~0) and when a CTA's columns are all
    -inf (its pair is skipped); cval and cidx equal the plain version's."""
    plan = sampling_cuda.tail_plan(B, V)
    rng = np.random.default_rng(V + B)
    rows = [_tail_row(rng, V)]
    if plan.split > 1:
        rows.append(_tail_row(rng, V, low_cta=plan.split - 1, plan=plan))
        rows.append(_tail_row(rng, V, low_cta=0, plan=plan))
        inf_row = _tail_row(rng, V)
        chunks = _cta_chunks(plan, V)[1]
        inf_row[chunks[0] * 128:min((chunks[-1] + 1) * 128, V)] = -np.inf
        rows.append(inf_row)
    for adj in rows:
        cval, cidx, lse = _tail_model(adj, plan)
        want = float(torch.logsumexp(torch.from_numpy(adj).double(), dim=0))
        assert abs(float(lse) - want) <= 1e-4, (float(lse), want)
        zeros = torch.zeros((1, V))
        ref = sampling_cuda.penalty_tail_reference(
            torch.from_numpy(adj)[None], zeros, zeros, torch.ones(1), torch.zeros(1),
            torch.zeros(1), torch.full((1,), -1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool))
        np.testing.assert_array_equal(cval, ref[2][0].numpy())
        np.testing.assert_array_equal(cidx, ref[3][0].numpy())


@pytest.mark.parametrize("cols", [(643, 730), (100, 65536 - 61), (4 * 64 * 128 - 1, 4 * 64 * 128)])
def test_tail_tie_takes_the_lower_column(cols):
    """A maximum tied within one chunk, across the first and last CTA of a
    row at batch 64, and across the two CTAs that meet at column 32,768:
    the model's candidates send the sampler's greedy path (temperature 0)
    to the lower column, as torch.argmax over the row does."""
    V, B = 65536, 64
    plan = sampling_cuda.tail_plan(B, V)
    rng = np.random.default_rng(7)
    adj = (rng.standard_normal(V) * 3).astype(np.float32)
    adj[list(cols)] = 60.0
    owners = [next(r for r, c in enumerate(_cta_chunks(plan, V)) if col // 128 in c)
              for col in cols]
    if cols[1] // 128 != cols[0] // 128:
        assert owners[0] != owners[1]  # the tie crosses CTAs
    cval, cidx, lse = _tail_model(adj, plan)
    logits = torch.from_numpy(adj)[None]
    one = torch.ones(1)
    picked = sampling_cuda.sample_from_chunks(
        torch.from_numpy(cval)[None], torch.from_numpy(cidx.astype(np.int32))[None],
        torch.tensor([[float(lse)]]), torch.zeros(1), one, torch.zeros(1, dtype=torch.int32),
        torch.Generator().manual_seed(0), (logits, torch.zeros((1, V)), torch.zeros((1, V)),
                                            torch.zeros(1)))
    assert int(picked[0]) == min(cols) == int(torch.argmax(logits[0]))


@pytest.mark.parametrize("split", [2, 4, 8])
@pytest.mark.parametrize("V", [65536, 65536 - 64 - 3])
def test_tail_model_merges_at_every_split(split, V):
    """At each split that chip_smoke.py times, the kernel's merge order
    gives the row's logsumexp within 1e-4 and a maximum tied across the
    first and last CTA goes to the lower column in the greedy path."""
    plan = sampling_cuda.tail_shape(64, V, split)
    rng = np.random.default_rng(split)
    owners = _cta_chunks(plan, V)
    adj = _tail_row(rng, V, low_cta=split - 1, plan=plan)
    cols = (owners[0][0] * 128 + 5, owners[-1][-1] * 128 + 2)
    adj[list(cols)] = 60.0
    cval, cidx, lse = _tail_model(adj, plan)
    want = float(torch.logsumexp(torch.from_numpy(adj).double(), dim=0))
    assert abs(float(lse) - want) <= 1e-4, (float(lse), want)
    assert int(cidx[np.argmax(cval)]) == cols[0] == int(np.argmax(adj))

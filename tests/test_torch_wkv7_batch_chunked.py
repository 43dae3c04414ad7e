"""The chunked WY form of the bare WKV7 recurrence (ops/wkv7_cuda.py
wkv7_batch_chunked_reference, the algebra csrc/wkv7_batch.cu follows for
T > 1) against the sequential recurrence, against the JAX kernel, and with its
products' operands rounded to TF32 as the kernel's tensor cores take them;
and the host side of the bare kernel's launch (batch_plan), beside the step
and chunk plans' tests.

Inputs come from a numpy seed and reach both packages as numpy arrays.
Tolerances: float64 within 1e-9 of the output's scale (the two forms sum in
different orders); float32 and the rounded products within the bare kernel's
per-element limit, 2^-7 |ref| + 2^-8 rms(ref), on y and on the state.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chirrup_tpu.ops import wkv7_pallas
from chirrup_tpu_torch.ops import _kernels, wkv7_cuda
from chirrup_tpu_torch.ops.wkv7 import decay_from_raw
from chirrup_tpu_torch.ops.wkv7_cuda import (batch_plan, wkv7_batch_chunked_reference,
                                             wkv7_batch_reference)

N = 64
TOKENS = [2, 5, 16, 17, 40]
TILES = [8, 16]


def _inputs(rng, B, T, H, ends=True):
    """Rows (B, T, C) with a = -kk and b = kk * iclr from a per-head unit kk
    (iclr ~ 1 on odd rows), decay logits +8 (d1 ~ 0.545) on a quarter of the
    columns and -8 (d1 ~ 1) on another where `ends`, and a state (B, N, C),
    all float32."""
    C = H * N
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    kk = rng.standard_normal((B, T, H, N))
    kk = (kk / np.linalg.norm(kk, axis=-1, keepdims=True)).reshape(B, T, C)
    iclr = 1 / (1 + np.exp(-rng.standard_normal((B, T, C))))
    iclr[1::2] = 1 - 2.0 ** -10
    w = f(B, T, C) * 4
    if ends:
        cols = rng.permutation(C)
        w[..., cols[:C // 4]] = 8.0
        w[..., cols[C // 4:C // 2]] = -8.0
    return dict(state=(rng.standard_normal((B, N, C)) * 0.3).astype(np.float32),
                r=f(B, T, C), w=w, k=f(B, T, C), v=f(B, T, C),
                a=(-kk).astype(np.float32), b=(kk * iclr).astype(np.float32))


def _counters(values):
    return np.asarray(values, np.int64).astype(np.uint32).view(np.int32)


def _torch(d, keys=("r", "w", "k", "v", "a", "b")):
    return [torch.from_numpy(d[k]) for k in keys]


def _sequential64(state, r, w, k, v, a, b, elapsed, lengths):
    """The recurrence token by token in float64 (numpy), the decays as the
    port computes them (float32, decay_from_raw), y = S_t r_t; tokens at or
    past a row's length leave the state and give 0."""
    B, T, C = r.shape
    H = C // N
    hd = lambda x: x.astype(np.float64).reshape(B, T, H, N)
    rs, ks, vs, as_, bs = (hd(x) for x in (r, k, v, a, b))
    S = state.astype(np.float64).reshape(B, N, H, N).transpose(0, 2, 1, 3)
    steps = torch.from_numpy(elapsed.astype(np.int64))[:, None, None, None] \
        + torch.arange(T)[None, :, None, None]
    d1 = (1.0 + decay_from_raw(torch.from_numpy(w).reshape(B, T, H, N), steps)).numpy()
    y = np.zeros((B, T, H, N))
    for t in range(T):
        act = (t < lengths)[:, None, None, None]
        sa = np.einsum("bhij,bhj->bhi", S, as_[:, t])
        new = (S * d1[:, t, :, None, :].astype(np.float64)
               + vs[:, t, :, :, None] * ks[:, t, :, None, :] + sa[..., None] * bs[:, t, :, None, :])
        S = np.where(act, new, S)
        y[:, t] = np.where(act[..., 0], np.einsum("bhij,bhj->bhi", S, rs[:, t]), 0.0)
    return y.reshape(B, T, C), S.transpose(0, 2, 1, 3).reshape(B, N, C)


def _excess(got, ref):
    """Worst |got - ref| / (2^-7 |ref| + 2^-8 rms(ref)) over the elements."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    limit = 2.0 ** -7 * np.abs(ref) + 2.0 ** -8 * np.sqrt(np.mean(ref ** 2))
    return float(np.max(np.abs(got - ref) / limit))


def _case(T, tile, seed=0):
    """Four rows at width 128: lengths 0, one mid-tile, the tile's edge (or
    T) and T; dither counters that cross 2^31 within the chunk."""
    rng = np.random.default_rng(seed + 10 * T + tile)
    d = _inputs(rng, 4, T, 2)
    lengths = np.array([0, min(max(tile // 2 + 1, 1), T), min(tile, T), T], np.int32)
    elapsed = _counters([2 ** 31 - 3, 2 ** 31 - 1, 2 ** 31 - tile // 2, 7])
    return d, lengths, elapsed


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("T", TOKENS)
def test_chunked_matches_sequential_float64(T, tile):
    """The chunked form without rounding, in float64, against the recurrence
    token by token in float64: y and the state within 1e-9 of their scale,
    ragged rows (length 0, mid-tile, the tile's edge, full), both decay ends,
    rows with a_iclr ~ 1 and counters crossing 2^31. Past a length y is 0,
    and the length-0 row keeps its state bit for bit."""
    d, lengths, elapsed = _case(T, tile)
    y_ref, s_ref = _sequential64(d["state"], *(d[k] for k in ("r", "w", "k", "v", "a", "b")),
                                 elapsed, lengths)
    state = torch.from_numpy(d["state"]).double()
    y, s = wkv7_batch_chunked_reference(state, *_torch(d), torch.from_numpy(elapsed),
                                        torch.from_numpy(lengths), tile=tile,
                                        dtype=torch.float64)
    y, s = y.numpy(), s.numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-9 * np.abs(y_ref).max())
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=1e-9 * np.abs(s_ref).max())
    for b in range(4):
        assert np.all(y[b, lengths[b]:] == 0)
    np.testing.assert_array_equal(s[0], state.numpy()[0])


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("T", TOKENS)
def test_chunked_matches_sequential_float32(T, tile):
    """The chunked form without rounding, in float32, against the sequential
    plain version (wkv7_batch_reference, float32): y and the state within
    the per-element limit."""
    d, lengths, elapsed = _case(T, tile, seed=1)
    args = (*_torch(d), torch.from_numpy(elapsed), torch.from_numpy(lengths))
    state = torch.from_numpy(d["state"])
    y_ref, s_ref = wkv7_batch_reference(state, *args)
    y, s = wkv7_batch_chunked_reference(state, *args, tile=tile)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    assert _excess(y, y_ref) <= 1 and _excess(s, s_ref) <= 1


@pytest.mark.parametrize("T", TOKENS)
def test_chunked_matches_pallas(T):
    """The chunked form (float32, the kernel's tile) against the JAX kernel,
    wkv7_pallas_batch(precision="highest", interpret=True), on the same
    inputs: y and the state within the per-element limit."""
    d, lengths, elapsed = _case(T, 16, seed=2)
    rows = [d[k] for k in ("r", "w", "k", "v", "a", "b")]
    y_j, s_j = wkv7_pallas.wkv7_pallas_batch(
        jnp.asarray(d["state"]), *(jnp.asarray(x) for x in rows), jnp.asarray(elapsed),
        lengths=jnp.asarray(lengths), interpret=True, precision="highest")
    y, s = wkv7_batch_chunked_reference(torch.from_numpy(d["state"]), *_torch(d),
                                        torch.from_numpy(elapsed), torch.from_numpy(lengths),
                                        tile=batch_plan(4, T, 128, "highest").tile_tokens)
    assert _excess(y, np.asarray(y_j)) <= 1 and _excess(s, np.asarray(s_j)) <= 1


@pytest.mark.parametrize("rounding", ["tf32", "3xtf32"])
def test_tf32_gate(rounding, capsys):
    """The numerical gate of the WY form: at N 64, T 512, decays at both ends
    and a_iclr ~ 1 on every other row, the products' operands rounded as the
    kernel's tensor cores take them, at the kernel's tile length, stay within
    the per-element limit of the float64 recurrence on y and the state, and
    the margin is printed. The kernel's arithmetic ("highest" and
    "default" alike) is "3xtf32", which keeps under a hundredth of the
    limit; one pass ("tf32") holds it here too, about half used."""
    T, tile = 512, batch_plan(2, 512, 64, "default").tile_tokens
    rng = np.random.default_rng(512)
    d = _inputs(rng, 2, T, 1)
    lengths = np.array([T, T - 3], np.int32)
    elapsed = _counters([2 ** 31 - 100, 7])
    y_ref, s_ref = _sequential64(d["state"], *(d[k] for k in ("r", "w", "k", "v", "a", "b")),
                                 elapsed, lengths)
    y, s = wkv7_batch_chunked_reference(torch.from_numpy(d["state"]), *_torch(d),
                                        torch.from_numpy(elapsed), torch.from_numpy(lengths),
                                        tile=tile, rounding=rounding)
    ex_y, ex_s = _excess(y, y_ref), _excess(s, s_ref)
    with capsys.disabled():
        print(f"\nWY form, {rounding} products, tile {tile}, N 64, T {T}: worst "
              f"|err|/limit y {ex_y:.4f}, state {ex_s:.4f}")
    assert ex_y <= 1 and ex_s <= 1
    if rounding == "3xtf32":
        assert max(ex_y, ex_s) < 1e-2


def test_tf32_rounding():
    """tf32_round rounds the mantissa to 10 bits, to nearest even;
    tf32_trunc cuts it (the bits the tensor cores read)."""
    one = 1.0 + 2.0 ** -10
    x = torch.tensor([1.0 + 2.0 ** -11, one + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(one + 2.0 ** -12),
                      1.0 + 2.0 ** -11 - 2.0 ** -20], dtype=torch.float32)
    torch.testing.assert_close(wkv7_cuda.tf32_round(x), torch.tensor(
        [1.0, one + 2.0 ** -10, one, -one, 1.0], dtype=torch.float32), rtol=0, atol=0)
    torch.testing.assert_close(wkv7_cuda.tf32_trunc(x), torch.tensor(
        [1.0, one, 1.0, -one, 1.0], dtype=torch.float32), rtol=0, atol=0)


def test_chunked_reference_refusals():
    """An unknown rounding, and TF32 rounding outside float32, are refused."""
    d, lengths, elapsed = _case(5, 8)
    args = (torch.from_numpy(d["state"]), *_torch(d), torch.from_numpy(elapsed))
    with pytest.raises(ValueError):
        wkv7_batch_chunked_reference(*args, rounding="bf16")
    with pytest.raises(ValueError):
        wkv7_batch_chunked_reference(*args, rounding="tf32", dtype=torch.float64)


# ------------------------------------------------------------- batch_plan

BATCH_SHAPES = [(64, 1, 4096), (8, 64, 4096), (8, 256, 4096), (32, 64, 4096), (2, 1024, 4096),
                (3, 5, 320), (1, 2, 64)]


@pytest.mark.parametrize("B,T,C", BATCH_SHAPES)
@pytest.mark.parametrize("precision", ["highest", "default", "bf16"])
def test_batch_plan_paths(B, T, C, precision):
    """T = 1 takes the step kernel's launch (step_plan's numbers, its grid);
    T > 1 in float32 state math the WY form (4 warps of 16 state rows, a
    quad a row, 16-token tiles, the same launch in both arithmetics) and in
    the bf16 arithmetic the chunk kernel's launch (chunk_plan's numbers)."""
    plan = batch_plan(B, T, C, precision)
    H = C // N
    if T == 1:
        step = wkv7_cuda.step_plan(B, C)
        assert plan.path == "rows" and plan.tile_tokens == 1
        assert (plan.threads, plan.heads_per_block, plan.rows_per_thread, plan.threads_per_row,
                plan.grid) == (step.threads, step.heads_per_block, step.rows_per_thread,
                               step.threads_per_row, step.grid)
    elif precision == "bf16":
        chunk = wkv7_cuda.chunk_plan(B, T, C)
        assert plan.path == "tokens"
        assert (plan.threads, plan.rows_per_thread, plan.threads_per_row, plan.tile_tokens,
                plan.grid) == (chunk.threads, chunk.rows_per_thread, chunk.threads_per_row,
                               chunk.tile_tokens, chunk.grid)
    else:
        assert plan.path == "wy" and plan.tile_tokens == 16
        # 4 warps x 16 rows hold the head's 64 rows; a quad's 4 lanes x 16
        # columns hold a row, each lane 2 rows (g and g + 8)
        assert plan.threads // 32 * 16 == N and plan.threads_per_row * 16 == N
        assert plan.rows_per_thread * (32 // plan.threads_per_row) * (plan.threads // 32) \
            == N
        assert plan.grid == (H, B, 1) and plan.heads_per_block == 1


@pytest.mark.parametrize("B,T,C,precision", [(0, 4, 256, "default"), (65536, 4, 256, "default"),
                                             (4, 0, 256, "default"), (4, 4, 100, "highest"),
                                             (4, 4, 32, "bf16"), (4, 4, 256, "fast")])
def test_batch_plan_refusals(B, T, C, precision):
    """Shapes the kernel does not take (B past the grid's 65,535, no tokens,
    C not whole heads) and unknown arithmetics are refused."""
    with pytest.raises(ValueError):
        batch_plan(B, T, C, precision)


def _constants(pattern):
    text = (_kernels.CSRC / "wkv7_batch.cu").read_text()
    found = re.search(pattern, text)
    assert found, f"csrc/wkv7_batch.cu no longer holds {pattern!r}"
    return tuple(int(g) for g in found.groups())


def test_batch_plan_matches_the_source():
    """batch_plan describes the three launches csrc/wkv7_batch.cu fixes (its
    entry refuses any other): the rows launch's heads a block, rows a thread
    and threads a row; the WY form's tile and threads; the tokens launch's
    rows a thread, threads a row and tile."""
    HB, RI, P = _constants(r"constexpr int HB = (\d+), RI = (\d+), P = (\d+),")
    rows = batch_plan(64, 1, 4096, "default")
    assert (rows.heads_per_block, rows.rows_per_thread, rows.threads_per_row,
            rows.threads) == (HB, RI, P, HB * N // RI * P)
    (WT,) = _constants(r"constexpr int WT = (\d+);")
    (WNT,) = _constants(r"constexpr int WNT = (\d+);")
    wy = batch_plan(8, 64, 4096, "highest")
    assert (wy.tile_tokens, wy.threads) == (WT, WNT)
    RI2, P2, TT2 = _constants(r"constexpr int RI2 = (\d+), P2 = (\d+), TT2 = (\d+),")
    tok = batch_plan(8, 64, 4096, "bf16")
    assert (tok.rows_per_thread, tok.threads_per_row, tok.tile_tokens,
            tok.threads) == (RI2, P2, TT2, N // RI2 * P2)
    assert tuple(wkv7_cuda.BATCH_PATHS[p] for p in ("rows", "wy", "tokens")) == _constants(
        r"enum \{ PATH_ROWS = (\d+), PATH_WY = (\d+), PATH_TOKENS = (\d+) \};")


def test_batch_planned_refuses_the_cpu():
    """Only a CPU state takes the plain version: a state on any other device
    that is not CUDA is refused, not handed to a plain version or a kernel."""
    d, lengths, elapsed = _case(5, 8)
    meta = lambda x: x.to("meta")
    state = meta(torch.from_numpy(d["state"])[None])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        wkv7_cuda.wkv7_batch(state, *(meta(x) for x in _torch(d)),
                             meta(torch.from_numpy(elapsed)), meta(torch.from_numpy(lengths)),
                             precision="default")

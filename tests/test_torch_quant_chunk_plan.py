"""The host side of the activation quantizer (ops/mm8_cuda.py quant_plan,
quant_shape, check_quant_operands) and of the WKV chunk kernel
(ops/wkv7_cuda.py chunk_plan, check_chunk_operands), on the CPU, and the
quantizer's rounding of its codes emulated in numpy float32.

Both kernels (csrc/mm8_a8.cu, csrc/wkv7_chunk.cu) take raw pointers, so what
they rely on is checked here: that a quantizer launch covers every element of
a row exactly once in whole warps within the kernel's launch bounds; that the
chunk launch gives every state element of a head to exactly one thread and
joins each row's threads within a warp; and that what either kernel cannot
take is refused before a launch. The kernels' own results are checked on the
card by chip_smoke.py; the plain versions against the JAX package by
tests/test_torch_mm8.py and tests/test_torch_prefill.py.
"""

import numpy as np
import pytest
import torch

from chirrup_tpu_torch.ops import mm8_cuda, wkv7_cuda

# (site, n variants, K) of the quantizer on the 7.2B serving path: merged
# R/K/V (the token-shift mix), Wo (the gate), FFN Wk, FFN Wv, the head
QUANT_SITES = [("att R/K/V", 3, 4096), ("att Wo", 1, 4096), ("ffn Wk", 1, 4096),
               ("ffn Wv", 1, 16384), ("head", 1, 4096)]
ROWS = [1, 37, 64, 512, 1000, 2048]


def _chunks_covered(plan, K):
    """How many times each 8-element chunk of a row is held by a thread:
    chunk t + j * threads of thread t, j < elems / 8."""
    chunks = K // 8
    seen = np.zeros(chunks, np.int64)
    for t in range(plan.threads):
        for j in range(plan.elems // 8):
            c = t + j * plan.threads
            if c < chunks:
                seen[c] += 1
    return seen


@pytest.mark.parametrize("B", ROWS)
def test_quant_plan_serving_sites(B):
    """At every serving site and row count: whole warps within the launch
    bound of the plan's elements a thread (at most 1,024 threads), threads x
    elements covering the row exactly once, and one CTA per (variant, row)."""
    for site, n, K in QUANT_SITES:
        plan = mm8_cuda.quant_plan(n, B, K)
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024, (site, plan)
        assert plan.threads <= mm8_cuda.QUANT_MAX_THREADS[plan.elems], (site, plan)
        assert plan.threads * plan.elems >= K, (site, plan)
        assert (_chunks_covered(plan, K) == 1).all(), (site, plan)
        assert plan.grid == (n, B, 1), (site, plan)


def test_quant_plan_choices():
    """The launches measured fastest on the H100: at decode 16 elements a
    thread for the merged R/K/V and FFN Wv, 8 elsewhere, at one row as at
    64; at prefill row counts 32 a thread at every site."""
    shape = lambda n, B, K: tuple(mm8_cuda.quant_plan(n, B, K))[:2]
    assert shape(3, 64, 4096) == (256, 16)
    assert shape(1, 64, 4096) == (512, 8)
    assert shape(1, 64, 16384) == (1024, 16)
    assert shape(1, 1, 16384) == (1024, 16)
    assert shape(3, 2048, 4096) == (128, 32)
    assert shape(1, 2048, 4096) == (128, 32)
    assert shape(1, 2048, 16384) == (512, 32)


@pytest.mark.parametrize("n,K", [(1, 4096), (3, 4096), (1, 16384), (1, 256), (3, 1024),
                                 (1, 72)])
def test_quant_shape_every_launch_covers_k(n, K):
    """Every launch the kernel has for a shape (elements a thread) covers the
    row exactly once in whole warps; the ones it lacks are refused."""
    launches = 0
    for elems in (8, 16, 32):
        try:
            plan = mm8_cuda.quant_shape(n, 64, K, elems)
        except ValueError:
            assert -(-(K // 8) // (4 * elems)) * 32 > mm8_cuda.QUANT_MAX_THREADS[elems], elems
            continue
        launches += 1
        assert plan.threads % 32 == 0 and plan.grid == (n, 64, 1)
        assert (_chunks_covered(plan, K) == 1).all(), plan
    assert launches > 0


@pytest.mark.parametrize("case,args", [
    ("K not a multiple of 8", (1, 64, 4100, 8)),
    ("no rows", (1, 0, 4096, 8)),
    ("no variants", (0, 64, 4096, 8)),
    ("12 elements a thread", (3, 64, 4096, 12)),
    ("64 elements a thread", (1, 64, 4096, 64)),
    ("too many threads", (1, 64, 16384, 8)),
])
def test_quant_shape_refuses(case, args):
    with pytest.raises(ValueError):
        mm8_cuda.quant_shape(*args)


def _quant_inputs(B=4, K=64, n=1, dtype=torch.bfloat16, mode="plain"):
    x = torch.randn(B, K).to(dtype)
    ry, my = torch.rand(n, K), torch.rand(n, K)
    kw = {}
    if mode == "mix":
        kw = dict(xx=torch.randn(B, K).to(dtype), mu=torch.rand(n, K).to(dtype))
    elif mode == "mul":
        kw = dict(mul=torch.rand(B, K).to(dtype))
    return x, ry, my, kw


def _misaligned(B, K, dtype):
    """A contiguous (B, K) tensor whose data starts 8 bytes past a 16-byte
    boundary."""
    base = torch.zeros(B * K + 16, dtype=dtype)
    off = (-(base.data_ptr() % 16) + 8) % 16 // base.element_size()
    return base[off:off + B * K].view(B, K)


@pytest.mark.parametrize("mode", ["plain", "mix", "mul"])
def test_quant_operands_accepted(mode):
    n = 3 if mode == "mix" else 1
    x, ry, my, kw = _quant_inputs(n=n, mode=mode)
    got_mode, aux = mm8_cuda.check_quant_operands(x, ry, my, **kw)
    assert got_mode == {"plain": 0, "mix": 1, "mul": 2}[mode]
    assert aux is (kw.get("xx", kw.get("mul")))


@pytest.mark.parametrize("case,error", [
    ("float16 x", TypeError), ("float64 ry", TypeError), ("ry of another width", ValueError),
    ("my of another variant count", ValueError), ("mu in another dtype", TypeError),
    ("xx without mu", ValueError), ("mul with three variants", ValueError),
    ("xx of other rows", ValueError), ("non-contiguous x", ValueError),
    ("x off a 16-byte boundary", ValueError), ("ry on another device", ValueError),
    ("x not 2-D", ValueError),
])
def test_quant_operands_refused(case, error):
    """What the quantizer kernel cannot take raises before any launch; on the
    CPU the wrapper would take the plain version, so the check is called as
    the CUDA path calls it."""
    x, ry, my, kw = _quant_inputs()
    if case == "float16 x":
        x = x.to(torch.float16)
    elif case == "float64 ry":
        ry = ry.double()
    elif case == "ry of another width":
        ry = torch.rand(1, 72)
    elif case == "my of another variant count":
        my = torch.rand(2, 64)
    elif case == "mu in another dtype":
        kw = dict(xx=torch.randn(4, 64).to(torch.bfloat16), mu=torch.rand(1, 64))
    elif case == "xx without mu":
        kw = dict(xx=torch.randn(4, 64).to(torch.bfloat16))
    elif case == "mul with three variants":
        ry, my = torch.rand(3, 64), torch.rand(3, 64)
        kw = dict(mul=torch.rand(4, 64).to(torch.bfloat16))
    elif case == "xx of other rows":
        kw = dict(xx=torch.randn(5, 64).to(torch.bfloat16), mu=torch.rand(1, 64).to(torch.bfloat16))
    elif case == "non-contiguous x":
        x = torch.randn(64, 4).to(torch.bfloat16).t()
    elif case == "x off a 16-byte boundary":
        x = _misaligned(4, 64, torch.bfloat16)
    elif case == "ry on another device":
        ry = torch.empty(1, 64, device="meta")
    elif case == "x not 2-D":
        x = x[None]
    with pytest.raises(error):
        mm8_cuda.check_quant_operands(x, ry, my, **kw)


# --------------------------------------------------------------- WKV chunk

CHUNK_VARIANTS = [(8, 64, 4096), (8, 256, 4096), (32, 64, 4096), (4, 16, 256), (8, 8, 256),
                  (3, 12, 128)]


def _owners(plan):
    """How many threads hold each (row, column) of a head's 64 x 64 state:
    thread t holds rows t // P * RI + r (r < RI) and the float4 column
    groups g * P + t % P (g < 16 / P)."""
    RI, P = plan.rows_per_thread, plan.threads_per_row
    seen = np.zeros((64, 64), np.int64)
    for t in range(plan.threads):
        for r in range(RI):
            for g in range(16 // P):
                c = 4 * (g * P + t % P)
                seen[t // P * RI + r, c:c + 4] += 1
    return seen


@pytest.mark.parametrize("P,T,C", CHUNK_VARIANTS)
def test_chunk_plan_prefill_variants(P, T, C):
    """At the prefill variants and the small test shapes: whole warps; every
    state element held by exactly one thread, a row's threads neighbouring
    lanes of one warp (its shuffles); one block per (head, request)."""
    plan = wkv7_cuda.chunk_plan(P, T, C)
    assert plan.threads == 64 // plan.rows_per_thread * plan.threads_per_row
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert (_owners(plan) == 1).all()
    assert 32 % plan.threads_per_row == 0
    assert plan.tile_tokens >= 1
    assert plan.grid == (C // 64, P, 1)


def test_chunk_plan_choice():
    """The launch measured fastest on the H100 at every prefill variant: four
    state rows a thread, eight threads a row (128 threads), 16-token tiles,
    whatever the chunk's length."""
    for P, T in ((8, 64), (8, 256), (32, 64), (8, 12)):
        plan = wkv7_cuda.chunk_plan(P, T, 4096)
        assert (plan.rows_per_thread, plan.threads_per_row, plan.threads,
                plan.tile_tokens) == (4, 8, 128, 16)


@pytest.mark.parametrize("case,args", [
    ("no requests", (0, 64, 4096)),
    ("no tokens", (8, 0, 4096)),
    ("width not in heads", (8, 64, 4000)),
])
def test_chunk_plan_refuses(case, args):
    with pytest.raises(ValueError):
        wkv7_cuda.chunk_plan(*args)


def _chunk_inputs(B=3, T=5, C=128, L=2, dtype=torch.bfloat16):
    rkv = torch.randn(B, T, 3 * C).to(dtype)
    r, k, v = rkv.split(C, dim=-1)
    w, a = torch.randn(B, T, C).to(dtype), torch.rand(B, T, C).to(dtype)
    params = [torch.rand(C).to(dtype) for _ in range(5)]
    state = torch.zeros(L, B, 64, C, dtype=dtype)
    i32 = torch.int32
    return state, [r, w, k, a, v, *params, torch.zeros(B, dtype=i32), torch.full((B,), T, dtype=i32)]


def test_chunk_operands_accepted():
    """The merged R/K/V views (strides (T*3C, 3C, 1)) are taken as they are."""
    state, args = _chunk_inputs()
    strides = wkv7_cuda.check_chunk_operands(state, 1, *args)
    assert strides[:2] == [5 * 3 * 128, 3 * 128] and strides[2:4] == [5 * 128, 128]


@pytest.mark.parametrize("case,error", [
    ("float16 rows", TypeError), ("w in another dtype", ValueError),
    ("rows off a 16-byte boundary", ValueError), ("token stride off 16 bytes", ValueError),
    ("column stride not 1", ValueError), ("lengths int64", TypeError),
    ("layer out of range", IndexError), ("state of another width", ValueError),
    ("parameter of another width", ValueError), ("state on another device", ValueError),
])
def test_chunk_operands_refused(case, error):
    """What the chunk kernel cannot take raises before any launch; on the CPU
    the wrapper would take the plain version, so the check is called as the
    CUDA path calls it."""
    state, args = _chunk_inputs()
    layer = 1
    B, T, C = args[0].shape
    if case == "float16 rows":
        args[:5] = [t.to(torch.float16) for t in args[:5]]
    elif case == "w in another dtype":
        args[1] = args[1].float()
    elif case == "rows off a 16-byte boundary":
        args[0] = torch.randn(B, T, C + 4).to(torch.bfloat16)[..., 4:]
    elif case == "token stride off 16 bytes":
        args[3] = torch.rand(B, T, C + 4).to(torch.bfloat16)[..., :C]
    elif case == "column stride not 1":
        args[4] = torch.randn(B, C, T).to(torch.bfloat16).transpose(1, 2)
    elif case == "lengths int64":
        args[-1] = args[-1].long()
    elif case == "layer out of range":
        layer = 2
    elif case == "state of another width":
        state = torch.zeros(2, B, 64, 2 * C, dtype=torch.bfloat16)
    elif case == "parameter of another width":
        args[5] = torch.rand(C + 64).to(torch.bfloat16)
    elif case == "state on another device":
        state = torch.empty(2, B, 64, C, dtype=torch.bfloat16, device="meta")
    with pytest.raises(error):
        wkv7_cuda.check_chunk_operands(state, layer, *args)


# ------------------------------------------------ the quantizer's rounding

def _codes4(xs, s, fallback=True):
    """csrc/mm8_a8.cu codes4 in numpy float32, each group of 4 elements: q =
    xs * rn(1/s) (one rounded multiply); where any of the four lies within
    2^-15 of a half-integer, the IEEE quotient xs / s for all four; then
    round half to even. fallback=False: the multiply alone."""
    f32 = np.float32
    xs = np.asarray(xs, f32).reshape(-1, 4)
    s = f32(s)
    inv = f32(1) / s
    q = xs * inv
    if fallback:
        near = (f32(0.5) - np.abs(q - np.rint(q)) <= f32(2.0 ** -15)).any(1, keepdims=True)
        q = np.where(near, xs / s, q)
    return np.rint(q).astype(np.int32).ravel()


def _scale(xs):
    """The kernel's s: max(rn(max|xs| / 127), 1e-20) in float32."""
    f32 = np.float32
    return max(f32(np.abs(xs).max()) / f32(127), f32(1e-20))


def _quotient_rows(case, rng):
    """(xs, s) pairs in float32 for a case: random rows at scales from 1e-18
    up; quotients xs / s at half-integers and a few ulps beside them; rows
    whose largest element is 127 s up to the rounding of s; rows at the
    floor s = 1e-20."""
    f32 = np.float32
    out = []
    if case == "random rows":
        for e in range(-18, 6):
            for _ in range(8):
                xs = (rng.standard_normal(4096) * 10.0 ** e).astype(f32)
                out.append((xs, _scale(xs)))
    elif case in ("at half-integers", "beside half-integers"):
        for s in rng.uniform(1e-6, 1e3, 64).astype(f32):
            half = np.arange(-127, 127, dtype=np.float64) + 0.5
            xs = (half * np.float64(s)).astype(f32)
            if case == "beside half-integers":
                xs = np.concatenate([_step(xs, u) for u in range(-6, 7) if u])
            xs = xs[:len(xs) // 4 * 4]
            out.append((xs, s))
    elif case == "at ±127":
        for _ in range(256):
            xs = rng.standard_normal(64).astype(f32)
            xs[rng.integers(64)] = f32(np.abs(xs).max() * rng.choice([-1.0, 1.0]) * 1.5)
            out.append((xs, _scale(xs)))
    elif case == "s at its floor":
        for e in (-19.0, -20.0, -22.0, -30.0):
            xs = (rng.standard_normal(1024) * 10.0 ** e).astype(f32)
            out.append((xs, _scale(xs)))
    return out


def _step(xs, ulps):
    """xs moved by `ulps` float32 steps (toward +inf for ulps > 0)."""
    out = xs.copy()
    for _ in range(abs(int(ulps))):
        out = np.nextafter(out, np.float32(np.inf if ulps > 0 else -np.inf))
    return out


@pytest.mark.parametrize("case", ["random rows", "at half-integers", "beside half-integers",
                                  "at ±127", "s at its floor"])
def test_codes4_equals_the_ieee_quotient(case):
    """The kernel's codes, a multiply by rn(1/s) with the IEEE division where
    a quotient lies within 2^-15 of a half-integer, are round-half-even of
    rn(xs / s) bit for bit: the multiply errs by less than 2e-5, so only a
    half-integer within that could separate the two, and there the kernel
    divides."""
    rng = np.random.default_rng(7)
    for xs, s in _quotient_rows(case, rng):
        want = np.rint(xs / np.float32(s)).astype(np.int32)
        assert np.abs(want).max() <= 127 or case != "random rows"
        np.testing.assert_array_equal(_codes4(xs, s), want, err_msg=f"{case}, s {s!r}")


def test_codes4_needs_its_division():
    """Beside half-integers the multiply alone rounds some quotients the
    other way, so the division is what makes the codes exact."""
    rng = np.random.default_rng(7)
    rows = _quotient_rows("beside half-integers", rng)
    wrong = sum(int((_codes4(xs, s, fallback=False)
                     != np.rint(xs / np.float32(s)).astype(np.int32)).sum()) for xs, s in rows)
    assert wrong > 0

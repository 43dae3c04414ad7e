#!/usr/bin/env python3
"""Smoke run of chirrup_tpu_torch on one NVIDIA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py [--profile]

Phases, in order; any failure ends the run with a non-zero exit:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the decode path from chirrup_tpu_torch/csrc, all
   nvcc processes at once;
3. each kernel at the decode path's shapes (7.2B: C 4096, H 64, d_ffn 16384,
   V 65536, batch 64) against its plain PyTorch version on the same inputs,
   with its time, its bound, the plain version's time and, where one PyTorch
   call computes the same function, that call's time;
4. the whole decode path on a small model, kernels (GPU) against plain
   versions (CPU);
5. the port's AsyncEngineCore serving four concurrent requests at the full
   width of the 7.2B model (32 layers, random INT8 weights from a seed), with
   every kernel's launch counter read around that run; then one decode block
   under torch.cuda.set_sync_debug_mode("error"), with the launches per step
   counted over it; the steady decode rate at batch 64 over 8 blocks, with each
   block's host dispatch, CPU and wall time; and the device busy time of one
   block from torch.profiler (its table goes to chiprun_out/chip_smoke_profile.txt;
   --profile prints it as well);
6. one JSON line with every kernel's numbers, then the result line.

Without a CUDA device, or without the chirrup_tpu_torch package beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
PEAK_OPS_PER_S = {"int8": 1979e12, "fp32": 67e12}   # dense, no sparsity
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ----------------------------------------------------------------- timing

def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over `reps` of the mean device time of `iters` back-to-back calls.
    A sleep kernel ahead of each rep lets the host queue every call before the
    first one starts, so host overhead does not stretch the measurement."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# --------------------------------------------------------------- kernels

def bf16_excess(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref| / limit over the elements, where the limit is one
    bf16 step at |ref| (2^-7 |ref|: the two sides sum in different orders
    before one final bf16 rounding) plus 2^-8 rms(ref) for elements where
    terms cancel. At most 1 means every element is within its limit."""
    g, r = got.double(), ref.double()
    limit = 2.0 ** -7 * r.abs() + 2.0 ** -8 * r.square().mean().sqrt()
    return float(((g - r).abs() / limit).max())


def check_wkv(dev, gen, B=64, C=4096, L=32, li=17):
    """The kernel against its plain version twice: with the bonus term on
    (r_k random), where (r*k~*r_k)*v dominates |y|; and with r_k = 0, where
    the GroupNorm*ln_w + ln_b branch alone sets y and its limit. In the second,
    the comparison must reject a planted fault: the plain version without ln_b."""
    from chirrup_tpu_torch.ops.wkv7_cuda import wkv7_step_fused, wkv7_step_fused_reference

    bf = torch.bfloat16
    H = C // 64
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    r, w, k, v = (rnd(B, C).to(bf) for _ in range(4))
    a = torch.sigmoid(rnd(B, C)).to(bf)
    k_k, k_a, r_k = ((rnd(C) * 0.5 + 1.0).to(bf) for _ in range(3))
    ln_w, ln_b = (rnd(C) * 0.1 + 1.0).to(bf), (rnd(C) * 0.1).to(bf)
    state = (rnd(L, B, 64, C) * 0.3).to(bf)
    elapsed = torch.randint(0, 2 ** 31 - 1, (B,), generator=gen, device=dev,
                            dtype=torch.int64).to(torch.int32)
    lengths = torch.ones(B, dtype=torch.int32, device=dev)
    lengths[::9] = 0
    idle = lengths == 0
    args = (r, w, k, a, v, k_k, k_a, r_k, ln_w, ln_b, elapsed, lengths)
    no_bonus = (r, w, k, a, v, k_k, k_a, torch.zeros_like(r_k), ln_w, ln_b, elapsed, lengths)

    errs = []
    for label, case in (("bonus on", args), ("r_k = 0", no_bonus)):
        before = state[li].clone()
        neighbour = state[li - 1].clone()
        y_ref, s_ref = wkv7_step_fused_reference(before, *case)
        y = wkv7_step_fused(state, li, *case)
        torch.cuda.synchronize()
        ex_y, ex_s = bf16_excess(y, y_ref), bf16_excess(state[li], s_ref)
        errs += [max_abs(y, y_ref), max_abs(state[li], s_ref)]
        require(ex_y <= 1 and ex_s <= 1,
                f"wkv7_step_fused {label}: worst |err|/limit y {ex_y}, state {ex_s}")
        require(torch.equal(state[li - 1], neighbour), "wkv7_step_fused touched another layer")
        require(torch.equal(state[li][idle], before[idle]) and bool((y[idle] == 0).all()),
                "wkv7_step_fused: length-0 rows changed")
        y_fault, _ = wkv7_step_fused_reference(before, *case[:9], torch.zeros_like(ln_b),
                                               *case[10:])
        ex_fault = bf16_excess(y_fault, y_ref)
        log(f"wkv7_step_fused {label}: max |y| {float(y_ref.float().abs().max()):.3g}, "
            f"y err {errs[-2]:.3e}, state err {errs[-1]:.3e}; worst |err|/limit y "
            f"{ex_y:.3f}, state {ex_s:.3f} (limit 2^-7|ref| + 2^-8 rms(ref)); "
            f"planted fault (no ln_b) {ex_fault:.2f}")
        if label == "r_k = 0":
            require(ex_fault > 1, f"wkv7_step_fused: the check passes a kernel without ln_b "
                                  f"(worst |err|/limit {ex_fault})")
    err_y, err_s = max(errs[0::2]), max(errs[1::2])
    ms = device_ms(lambda: wkv7_step_fused(state, li, *args))
    plain = device_ms(lambda: wkv7_step_fused_reference(state[li], *args), iters=5)
    moved = 2 * nbytes(state[li]) + nbytes(*args) + nbytes(y)
    b, by = bound_ms(moved, 9 * B * 64 * C, "fp32")
    log(f"wkv7_step_fused B{B} C{C} H{H} bf16: y err {err_y:.3e}, state err {err_s:.3e}; "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by})")
    return dict(name="wkv7_step_fused", route="cuda", source="chirrup_tpu_torch/csrc/wkv7_step.cu",
                replaces="chirrup_tpu/ops/wkv7_pallas.py:644", max_abs_err=max(err_y, err_s),
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                shape=f"state ({L}, {B}, 64, {C}) bf16, one layer",
                tolerance="per element 2^-7 |ref| + 2^-8 rms(ref), y and state")


MM8_SHAPES = [  # (site, K, M, n variants, quant mode, relu2, stacked)
    ("att R/K/V", 4096, 3 * 4096, 3, "mix", False, True),
    ("att Wo", 4096, 4096, 1, "mul", False, True),
    ("ffn Wk", 4096, 16384, 1, "plain", True, True),
    ("ffn Wv", 16384, 4096, 1, "plain", False, True),
    ("head", 4096, 65536, 1, "plain", False, False),
]


def check_mm8(dev, gen, B=64, shapes=MM8_SHAPES):
    from chirrup_tpu_torch.ops import mm8_cuda

    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    quant_rows_out, gemm_rows = [], []
    for site, K, M, n, mode, relu2, stacked in shapes:
        x = rnd(B, K).to(bf)
        if site == "ffn Wv":
            x = torch.relu(x).square().to(bf)
        ry = rnd(n, K).abs() * 0.01 + 1e-3
        my = rnd(n, K) * 0.01
        kw = {}
        if mode == "mix":
            kw = dict(xx=rnd(B, K).to(bf), mu=(rnd(n, K) * 0.5).to(bf))
        elif mode == "mul":
            kw = dict(mul=torch.sigmoid(rnd(B, K)).to(bf))
        x8, st = mm8_cuda.quant_rows(x, ry, my, **kw)
        x8_ref, st_ref = mm8_cuda.quant_rows_reference(x, ry, my, **kw)
        torch.cuda.synchronize()
        code_err = max_abs(x8, x8_ref)
        st_diff = (st[..., 1:] - st_ref[..., 1:]).abs()
        st_err = float(st_diff.max())
        # s is one max and one division: exact. The three sums add the same
        # float32 terms in another order: each is within 2*K*eps32*sum|terms|
        xm = x.float()[None]
        if mode == "mix":
            xm = xm + kw["xx"].float()[None] * kw["mu"].float()[:, None]
        elif mode == "mul":
            xm = xm * kw["mul"].float()[None]
        terms = (xm * (ry * 16)[:, None], xm, xm * my[:, None])
        st_tol = torch.stack([2 * K * 2.0 ** -23 * t.abs().sum(-1) for t in terms], -1)
        require(code_err == 0 and torch.equal(st[..., 0], st_ref[..., 0])
                and bool((st_diff <= st_tol).all()),
                f"mm8_a8_quant_rows {site}: codes err {code_err}, stats err {st_err}")
        st_tol = float(st_tol.max())
        q_ms = device_ms(lambda: mm8_cuda.quant_rows(x, ry, my, **kw))
        q_plain = device_ms(lambda: mm8_cuda.quant_rows_reference(x, ry, my, **kw), iters=5)
        aux = [t for t in kw.values()]
        q_b, q_by = bound_ms(nbytes(x, ry, my, *aux, x8, st), 8 * n * B * K, "fp32")
        quant_rows_out.append(dict(site=site, err=max(code_err, st_err), ms=q_ms,
                                   plain_ms=q_plain, bound_ms=q_b, bound_by=q_by,
                                   shape=f"n {n}, ({B}, {K}) bf16 -> int8"))
        log(f"mm8_a8_quant_rows {site} n{n} B{B} K{K}: codes err {code_err}, stats err "
            f"{st_err:.3e} (tol {st_tol:.3e}); {q_ms:.4f} ms, plain {q_plain:.4f} ms, "
            f"bound {q_b:.4f} ms ({q_by})")

        L = 2 if stacked else None
        q = torch.randint(-128, 128, ((L,) if L else ()) + (K, M), generator=gen,
                          device=dev, dtype=torch.int8)
        layer = 1 if stacked else None
        mx, rx = rnd(M) * 0.01, rnd(M).abs() * 0.01 + 1e-3
        out_dtype = bf
        acc = mm8_cuda.gemm(x8, st, q, mx, rx, layer=layer, out_dtype=torch.int32)
        y = mm8_cuda.gemm(x8, st, q, mx, rx, layer=layer, relu2=relu2, out_dtype=out_dtype)
        q_layer = q[layer] if stacked else q
        acc_ref = mm8_cuda.gemm_reference(x8, st, q_layer, mx, rx, out_dtype=torch.int32)
        y_ref = mm8_cuda.gemm_reference(x8, st, q_layer, mx, rx, relu2=relu2,
                                        out_dtype=out_dtype)
        torch.cuda.synchronize()
        acc_equal = torch.equal(acc, acc_ref)
        y_err = max_abs(y, y_ref)
        # same inputs and the same float operations in the same order: the
        # outputs agree to the last bit; one bf16 step is the stated limit
        y_tol = 2.0 ** -7 * float(y_ref.float().abs().max())
        require(acc_equal and y_err <= y_tol,
                f"mm8_a8_gemm {site}: acc equal {acc_equal}, y err {y_err} (tol {y_tol})")
        g_ms = device_ms(lambda: mm8_cuda.gemm(x8, st, q, mx, rx, layer=layer, relu2=relu2,
                                               out_dtype=out_dtype))
        g_plain = device_ms(lambda: mm8_cuda.gemm_reference(x8, st, q_layer, mx, rx,
                                                            relu2=relu2,
                                                            out_dtype=out_dtype), iters=3)
        lib = None
        if n == 1:
            # the int8 GEMM alone, as cuBLASLt computes it (column-major B)
            q_cm = q_layer.t().contiguous().t()
            lib = device_ms(lambda: torch._int_mm(x8[0], q_cm))
        g_b, g_by = bound_ms(nbytes(x8, st, q_layer, mx, rx, y), 2 * B * K * M, "int8")
        gemm_rows.append(dict(site=site, err=y_err, ms=g_ms, plain_ms=g_plain, bound_ms=g_b,
                              bound_by=g_by, library_ms=lib,
                              shape=f"({B}, {K}) x ({K}, {M}) int8 -> bf16"
                                    + (" relu2" if relu2 else "")))
        lib_s = "n/a" if lib is None else f"{lib:.4f} ms"
        log(f"mm8_a8_gemm {site} B{B} K{K} M{M}{' relu2' if relu2 else ''}: acc exact "
            f"{acc_equal}, y err {y_err:.3e} (tol {y_tol:.3e}); {g_ms:.4f} ms, plain "
            f"{g_plain:.4f} ms, torch._int_mm {lib_s}, bound {g_b:.4f} ms ({g_by})")
        del q, q_layer, acc, acc_ref
    qr = quant_rows_out[0]    # the merged R/K/V quantization
    gr = gemm_rows[-1]        # the head
    return [
        dict(name="mm8_a8_quant_rows", route="cuda", source="chirrup_tpu_torch/csrc/mm8_a8.cu",
             replaces="chirrup_tpu/ops/mm8_pallas.py:639", max_abs_err=qr["err"],
             ms=qr["ms"], plain_ms=qr["plain_ms"], bound_ms=qr["bound_ms"],
             bound_by=qr["bound_by"], library_ms=None, shape=qr["shape"] + " (att R/K/V)",
             tolerance="codes and s exact; sums K*eps32*sum|terms|", sites=quant_rows_out),
        dict(name="mm8_a8_gemm", route="cuda", source="chirrup_tpu_torch/csrc/mm8_a8.cu",
             replaces="chirrup_tpu/ops/mm8_pallas.py:557", max_abs_err=gr["err"],
             ms=gr["ms"], plain_ms=gr["plain_ms"], bound_ms=gr["bound_ms"],
             bound_by=gr["bound_by"], library_ms=gr["library_ms"],
             shape=gr["shape"] + " (head)", tolerance="int32 acc exact; y one bf16 step",
             sites=gemm_rows),
    ]


def check_penalty_tail(dev, gen, V=65536, batches=(64, 512)):
    from chirrup_tpu_torch.ops.sampling_cuda import penalty_tail, penalty_tail_reference

    result = None
    for B in batches:
        u = lambda *s: torch.rand(s, generator=gen, device=dev)
        logits = (torch.randn((B, V), generator=gen, device=dev) * 3).to(torch.bfloat16)
        occ = (u(B, V) < 0.001).float() * u(B, V)
        pres = (u(B, V) < 0.001).float() * 0.5
        decay, freq, pp = 0.99 + 0.01 * u(B), u(B), u(B)
        last = torch.randint(-1, V, (B,), generator=gen, device=dev, dtype=torch.int32)
        dec = u(B) < 0.9
        upd = (u(B) < 0.7) & (last >= 0) & dec
        logits[1, 640 + 3] = logits[1, 640 + 90] = 60.0  # a tie: the lower column wins
        rest = (decay, freq, pp, last, upd, dec)
        ref = penalty_tail_reference(logits, occ, pres, *rest)
        o2, p2 = occ.clone(), pres.clone()
        got = penalty_tail(logits, o2, p2, *rest)
        torch.cuda.synchronize()
        exact = all(torch.equal(g, r) for g, r in zip(got[:4], ref[:4]))
        lse_err = max_abs(got[4], ref[4])
        require(exact and lse_err <= 1e-4 and int(got[3][1, 5]) == 643,
                f"penalty_tail B{B}: occ/pres/cval/cidx exact {exact}, lse err {lse_err}")
        ms = device_ms(lambda: penalty_tail(logits, o2, p2, *rest))
        plain = device_ms(lambda: penalty_tail_reference(logits, occ, pres, *rest), iters=5)
        moved = nbytes(logits, *rest) + 2 * nbytes(occ, pres) + nbytes(*got[2:])
        b, by = bound_ms(moved, 10 * B * V, "fp32")
        log(f"penalty_tail B{B} V{V}: occ/pres/cval/cidx exact {exact}, lse err "
            f"{lse_err:.3e} (tol 1e-4); {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by})")
        if result is None:
            result = dict(name="penalty_tail", route="cuda",
                          source="chirrup_tpu_torch/csrc/penalty_tail.cu",
                          replaces="chirrup_tpu/ops/sampling_pallas.py:124", max_abs_err=lse_err,
                          ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                          shape=f"({B}, {V}) bf16 logits, f32 penalty state",
                          tolerance="occ, pres, cval, cidx exact; lse 1e-4")
    return result


# ------------------------------------------------- small model, end to end

def check_small_model(dev):
    """The decode path on a small INT8 model, kernels against plain versions:
    the same weights and teacher-forced tokens on the GPU and on the CPU."""
    import numpy as np
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
    from chirrup_tpu_torch.models.loader import synthetic_params_int8

    class Greedy:
        temperature, top_p, top_k = 0.0, 0.3, 0
        frequency_penalty, presence_penalty, penalty_decay = 0.5, 0.5, 0.996
        forbidden_tokens = ()

    cfg = RWKV7Config(n_layer=2, n_embd=256, vocab_size=16384)
    B, steps = 8, 6
    for dtype, tol in ((torch.float32, 2e-3), (torch.bfloat16, 3e-2)):
        rt = RuntimeConfig(activation_dtype=dtype, wkv_state_dtype=dtype, quantization="int8")
        params = synthetic_params_int8(cfg, seed=5, dtype=dtype, device=dev)
        models = [ServingModel(cfg, params, rt, B, device=d) for d in (dev, "cpu")]
        carries = [m.init_carry() for m in models]
        for m, c in zip(models, carries):
            for s in range(B):
                m.insert_slot(c, s, None, Greedy)
        toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (steps, B)).astype(np.int32)
        on = np.ones(B, bool)
        worst, flips = 0.0, 0
        for t in range(steps):
            (_, s_gpu, l_gpu), (_, s_cpu, l_cpu) = (
                m.decode_step(c, toks[t], on, on) for m, c in zip(models, carries))
            l_gpu, l_cpu = l_gpu.float().cpu(), l_cpu.float()
            require(bool(torch.isfinite(l_gpu).all()), "small model: non-finite logits")
            scale = float(l_cpu.abs().max())
            err = max_abs(l_gpu, l_cpu)
            worst = max(worst, err / scale)
            require(err <= tol * scale, f"small model {dtype}: logits err {err} > {tol}*{scale}")
            # greedy tokens must agree wherever the reference's top-2 margin
            # exceeds the logits tolerance
            top2 = torch.topk(l_cpu, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * tol * scale
            diff = s_gpu.cpu() != s_cpu
            flips += int(diff.sum())
            require(not bool((diff & clear).any()), f"small model {dtype}: greedy tokens differ")
        log(f"small model L2 C256 V16384 B{B} {dtype}: logits err <= {worst:.3e} of scale "
            f"(tol {tol}), greedy tokens differing on near-ties {flips}/{B * steps}")


# ------------------------------------------------------------- main path

def write_vocab(path: str, size: int = 65536) -> None:
    """A byte-complete vocab of `size` ids: id 0 is implicit, ids 1..256 the
    single bytes, the rest distinct multi-byte ASCII strings."""
    lines = [f"{b + 1} {bytes([b])!r} 1" for b in range(256)]
    for i in range(size - 257):
        tok = str(10 + i).encode()
        lines.append(f"{257 + i} {tok!r} {len(tok)}")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))


def run_engine(dev, profile: bool, B=64, L=32, C=4096, V=65536, n_tok=32, blocks=8):
    from chirrup_tpu_torch.engine.engine import AsyncEngineCore
    from chirrup_tpu_torch.engine.structures import ModelLoadConfig
    from chirrup_tpu_torch.ops import _kernels

    tmp = tempfile.TemporaryDirectory()
    vocab = os.path.join(tmp.name, "vocab.txt")
    write_vocab(vocab, V)
    cfg = ModelLoadConfig(model_path="<synthetic>", vocab_path=vocab, vocab_size=V,
                          quantization="int8", synthetic_config=dict(n_layer=L, n_embd=C,
                                                                     vocab_size=V))
    torch.cuda.reset_peak_memory_stats(dev)

    async def serve():
        engine = AsyncEngineCore()
        t0 = time.perf_counter()
        await engine.init(worker_num=1, model_config=cfg, batch_size=B, load_timeout=600,
                          device=dev)
        log(f"engine: INT8 model (L{L} C{C} V{V}) loaded in "
            f"{time.perf_counter() - t0:.1f} s, batch {B}, decode block "
            f"{engine.workers[0].decode_block_size}")
        model = engine.workers[0].model
        block = engine.workers[0].decode_block_size
        try:
            _kernels.reset_launches()
            t0 = time.perf_counter()
            comps = [engine.completion(f"Request {i}: the port answers", max_tokens=n_tok,
                                       stop_tokens=(), temperature=temp,
                                       presence_penalty=pen, frequency_penalty=pen)
                     for i, (temp, pen) in enumerate([(0.0, 0.0), (0.0, 0.0),
                                                      (1.0, 0.5), (1.0, 0.5)])]
            texts = await asyncio.gather(*[c.get_full_completion() for c in comps])
            wall = time.perf_counter() - t0
            launches = dict(_kernels.LAUNCHES)
        finally:
            engine.shutdown()
            engine.join(timeout=30)
        return model, block, comps, texts, wall, launches

    model, engine_block, comps, texts, wall, launches = asyncio.run(serve())
    peak = torch.cuda.max_memory_allocated(dev)
    n_gen = sum(len(c.task.generated_tokens) for c in comps)
    for i, (c, text) in enumerate(zip(comps, texts)):
        require(c.task.is_finished() and len(c.task.generated_tokens) == n_tok and text,
                f"request {i}: status {c.task.request_status}, "
                f"{len(c.task.generated_tokens)} tokens, text {text!r}")
        log(f"request {i}: {c.task.request_status}, {len(c.task.generated_tokens)} tokens, "
            f"text {text[:48]!r}")
    log(f"engine: 4 requests, {n_gen} tokens in {wall:.3f} s ({n_gen / wall:.1f} tok/s, "
        f"4 of {B} slots busy); launches {launches}; peak memory {peak / 2 ** 30:.2f} GiB")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")

    # steady decode: every slot decoding, K-step blocks on device feedback
    class Sampled:
        temperature, top_p, top_k = 1.0, 0.3, 0
        frequency_penalty, presence_penalty, penalty_decay = 0.5, 0.5, 0.996
        forbidden_tokens = ()

    import numpy as np
    carry = model.init_carry()
    for s in range(B):
        model.insert_slot(carry, s, None, Sampled)
    K = engine_block
    ones = np.ones((K, B), bool)
    first = ones.copy()
    first[0] = False
    tokens = np.full((K, B), 300, np.int32)
    carry, sampled, _ = model.decode_block(carry, tokens, first, ones, ones)
    torch.cuda.synchronize()
    # launches per step, counted over one block; the block must also run
    # without a host synchronisation
    _kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, sampled, _ = model.decode_block(carry, tokens, ones, ones, ones)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    per_step = {name: n / K for name, n in _kernels.LAUNCHES.items()}
    torch.cuda.synchronize()
    log(f"decode_block: no host synchronisation inside a block (sync debug mode 'error'); "
        f"launches per step {per_step}")
    # one WKV step per layer; quant + GEMM for R/K/V, Wo, FFN k and FFN v per
    # layer and for the head; one penalty tail
    expected = {"wkv7_step_fused": L, "mm8_a8_quant_rows": 4 * L + 1,
                "mm8_a8_gemm": 4 * L + 1, "penalty_tail": 1}
    require(per_step == expected, f"launches per step {per_step}, expected {expected}")
    logits = model.decode_step(carry, tokens[0], ones[0], ones[0], ones[0])[2]
    require(tuple(logits.shape) == (B, V) and bool(torch.isfinite(logits).all()),
            "decode logits not finite or of the wrong shape")

    # Steady decode as the worker runs it: one block, then its one host read.
    # Per block: host dispatch (until decode_block returns), the main thread's
    # CPU time within it, and the wall time through the read.
    host_ms, cpu_ms, wall_ms = [], [], []
    load_before = os.getloadavg()
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        carry, sampled, _ = model.decode_block(carry, tokens, ones, ones, ones)
        t1, c1 = time.perf_counter(), time.thread_time()
        sampled.cpu()
        t2 = time.perf_counter()
        host_ms.append((t1 - t0) * 1e3)
        cpu_ms.append((c1 - c0) * 1e3)
        wall_ms.append((t2 - t0) * 1e3)
    load_after = os.getloadavg()
    wall_total = sum(wall_ms) / 1e3
    step_ms = sum(wall_ms) / (blocks * K)
    tok_s = blocks * K * B / wall_total

    def spread(xs):
        return f"median {statistics.median(xs):.1f}, min {min(xs):.1f}, max {max(xs):.1f}"

    log(f"steady decode at batch {B}: {step_ms:.3f} ms per step, {tok_s:.1f} tok/s "
        f"(host clock over {blocks} blocks of {K}); per block: host dispatch ms "
        f"{spread(host_ms)}; main-thread CPU ms {spread(cpu_ms)}; wall ms {spread(wall_ms)}; "
        f"{os.cpu_count()} CPUs, load average {load_before[0]:.2f} -> {load_after[0]:.2f}")

    # device busy time of one more block, from the profiler's kernel records
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        carry, sampled, _ = model.decode_block(carry, tokens, ones, ones, ones)
        sampled.cpu()
    averages = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in averages
                  if e.device_type.name == "CUDA") / 1e3
    busy = busy_ms / K if busy_ms > 0 else None
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
        f.write(averages.table(sort_by="self_cuda_time_total", row_limit=40))
    if busy is None:
        log("device busy per step: not measured (the profiler recorded no device time)")
    else:
        log(f"device busy per step {busy:.3f} ms (profiler, one block of {K}); against the "
            f"steady wall {step_ms:.3f} ms the device is idle "
            f"{100 * (1 - busy / step_ms):.1f}% of the time")
    if profile:
        log(averages.table(sort_by="self_cuda_time_total", row_limit=30))
    return launches, per_step, dict(
        engine_tok_s=n_gen / wall, step_ms=step_ms, decode_tok_s=tok_s, blocks=blocks,
        block_steps=K, host_dispatch_ms=host_ms, host_cpu_ms=cpu_ms, block_wall_ms=wall_ms,
        device_busy_step_ms=busy, load_average=[load_before[0], load_after[0]],
        peak_gib=peak / 2 ** 30)


# ------------------------------------------------------------------- main

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler table of one decode block")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    from chirrup_tpu_torch.ops import _kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    log(smi[0])
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _kernels.build()
    log(f"built {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = [check_wkv(dev, gen), *check_mm8(dev, gen), check_penalty_tail(dev, gen)]
    torch.cuda.empty_cache()
    check_small_model(dev)
    torch.cuda.empty_cache()
    launches, per_step, path = run_engine(dev, args.profile)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_per_step"] = per_step[k["name"]]

    summary = {"kernels": kernels}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi[0], path=path, **summary), f, indent=1)
    log(json.dumps({"kernels": [{k: v for k, v in kern.items() if k != "sites"}
                                for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of chirrup_tpu_torch on one NVIDIA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --compare DIR    # DIR: another checkout (compare_trees):
                                           # the WKV kernels, the quantizer, the tail
                                           # and the engine's step, in turns
    python3 chip_smoke.py --tp 2,4         # one model over 2, then 4 cards by
                                           # tensor parallelism (run_tp_cards)
    python3 chip_smoke.py --multi 2x2      # worker_num 2 x tp 2, and two lockstep
                                           # hosts x tp 2, over 4 cards (run_multi)

Phases, in order; any failure ends the run with a non-zero exit:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from chirrup_tpu_torch/csrc, all nvcc processes at
   once;
3. each kernel at the shapes of the serving path (7.2B: C 4096, H 64, d_ffn
   16384, V 65536) against its plain PyTorch version on the same inputs, with
   its time, its bound, the plain version's time and, where one PyTorch call
   computes the same function, that call's time: the decode kernels at batch
   64 (the WKV step timed with cold state, its launches rotating over the 32
   layers, and warm on one layer; the penalty tail at batch 64 and 512, with
   a tie within a chunk and one across the CTAs of a row), the WKV chunk
   kernel at the prefill variants (P, T) = (8, 64), (8, 256)
   and (32, 64) (against a planted fault that ignores lengths, a second run
   bit-equal, timed with full rows too, and its serial floor: the longest
   row's tokens times one token of the chain), the bare
   WKV kernel at T = 1 (batch 64, timed cold and warm) and at the same
   variants (full rows and ragged; planted faults: lengths ignored, and the
   decay shifted by a token; "highest" bit-equal to "default"; beside its
   bytes bound and the bound of its WY form's TF32 and CUDA-core work), the
   w8a8 mm8 kernels (the quantizer against a planted
   fault, the neighbouring row's codes and stats, with a second run
   bit-equal and its other launches timed; the bare int8 core, int32 out)
   and the w8a16 core, bf16 and float32 activations, at its seven decode
   sites, both on K-major codes and timed with cold weights at decode row
   counts, both at 1 and 37 rows too, all at prefill row counts 512, 2048
   and 1000 as well, then the quantizer's time over a decode step and its
   share of the bytes bound at 2,048 rows; the three WKV kernels again in
   their precision="bf16" instances (the delta form in the bf16 state) at
   the same shapes, with a quarter of the decays near 0 and a planted fault
   of their own, the product form S * bf16(1 + d); the bare kernel again in
   both arithmetics at stress variants of the chunked WY form (decay logits
   of +8 and -8, a_iclr ~ 1, lengths at the 16-token tile's edges, a (2,
   1024) chunk) and on input rows off the 16-byte grid
   (check_wkv_batch_stress), and the WY form with float32 rows and state
   against a float64 recurrence within 1/64 of the per-element limit, which
   one TF32 pass a product breaks (check_wkv_batch_float32); before them, the
   registers and spills (ptxas -v) of both TMA GEMMs, the quantizer, the
   three WKV kernels and the penalty tail, and the GEMMs' wgmma and TMA
   instructions (cuobjdump, where present); then the exact-row sampler
   (sample_exact_rows, check_sample_exact) at batch 64, V 65536 with 0, 1,
   8 and 64 flagged rows against its plain version with handed noise
   (tokens equal but for at most one row a count whose token the kernel's
   exact cumulative sum explains where float32's puts the top-p cutoff on
   another value; such rows are counted), with two planted faults (ties toward the higher id; the
   cutoff value dropped), 4,096 draws of one row from its own generator
   against the analytic distribution, its generator against the plain
   version's Philox, vocabularies of V - 61 and 3 columns, and its time at
   each count (and for one row of each kind) beside its bytes bound and
   the torch path it replaced;
4. the decode path and the compact prefill on a small model, kernels (GPU)
   against plain versions (CPU), and chunked prefill against token-by-token
   feeding on the GPU; the same for the w8a16 configuration (mm8_core
   "pallas"); the unfused TMix (wkv_fn=wkv7_batch), GPU against CPU and
   against the fused kernels; the decode path and the compact prefill again
   with RuntimeConfig(wkv_precision="bf16") on a bf16 state, GPU against
   CPU;
5. the port's AsyncEngineCore at the full width of the 7.2B model (32 layers,
   random INT8 weights from a seed), batch 64, its worker warming up (on the
   card: capturing as CUDA graphs) every serving program before its
   handshake, serving five short requests (four through SEQ_PREFILL, one
   through ONE_PREFILL) and four ~1,024-token prompts, with each request's
   time to first token and every kernel's launch counter read around that
   run; the same requests again on a model with graphs=False (time to first
   token, eager); then on a new carry one decode block replayed under
   torch.cuda.set_sync_debug_mode("error"), with the launches per step
   counted over it; the steady decode rate at batch 64 over 8 blocks, with
   each block's host dispatch, CPU and wall time; the device busy time of
   one block from torch.profiler, with each kernel's ms and launches a step,
   also summed by group (STEP_GROUPS) (its table goes to
   chiprun_out/chip_smoke_profile.txt; --profile prints it as well); one
   profiled block with every row greedy, which must show no (B, V) sort and
   one exact-row launch a step; the same steady decode with graphs=False (3
   blocks, one profiled); and graphs against eager (check_graphs): two
   models on the engine's weights from one random state and seed, bit-equal
   tokens and carry after a greedy 16-step block, a sampled one with
   penalties and flagged rows, decode_step and each prefill variant, two
   consecutive replays drawing different noise, a replay under sync debug
   mode "error" with its launches a step;
6. chunked prefill at 7.2B width on a batch-256 ServingModel sharing the
   engine's weights, both variants (8, 256) and (32, 64), captured as
   graphs: launches per chunk (one chunk under sync debug mode "error"),
   prompt tok/s, host dispatch per chunk and the device busy time per chunk
   by kernel (torch.profiler; table in
   chiprun_out/chip_smoke_prefill_profile.txt), then the same with
   graphs=False (2 chunks each); then the same weights served
   with RuntimeConfig(wkv_precision="bf16") (run_bf16_mode): the first
   decode step against the default mode's from the same state, launches per
   step over one decode block and per chunk at (8, 256) and (32, 64) at batch
   256, and the device busy time and WKV kernels' ms in both modes;
7. the prefix-state cache path on the same weights (run_prefix_cache),
   through AsyncEngineCore with graphs and warmup_programs=True: with a state
   pool (state_pool_size=8, 12 rows), a 1,024-token prompt with
   cache_prefill and padding 3, greedy, 16 tokens, then the same prompt
   resumed from its PoolHandle with the 3-token suffix (tokens equal, both
   times to first token, launch counters set to 0 before the two and read
   after: each kernel of the path launched, no other), then 16 snapshots of
   128-token prompts into a PrefixStateCache while the first row is pinned
   by an in-flight resume (evictions counted, no skip, the pinned row never
   revoked, its resume's tokens equal); with the pool off, the same through
   a host snapshot (extract_slot_async), equal to the pool row bit for bit;
   then on a carry with a random state, pool rows against the carry rows
   (bit-equal), pool_store_many, pool_load and extract_slot_async under sync
   debug mode "error", their host time a call and device time a row against
   the bound, a host snapshot held to the state at its call, its move
   against the card's device-to-host rate, and a wave of 8 admissions
   through insert_slots_batched against insert_slot each;
8. the OpenAI-compatible server on the same weights (run_server): the
   7.2B-width INT8 tree (seed 0) written as a native checkpoint, `python -m
   chirrup_tpu_torch.server --model-path <dir> --profile h100-7b2` spawned
   on the card (seconds to the first /health 200; /v1/models; /metrics
   with the C trie), a non-streamed and a streamed greedy completion equal
   to the in-process engine's tokens, a ~1,024-token conversation resumed
   from its snapshot with one more turn (faster first token, the content of
   the uncached request), 8 identical prompts at once taking one snapshot,
   64 concurrent streamed requests of 128 tokens (tok/s at the client
   against the engine phase's in-process decode), each kernel of the w8a8
   path launched by the server (its /metrics counts, from the end of its
   loading) and no other, SIGINT with exit code 0; then a bf16 `.pth` at
   7.2B widths and 2 layers through build_model_factory on the card and the
   CPU (prepared trees bit-equal, first-step logits within the bf16
   tolerance);
9. path A, the exact w8a16 configuration: phases 5 and 6 again with
   ModelLoadConfig(mm8_core="pallas") after the first engine is freed, at 16
   layers (4 steady blocks with graphs, 2 without; no eager engine run;
   prefill on the batch-64 variant (8, 64)), every int8 product on
   mm8_w16_gemm and none on the w8a8 kernels;
10. path B, the unfused TMix on that model (16 layers): one forward_step at batch 64 and
   one forward_chunk at (8, 256) with wkv_fn=wkv7_batch, every WKV on the bare
   kernel, against the fused kernels from the same state; then both on layer 0
   alone at float32, held per element to the WKV kernels' limit; then the
   same two calls in the bf16 mode (functools.partial(wkv7_batch,
   precision="bf16") against wkv_precision="bf16");
11. tensor parallelism (parallel/tp.py): after phase 8, run_tp1, the engine
   at tensor_parallel=1 over a real one-rank NCCL group with its collectives
   captured in the graphs, against the meshless engine model (greedy
   requests and a greedy block bit-equal, launches a step and a chunk equal,
   ms a step and device busy in turns); after phase 10, check_tp_shards,
   every kernel of the tp path at the shard shapes of tp 2 and 4 (C/tp,
   H/tp, F/tp, V/tp) at batch 64 and at a 512-row prefill chunk against its
   plain version, timed beside its bound and library call; then
   run_tp2_shared_card, tp 2 as two processes on the one card over gloo,
   eager, float32, under both INT8 cores: first-step logits against the
   meshless model's, elapsed, the ranks' carries bit-equal after each
   greedy step, each rank's launches (one card cannot show a tp rate);
12. multi-host and multi-group serving: after run_tp1, run_lockstep, two
   lockstep host processes sharing the card (parallel/dryrun_multihost:
   torchrun's environment, the vote group over gloo on localhost), each its
   own 7.2B-width replica over 64 rows of a global batch of 128 (graphs):
   each host's programs on its rows and its worker's greedy requests (one
   of 1,024 tokens) equal to the engine model's, its launches equal to
   steps x a step's + chunks x a chunk's, a shutdown voted on host 1
   stopping both after the same loop (the vote's host us a loop, the
   quorum's seconds, each host's ms a step while sharing the card), each
   host's HTTP server resuming a prompt from its pool equal to its cold
   run; after run_tp2_shared_card, run_router, two port servers (7.2B
   width, 8 layers) behind `python -m chirrup_tpu_torch.server.router`: a
   burst of 64 streams x 128 tokens through the router beside the same
   burst straight to one server (tok/s at the client both ways, the split,
   time to the first data frame), then a burst during which one backend is
   killed (the later requests all served by the other; /health showing the
   failure); then run_workers_tp_shared_card, worker_num 2 x tp 2 on the
   one card over gloo, eager, float32, depth 8, from a native checkpoint:
   both workers' tokens equal a meshless engine's, each worker's launches
   (its thread's) equal to its steps x a step's + chunks x a chunk's;
13. one JSON line with every kernel's numbers, then the result line.

Without a CUDA device, or without the chirrup_tpu_torch package beside it,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import gc
import itertools
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
# dense, no sparsity; "bf16x2" is packed bf16 outside the tensor cores, two
# operations a lane where float32 does one: twice the float32 rate
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12, "bf16x2": 134e12}
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


# precision="bf16" (the WKV kernels' delta form in the bf16 state): operations
# per state element per token, each a packed bf16 operation or a float32 one
# of the two sums (sa and y: multiply, add; S*d, v*k, sa*b and three adds),
# at the packed bf16 rate
BF16_OPS = 10


BF16_TOLERANCE = ("y per element 2^-7 |ref| + 2^-8 rms(ref); state: at most 1e-3 of the "
                  "elements differ and the difference's norm at most 2^-10 of the state's")


def chain_excess(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The bf16 mode's limit on a state: max(share of the elements that
    differ / 1e-3, ||got - ref|| / ||ref|| / 2^-10), at most 1 within it. The
    kernel and its plain version round the same bf16 operations, but a
    float32 value that is rounded to bf16 (the kk norm, summed in another
    order) may land one bf16 step apart, and the state, rounded every token,
    carries that step on through the chain and spreads it along the row
    through sa: a few elements then differ by a few steps, beyond the
    per-element limit. (On the CPU, the plain version with the norm summed in
    float64 differs from itself so in 4.6e-5 of the elements, by 3.5e-5 of
    the norm, at (32, 64), C 1024; the product-form fault in 0.2 to 0.66, by
    2.9e-3 to 6.2e-3.)"""
    share = float((got != ref).float().mean())
    norm = float((got.double() - ref.double()).norm() / ref.double().norm())
    return max(share / 1e-3, norm / 2.0 ** -10)


def with_slow_decays(w, gen, share=0.25):
    """w (decay logits) with `share` of its elements set to logits in [-9, -5]:
    decays d = exp(-e^-1/2 sigmoid(w)) - 1 of -7.5e-5 to -4e-3, near 0, where
    an update S * bf16(1 + d) would round 1 + d to bf16's steps of 2^-8 below
    1 (the bf16-mode checks' planted fault)."""
    pick = torch.rand(w.shape, generator=gen, device=w.device) < share
    slow = torch.rand(w.shape, generator=gen, device=w.device) * -4.0 - 5.0
    return torch.where(pick, slow.to(w.dtype), w)


def product_form_token(S, d1, r, k, a, b, v):
    """The planted fault of the bf16-mode checks: wkv7_cuda._bf16_token with
    its delta form S + ((S*d + v k^T) + sa b^T) replaced by the product form
    (S * bf16(d1) + v k^T) + sa b^T."""
    bf, f32 = torch.bfloat16, torch.float32
    a_, b_, k_, v_ = (x.to(bf) for x in (a, b, k, v))
    sa = (S * a_[..., None, :]).to(f32).sum(-1)
    y1 = (S * (d1 * r).to(bf)[..., None, :]).to(f32).sum(-1)
    S_new = ((S * d1.to(bf)[..., None, :] + v_[..., :, None] * k_[..., None, :])
             + sa.to(bf)[..., None] * b_[..., None, :])
    y = y1 + v * (r * k).sum(-1, keepdim=True) + sa * (r * b).sum(-1, keepdim=True)
    return y, S_new


@contextlib.contextmanager
def planted_product_form():
    """The WKV plain versions with product_form_token in place of the delta
    form, for the length of the block."""
    from chirrup_tpu_torch.ops import wkv7_cuda

    token = wkv7_cuda._bf16_token
    wkv7_cuda._bf16_token = product_form_token
    try:
        yield
    finally:
        wkv7_cuda._bf16_token = token


def step_inputs(dev, gen, B=64, C=4096, L=32, act=torch.bfloat16, state_dtype=torch.bfloat16):
    """Random step-kernel inputs: a state of L layers, rows and parameters
    (bf16 unless `state_dtype`, `act` say otherwise), dither counters, and
    lengths with every ninth row idle. Returns (state, args) with args in the
    wrappers' order after `layer`."""
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    r, w, k, v = (rnd(B, C).to(act) for _ in range(4))
    a = torch.sigmoid(rnd(B, C)).to(act)
    k_k, k_a, r_k = ((rnd(C) * 0.5 + 1.0).to(act) for _ in range(3))
    ln_w, ln_b = (rnd(C) * 0.1 + 1.0).to(act), (rnd(C) * 0.1).to(act)
    state = (rnd(L, B, 64, C) * 0.3).to(state_dtype)
    elapsed = torch.randint(0, 2 ** 31 - 1, (B,), generator=gen, device=dev,
                            dtype=torch.int64).to(torch.int32)
    lengths = torch.ones(B, dtype=torch.int32, device=dev)
    lengths[::9] = 0
    return state, (r, w, k, a, v, k_k, k_a, r_k, ln_w, ln_b, elapsed, lengths)


def step_ms(state, args, li, **kw):
    """The step kernel's time (device_ms) warm, on layer li every launch, and
    cold, the launches rotating over
    every layer of the stacked state (1 GiB at batch 64, 20x the L2) as a
    decode step walks them: (cold, warm). kw: the wrapper's precision, where
    given."""
    from chirrup_tpu_torch.ops.wkv7_cuda import wkv7_step_fused

    warm = device_ms(lambda: wkv7_step_fused(state, li, *args, **kw))
    layers = itertools.cycle(range(state.shape[0]))
    cold = device_ms(lambda: wkv7_step_fused(state, next(layers), *args, **kw))
    return cold, warm


def check_wkv(dev, gen, B=64, C=4096, L=32, li=17, precision="default"):
    """The kernel against its plain version twice: with the bonus term on
    (r_k random), where (r*k~*r_k)*v dominates |y|; and with r_k = 0, where
    the GroupNorm*ln_w + ln_b branch alone sets y and its limit. In the second,
    the comparison must reject a planted fault: the plain version without ln_b.
    Timed cold and warm (step_ms), beside a torch copy_ of the same state
    bytes, cold; the bound counts the state and the five activation rows and
    dither counter of the rows that are not idle, the only ones the function
    must read (an idle row's block reads its length and writes zeros to y).
    precision "bf16": the kernel's bf16-mode instance on the same draws with
    a quarter of the decays near 0 (with_slow_decays), the bonus on, against
    a planted fault of its own (product_form_token); timed alike, its
    operations counted at the packed bf16 rate (BF16_OPS)."""
    from chirrup_tpu_torch.ops.wkv7_cuda import (step_plan, wkv7_step_fused,
                                                 wkv7_step_fused_reference)

    bf16 = precision == "bf16"
    kw = dict(precision=precision)
    H = C // 64
    state, args = step_inputs(dev, gen, B, C, L)
    if bf16:
        args = (args[0], with_slow_decays(args[1], gen), *args[2:])
    r_k, lengths = args[7], args[11]
    idle = lengths == 0
    no_bonus = (*args[:7], torch.zeros_like(r_k), *args[8:])
    cases = (("bonus on", args),) if bf16 else (("bonus on", args), ("r_k = 0", no_bonus))

    errs = []
    for label, case in cases:
        before = state[li].clone()
        neighbour = state[li - 1].clone()
        y_ref, s_ref = wkv7_step_fused_reference(before, *case, **kw)
        y = wkv7_step_fused(state, li, *case, **kw)
        torch.cuda.synchronize()
        state_excess = chain_excess if bf16 else bf16_excess
        ex_y, ex_s = bf16_excess(y, y_ref), state_excess(state[li], s_ref)
        errs += [max_abs(y, y_ref), max_abs(state[li], s_ref)]
        require(ex_y <= 1 and ex_s <= 1,
                f"wkv7_step_fused {precision} {label}: worst |err|/limit y {ex_y}, "
                f"state {ex_s}")
        require(torch.equal(state[li - 1], neighbour), "wkv7_step_fused touched another layer")
        require(torch.equal(state[li][idle], before[idle]) and bool((y[idle] == 0).all()),
                "wkv7_step_fused: length-0 rows changed")
        if bf16:
            fault = "product form S * bf16(1 + d)"
            with planted_product_form():
                y_fault, s_fault = wkv7_step_fused_reference(before, *case, **kw)
            ex_fault = max(bf16_excess(y_fault, y_ref), chain_excess(s_fault, s_ref))
        else:
            fault = "no ln_b"
            y_fault, _ = wkv7_step_fused_reference(before, *case[:9],
                                                   torch.zeros_like(case[9]), *case[10:])
            ex_fault = bf16_excess(y_fault, y_ref)
        limit = ("y per element 2^-7|ref| + 2^-8 rms(ref), state chain_excess" if bf16
                 else "limit 2^-7|ref| + 2^-8 rms(ref)")
        log(f"wkv7_step_fused {precision} {label}: max |y| "
            f"{float(y_ref.float().abs().max()):.3g}, y err {errs[-2]:.3e}, state err "
            f"{errs[-1]:.3e}; worst |err|/limit y {ex_y:.3f}, state {ex_s:.3f} ({limit}); "
            f"planted fault ({fault}) {ex_fault:.2f}")
        if bf16 or label == "r_k = 0":
            require(ex_fault > 1, f"wkv7_step_fused {precision}: the check passes a kernel "
                                  f"with the fault {fault} (worst |err|/limit {ex_fault})")
    err_y, err_s = max(errs[0::2]), max(errs[1::2])
    ms, warm = step_ms(state, args, li, **kw)
    plain = device_ms(lambda: wkv7_step_fused_reference(state[li], *args, **kw), iters=5)
    active = int((~idle).sum())
    moved = ((2 * nbytes(state[li]) + nbytes(*args[:5], args[10])) * active // B
             + nbytes(*args[5:10], args[11], y))
    b, by = (bound_ms(moved, BF16_OPS * active * 64 * C, "bf16x2") if bf16
             else bound_ms(moved, 9 * active * 64 * C, "fp32"))
    plan = step_plan(B, C)
    out = dict(name="wkv7_step_fused_bf16" if bf16 else "wkv7_step_fused", route="cuda",
               source="chirrup_tpu_torch/csrc/wkv7_step.cu",
               replaces="chirrup_tpu/ops/wkv7_pallas.py:644", precision=precision,
               max_abs_err=max(err_y, err_s), ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
               library_ms=None, warm_ms=warm,
               shape=f"state ({L}, {B}, 64, {C}) bf16, one layer a launch; ms cold (the "
                     f"launches rotate over the {L} layers), warm_ms on one layer",
               tolerance=BF16_TOLERANCE if bf16 else "per element 2^-7 |ref| + 2^-8 "
                                                     "rms(ref), y and state")
    head = (f"wkv7_step_fused {precision} B{B} C{C} H{H} bf16 ({active} rows not idle; "
            f"{plan}): y err {err_y:.3e}, state err {err_s:.3e}; {ms:.4f} ms cold, "
            f"{warm:.4f} ms warm, plain {plain:.4f} ms, bound {b:.4f} ms ({by}; "
            f"{100 * b / ms:.1f}% of it cold)")
    if bf16:
        log(head)
        return out
    # the state bytes of the rows that are not idle, copied between layers
    # in turn (half the stack each side, cold as the kernel's)
    src, dst = state[L // 2:, :active], torch.empty_like(state[:L // 2, :active])
    layers = itertools.cycle(range(L // 2))

    def copy_layer():
        i = next(layers)
        dst[i].copy_(src[i])

    copy = device_ms(copy_layer)
    del dst
    log(f"{head}; torch copy_ of the {active} rows' state between layers, cold, "
        f"{copy:.4f} ms ({2 * nbytes(src[0]) / copy / 1e9:.2f} TB/s; the kernel at "
        f"{100 * copy / ms:.1f}% of its rate)")
    out["copy_ms"] = copy
    return out


def chunk_params(dev, gen, C):
    """The chunk kernel's per-channel parameters k_k, k_a, r_k, ln_w, ln_b
    (C,) bf16."""
    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    k_k, k_a, r_k = ((rnd(C) * 0.5 + 1.0).to(bf) for _ in range(3))
    return k_k, k_a, r_k, (rnd(C) * 0.1 + 1.0).to(bf), (rnd(C) * 0.1).to(bf)


def chunk_inputs(dev, gen, P, T, C, L, params):
    """Random chunk-kernel inputs around `params` (chunk_params): bf16 rows
    with r/k/v views of one merged (P, T, 3C) projection output, a bf16 state
    of L layers, dither counters (the first crossing 2^31 mid-chunk), and
    lengths that include 0, 1, one not a multiple of 8, and T."""
    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    rkv = rnd(P, T, 3 * C).to(bf)
    r, k, v = rkv.split(C, dim=-1)
    w = rnd(P, T, C).to(bf)
    a = torch.sigmoid(rnd(P, T, C)).to(bf)
    state = (rnd(L, P, 64, C) * 0.3).to(bf)
    elapsed = torch.randint(0, 2 ** 31 - 1, (P,), generator=gen, device=dev,
                            dtype=torch.int64).to(torch.int32)
    elapsed[0] = 2 ** 31 - 7                 # the counter crosses 2^31 mid-chunk
    lengths = torch.randint(0, T + 1, (P,), generator=gen, device=dev,
                            dtype=torch.int64).to(torch.int32)
    lengths[:4] = torch.tensor([0, 1, T - 3, T], dtype=torch.int32)[:P]
    return state, (r, w, k, a, v, *params, elapsed, lengths)


def chunk_token_us(dev, C=4096, T=(64, 256)):
    """The time of one token of the chunk kernel's chain: one request (one
    block per head, the card nearly empty), every row full, timed at two
    chunk lengths; the slope between them, in microseconds. Its inputs come
    from a generator of its own, so the checked variants' draws do not
    depend on it."""
    from chirrup_tpu_torch.ops.wkv7_cuda import wkv7_chunk_fused

    gen = torch.Generator(device=dev).manual_seed(1)
    params = chunk_params(dev, gen, C)
    ms = []
    for t in T:
        state, args = chunk_inputs(dev, gen, 1, t, C, 2, params)
        full = (*args[:-1], torch.full_like(args[-1], t))
        ms.append(device_ms(lambda: wkv7_chunk_fused(state, 1, *full)))
    return 1e3 * (ms[1] - ms[0]) / (T[1] - T[0])


def check_chunk(dev, gen, variants=((8, 64), (8, 256), (32, 64)), C=4096, L=32, li=9,
                precision="default"):
    """The chunk kernel against its plain version at each prefill variant, with
    bf16 rows and state (chunk_inputs). The same per-element limit as the
    decode step, on y and on the state; the comparison must reject a planted
    fault: a plain version that ignores lengths. A second run from the same
    state must give the same bits. Timed at its ragged lengths and with full
    rows; beside the bound, the serial floor: the longest row's tokens times
    one token of the chain (chunk_token_us). The first variant is the
    headline of the JSON line. precision "bf16": the kernel's bf16-mode
    instance, a quarter of the decays near 0 (with_slow_decays), against a
    planted fault of its own (product_form_token), its operations counted at
    the packed bf16 rate; no serial floor."""
    from chirrup_tpu_torch.ops import wkv7_cuda
    from chirrup_tpu_torch.ops.wkv7_cuda import wkv7_chunk_fused, wkv7_chunk_fused_reference

    bf16 = precision == "bf16"
    kw = dict(precision=precision)
    params = chunk_params(dev, gen, C)
    sites = []
    for P, T in variants:
        state, args = chunk_inputs(dev, gen, P, T, C, L, params)
        if bf16:
            args = (args[0], with_slow_decays(args[1], gen), *args[2:])
        lengths = args[-1]
        before, neighbour = state[li].clone(), state[li - 1].clone()
        y_ref, s_ref = wkv7_chunk_fused_reference(before, *args, **kw)

        def agrees(y, s_new):
            return bf16_excess(y, y_ref), (chain_excess if bf16 else bf16_excess)(s_new, s_ref)

        y = wkv7_chunk_fused(state, li, *args, **kw)
        torch.cuda.synchronize()
        ex_y, ex_s = agrees(y, state[li])
        err = max(max_abs(y, y_ref), max_abs(state[li], s_ref))
        require(ex_y <= 1 and ex_s <= 1,
                f"wkv7_chunk_fused {precision} P{P} T{T}: worst |err|/limit y {ex_y}, "
                f"state {ex_s}")
        require(torch.equal(state[li - 1], neighbour), "wkv7_chunk_fused touched another layer")
        idle = lengths == 0
        require(torch.equal(state[li][idle], before[idle]),
                "wkv7_chunk_fused: length-0 rows changed")
        past = torch.arange(T, device=dev)[None, :] >= lengths[:, None]
        require(bool((y[past] == 0).all()), "wkv7_chunk_fused: output past a length")
        if bf16:
            fault = "product form S * bf16(1 + d)"
            with planted_product_form():
                y_fault, s_fault = wkv7_chunk_fused_reference(before, *args, **kw)
        else:
            fault = "lengths ignored"
            y_fault, s_fault = wkv7_chunk_fused_reference(before, *args[:-1],
                                                          torch.full_like(lengths, T))
        ex_fault = max(agrees(y_fault, s_fault))
        require(ex_fault > 1, f"wkv7_chunk_fused {precision}: the check passes a kernel with "
                              f"the fault {fault} (worst |err|/limit {ex_fault})")
        s_first = state[li].clone()
        state[li].copy_(before)
        y_again = wkv7_chunk_fused(state, li, *args, **kw)
        require(torch.equal(y_again, y) and torch.equal(state[li], s_first),
                f"wkv7_chunk_fused {precision} P{P} T{T}: a second run differs")
        plan = wkv7_cuda.chunk_plan(P, T, C)
        ms = device_ms(lambda: wkv7_chunk_fused(state, li, *args, **kw))
        full = (*args[:-1], torch.full_like(lengths, T))
        full_ms = device_ms(lambda: wkv7_chunk_fused(state, li, *full, **kw))
        plain = device_ms(lambda: wkv7_chunk_fused_reference(state[li], *args, **kw), iters=1,
                          reps=3)
        # this run's work: the valid tokens, the slabs of rows that have any
        n_tok = int(lengths.sum())
        live = int((lengths > 0).sum())
        moved = (2 * live * 64 * C * state.element_size() + 5 * n_tok * C * 2
                 + nbytes(y, *args[5:]))
        b, by = (bound_ms(moved, BF16_OPS * n_tok * 64 * C, "bf16x2") if bf16
                 else bound_ms(moved, 9 * n_tok * 64 * C, "fp32"))
        sites.append(dict(variant=[P, T], valid_tokens=n_tok, longest=int(lengths.max()),
                          err=err, ex_y=ex_y, ex_s=ex_s, ms=ms, full_rows_ms=full_ms,
                          plain_ms=plain, bound_ms=b, bound_by=by, fault=fault,
                          fault_excess=ex_fault, plan=plan._asdict(),
                          lengths=lengths[:4].tolist()))
        del state, args, before, neighbour, y, y_ref, s_ref, y_fault, s_fault, s_first, y_again
        del full
        torch.cuda.empty_cache()
    token_us = None if bf16 else chunk_token_us(dev, C)
    if token_us is not None:
        log(f"wkv7_chunk_fused: one token of the chain {token_us:.4f} us (one request, full "
            f"rows, slope between T 64 and 256)")
    for x in sites:
        P, T = x["variant"]
        plan = x["plan"]
        x["token_us"] = token_us
        x["serial_floor_ms"] = None if bf16 else x["longest"] * token_us / 1e3
        limit = ("y per element 2^-7|ref| + 2^-8 rms(ref), state chain_excess" if bf16
                 else "limit 2^-7|ref| + 2^-8 rms(ref)")
        floor = ("" if bf16 else f", serial floor {x['serial_floor_ms']:.4f} ms "
                                 f"({x['longest']} tokens)")
        log(f"wkv7_chunk_fused {precision} P{P} T{T} C{C} bf16 ({plan['threads']} threads, "
            f"{plan['rows_per_thread']} state rows a thread, {plan['threads_per_row']} threads "
            f"a row, {plan['tile_tokens']} tokens a tile), {x['valid_tokens']} valid tokens "
            f"(lengths {x['lengths']}...): y/state err {x['err']:.3e}; worst |err|/limit y "
            f"{x['ex_y']:.3f}, state {x['ex_s']:.3f} ({limit}); "
            f"planted fault ({x['fault']}) {x['fault_excess']:.2f}; second run bit-equal; "
            f"{x['ms']:.4f} ms (full rows {x['full_rows_ms']:.4f}), plain {x['plain_ms']:.4f} "
            f"ms, bound {x['bound_ms']:.4f} ms ({x['bound_by']}){floor}")
    head = sites[0]
    return dict(name="wkv7_chunk_fused_bf16" if bf16 else "wkv7_chunk_fused", route="cuda",
                source="chirrup_tpu_torch/csrc/wkv7_chunk.cu", precision=precision,
                replaces="chirrup_tpu/ops/wkv7_pallas.py:714",
                max_abs_err=max(x["err"] for x in sites), ms=head["ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=None, serial_floor_ms=head["serial_floor_ms"],
                shape=f"P{variants[0][0]} T{variants[0][1]} C{C}, state ({L}, P, 64, {C}) bf16, "
                      f"one layer",
                tolerance=BF16_TOLERANCE if bf16 else "per element 2^-7 |ref| + 2^-8 "
                                                      "rms(ref), y and state",
                sites=sites)


MM8_SHAPES = [  # (site, K, M, n variants, quant mode, relu2, stacked)
    ("att R/K/V", 4096, 3 * 4096, 3, "mix", False, True),
    ("att Wo", 4096, 4096, 1, "mul", False, True),
    ("ffn Wk", 4096, 16384, 1, "plain", True, True),
    ("ffn Wv", 16384, 4096, 1, "plain", False, True),
    ("head", 4096, 65536, 1, "plain", False, False),
]


def codes(dev, gen, L, K, M):
    """Random int8 codes, logically (L, K, M) (or (K, M) when L is None),
    stored K-major as mm8.to_k_major stores them: each layer's strides (1, K)."""
    q = torch.randint(-128, 128, (L or 1, M, K), generator=gen, device=dev,
                      dtype=torch.int8).transpose(-1, -2)
    return q if L else q[0]


def cold_layers(K, M, B):
    """Layers of a stacked code tensor for timing: at decode row counts
    enough that the rotation spans >= 160 MiB (3x the 50 MB L2), so every
    launch finds its layer's codes cold, as a decode step does; 2 otherwise."""
    return max(3, -(-(160 << 20) // (K * M))) if B <= 64 else 2


def quant_agrees(x8, st, x8_ref, st_ref, st_tol):
    """(codes max |err|, sums max |err|, whether the quantizer's output
    passes): codes and s equal, each sum within its entry of st_tol."""
    code_err = max_abs(x8, x8_ref)
    st_diff = (st[..., 1:] - st_ref[..., 1:]).abs()
    ok = (code_err == 0 and torch.equal(st[..., 0], st_ref[..., 0])
          and bool((st_diff <= st_tol).all()))
    return code_err, float(st_diff.max()), ok


def check_mm8(dev, gen, B=64, shapes=MM8_SHAPES):
    """The quantizer and the w8a8 GEMM at each site with B rows: codes exact
    and stats within their reordering bound, a planted fault (the
    neighbouring row's codes and stats) rejected, a second run bit-equal, and
    the quantizer's other launches (elements a thread) checked and timed
    beside quant_plan's; the GEMM's int32 accumulators
    bit-equal to the plain version, y within one bf16 step of it (the same
    float operations in the same order: expected 0), mm8_core_a8 exact. The
    codes are K-major; stacked sites read layer 1. Times at decode row counts
    (B <= 64) rotate over the layers of a stacked tensor larger than L2 (cold
    weights), with the layer-1-every-time (warm) figure beside them; the
    head (256 MiB) is cold either way. torch._int_mm runs on the same int8
    operands the same way (with rows padded to 17, its least, when B < 17)."""
    import itertools

    from chirrup_tpu_torch.ops import mm8_cuda

    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda"
           else mm8_cuda.H100_SMS)
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
        # s is one max and one division: exact. The three sums add the same
        # float32 terms in another order: each is within 2*K*eps32*sum|terms|
        xm = x.float()[None]
        if mode == "mix":
            xm = xm + kw["xx"].float()[None] * kw["mu"].float()[:, None]
        elif mode == "mul":
            xm = xm * kw["mul"].float()[None]
        terms = (xm * (ry * 16)[:, None], xm, xm * my[:, None])
        st_tol = torch.stack([2 * K * 2.0 ** -23 * t.abs().sum(-1) for t in terms], -1)
        code_err, st_err, ok = quant_agrees(x8, st, x8_ref, st_ref, st_tol)
        require(ok, f"mm8_a8_quant_rows {site}: codes err {code_err}, stats err {st_err}")
        # the planted fault: the neighbouring row's codes and stats
        fault = quant_agrees(torch.roll(x8_ref, 1, dims=1), torch.roll(st_ref, 1, dims=1),
                             x8_ref, st_ref, st_tol)
        require(B == 1 or not fault[2], f"mm8_a8_quant_rows {site}: the check passes the "
                                        f"neighbouring row's codes and stats")
        x8_again, st_again = mm8_cuda.quant_rows(x, ry, my, **kw)
        require(torch.equal(x8_again, x8) and torch.equal(st_again, st),
                f"mm8_a8_quant_rows {site}: a second run differs")
        st_tol = float(st_tol.max())
        plan = mm8_cuda.quant_plan(n, B, K)
        q_ms = device_ms(lambda: mm8_cuda.quant_rows(x, ry, my, **kw))
        # the other launches the kernel has for this site, each checked and timed
        alt = {}
        for elems in (8, 16, 32):
            try:
                other = mm8_cuda.quant_shape(n, B, K, elems)
            except ValueError:
                continue
            if other == plan:
                continue
            got = mm8_cuda.quant_rows_planned(other, x, ry, my, **kw)
            require(quant_agrees(*got, x8_ref, st_ref, st_tol)[2],
                    f"mm8_a8_quant_rows {site}: launch {other} disagrees")
            alt[f"{elems}e"] = device_ms(
                lambda: mm8_cuda.quant_rows_planned(other, x, ry, my, **kw))
        q_plain = device_ms(lambda: mm8_cuda.quant_rows_reference(x, ry, my, **kw), iters=5)
        aux = [t for t in kw.values()]
        q_b, q_by = bound_ms(nbytes(x, ry, my, *aux, x8, st), 8 * n * B * K, "fp32")
        quant_rows_out.append(dict(site=site, rows=B, err=max(code_err, st_err), ms=q_ms,
                                   plain_ms=q_plain, bound_ms=q_b, bound_by=q_by,
                                   plan=plan._asdict(), alternatives_ms=alt,
                                   shape=f"n {n}, ({B}, {K}) bf16 -> int8"))
        log(f"mm8_a8_quant_rows {site} n{n} B{B} K{K} ({plan.threads} threads x {plan.elems}, "
            f"grid {plan.grid}): codes "
            f"err {code_err}, stats err {st_err:.3e} (tol {st_tol:.3e}); planted fault "
            f"(neighbouring row) {'rejected' if not fault[2] else 'n/a at one row'}; second "
            f"run bit-equal; {q_ms:.4f} ms, bound {q_b:.4f} ms ({q_by}, "
            f"{100 * q_b / q_ms:.1f}% of it); plain {q_plain:.4f} ms; other launches "
            f"(elements e a thread) "
            + (", ".join(f"{k} {v:.4f} ms" for k, v in alt.items()) or "none"))

        L = cold_layers(K, M, B) if stacked else None
        q = codes(dev, gen, L, K, M)
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
                f"mm8_a8_gemm {site} B{B}: acc equal {acc_equal}, y err {y_err} (tol {y_tol})")
        plan = mm8_cuda.gemm_plan(n, B, K, M, q_layer.stride(), sms)
        call = lambda li: mm8_cuda.gemm(x8, st, q, mx, rx, layer=li, relu2=relu2,
                                        out_dtype=out_dtype)
        # the int8 GEMM alone, as cuBLASLt computes it (column-major B: the
        # K-major codes as they are); for the merged R/K/V, one (B, K) x (K,
        # n*C) product: the same operations
        xa = x8[0] if B > 16 else torch.nn.functional.pad(x8[0], (0, 0, 0, 17 - B))
        lib_call = lambda li: torch._int_mm(xa, q[li] if stacked else q)
        g_warm = device_ms(lambda: call(layer))
        lib_warm = device_ms(lambda: lib_call(layer))
        if stacked and B <= 64:
            cyc, cyc_lib = itertools.cycle(range(L)), itertools.cycle(range(L))
            g_ms = device_ms(lambda: call(next(cyc)))
            lib = device_ms(lambda: lib_call(next(cyc_lib)))
        else:
            g_ms, lib = g_warm, lib_warm
        g_plain = device_ms(lambda: mm8_cuda.gemm_reference(x8, st, q_layer, mx, rx,
                                                            relu2=relu2,
                                                            out_dtype=out_dtype), iters=3)
        g_b, g_by = bound_ms(nbytes(x8, st, q_layer, mx, rx, y), 2 * B * K * M, "int8")
        # the bare int8 core (mm8_core_a8: the same kernel, int32 out, one
        # variant), stacked or not as the site is; int32 sums are exact
        core = mm8_cuda.mm8_core_a8(x8[0], q, layer=layer)
        core_equal = torch.equal(core, mm8_cuda.gemm_acc_reference(x8[0], q_layer))
        require(core_equal, f"mm8_core_a8 {site} B{B}: int32 output differs from the plain "
                            f"version")
        c_ms = device_ms(lambda: mm8_cuda.mm8_core_a8(x8[0], q, layer=layer))
        c_plain = device_ms(lambda: mm8_cuda.gemm_acc_reference(x8[0], q_layer), iters=3)
        c_b, c_by = bound_ms(nbytes(x8[0], q_layer, core), 2 * B * K * M, "int8")
        gemm_rows.append(dict(site=site, rows=B, err=y_err, acc_exact=acc_equal, ms=g_ms,
                              plain_ms=g_plain, bound_ms=g_b, bound_by=g_by, library_ms=lib,
                              warm_ms=g_warm, library_warm_ms=lib_warm,
                              cold=bool(stacked and B <= 64) or K * M >= 160 << 20,
                              plan=dict(bm=plan.bm, bn=plan.bn, stages=plan.stages,
                                        split=plan.split, grid=list(plan.grid)),
                              shape=f"({B}, {K}) x ({K}, {M}) int8 -> bf16"
                                    + (" relu2" if relu2 else ""),
                              core_a8=dict(stacked=stacked, exact=core_equal, ms=c_ms,
                                           plain_ms=c_plain, bound_ms=c_b, bound_by=c_by)))
        temp = "cold" if gemm_rows[-1]["cold"] else "warm"
        log(f"mm8_a8_gemm {site} B{B} K{K} M{M}{' relu2' if relu2 else ''} (tile {plan.bm}x"
            f"{plan.bn}, {plan.stages} stages, split {plan.split}, grid {plan.grid}): acc exact "
            f"{acc_equal}, y max diff {y_err:.3e} (tol {y_tol:.3e}); {temp} {g_ms:.4f} ms, "
            f"torch._int_mm {lib:.4f} ms ({g_ms / lib:.2f}x), bound {g_b:.4f} ms ({g_by}, "
            f"{100 * g_b / g_ms:.1f}% of it); warm {g_warm:.4f} ms, torch._int_mm warm "
            f"{lib_warm:.4f} ms; plain {g_plain:.4f} ms; mm8_core_a8 "
            f"({'stacked' if stacked else 'unstacked'}) int32 exact {core_equal}, "
            f"{c_ms:.4f} ms, plain {c_plain:.4f} ms, bound {c_b:.4f} ms ({c_by})")
        del q, q_layer, acc, acc_ref, core, xa
        torch.cuda.empty_cache()
    qr = quant_rows_out[0]    # the merged R/K/V quantization
    gr = gemm_rows[-1]        # the last site: the head on the decode path
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


# the TMA + wgmma GEMMs: source -> the SASS mnemonic of its wgmma (integer
# for the w8a8 GEMM, floating point for the w8a16 one)
GEMM_SOURCES = {"mm8_a8": "IGMMA", "mm8_w16": "HGMMA"}
# the sources whose registers and spills the run reports (ptxas -v): the
# GEMMs (mm8_a8 holds the quantizer too), the three WKV kernels and the
# penalty tail
PTXAS_SOURCES = (*GEMM_SOURCES, "wkv7_chunk", "wkv7_step", "wkv7_batch", "penalty_tail",
                 "sample_exact")


def _tile_name(fn):
    """'gemm 128x128, 4 stages, 1 CTA/SM' from a kernel's mangled name (its
    Tile<BM, BN, STAGES, MIN_CTAS> argument), or None."""
    import re

    tile = re.search(r"TileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)", fn)
    return "gemm %sx%s, %s stages, %s CTA/SM" % tile.groups() if tile else None


def _kernel_name(fn):
    """A readable name for a kernel's mangled name: the GEMM tiles
    (_tile_name), the quantizer's <dtype, elements a thread, mode>, the WKV
    kernels' <activation dtype, state dtype, precision bf16>, the tail's
    <logits dtype, vector loads>."""
    import re

    name = _tile_name(fn)
    if name:
        return name
    dt = lambda t: "bf16" if "bfloat16" in t or re.fullmatch(r"S\d*_", t) else "fp32"
    m = re.search(r"quant_rows_kernelI(\w+?)Li(\d+)ELi(\d)EE", fn)
    if m:
        return f"quant_rows {dt(m.group(1))} E{m.group(2)} mode {m.group(3)}"
    m = re.search(r"(wkv7_chunk|wkv7_step|batch_rows)(?:_fused)?_kernelI(13__nv_bfloat16|f)"
                  r"(13__nv_bfloat16|S\d*_|f)Lb([01])E", fn)
    if m:
        return (f"{m.group(1)[5:] if m.group(1)[:4] == 'wkv7' else m.group(1)} "
                f"{dt(m.group(2))} state {dt(m.group(3))}"
                + (" precision bf16" if m.group(4) == "1" else ""))
    m = re.search(r"batch_wy_kernelI(13__nv_bfloat16|f)(13__nv_bfloat16|S\d*_|f)E", fn)
    if m:
        return f"batch_wy {dt(m.group(1))} state {dt(m.group(2))}"
    m = re.search(r"batch_tokens_bf16_kernelI(13__nv_bfloat16|f)E", fn)
    if m:
        return f"batch_tokens {dt(m.group(1))} state bf16, precision bf16"
    m = re.search(r"penalty_tail_kernelI(13__nv_bfloat16|f)Lb([01])E", fn)
    if m:
        return f"tail {dt(m.group(1))} logits, vector loads {m.group(2)}"
    return next((k for k in ("w16_f32",) if k in fn), fn)


def start_ptxas(source, out_dir):
    """A -cubin build of csrc/<source>.cu with -Xptxas -v, started beside the
    main build: its registers and spills."""
    from chirrup_tpu_torch.ops import _kernels

    return subprocess.Popen(
        [_kernels._nvcc(), *(f for f in _kernels.NVCC_FLAGS
                             if f not in ("-shared", "-Xcompiler", "-fPIC")),
         "-cubin", "-Xptxas", "-v", "-o", os.path.join(out_dir, f"{source}.cubin"),
         str(_kernels.CSRC / f"{source}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def sass_report(source, lib_path, ptxas_proc):
    """What a source compiled to: ptxas's registers and spills for each of
    its kernels (start_ptxas), and, for a GEMM source where the toolkit has
    cuobjdump, the count of wgmma (GEMM_SOURCES[source]) and UTMALDG (TMA
    load) instructions in each TMA GEMM kernel of the built library. Fails if
    the build failed or a TMA GEMM kernel has no wgmma."""
    import re
    import shutil

    out = {}
    log_text, _ = ptxas_proc.communicate()
    require(ptxas_proc.returncode == 0, f"ptxas -v build of {source}.cu failed:\n{log_text}")
    for fn, body in re.findall(r"Compiling entry function '([^']+)'.*?\n(.*?)"
                               r"(?=Compiling entry function|\Z)", log_text, re.S):
        used = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        out[_kernel_name(fn)] = dict(registers=int(used.group(1)) if used else None,
                         spill_bytes=[int(spill.group(1)), int(spill.group(2))] if spill
                         else None)
    log(f"ptxas -v, csrc/{source}.cu: " + "; ".join(
        f"{k}: {v['registers']} registers, spill stores/loads {v['spill_bytes']} bytes"
        for k, v in out.items()))
    if source not in GEMM_SOURCES:
        return out
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        log("cuobjdump not found: SASS instruction counts not taken")
        return out
    mma = GEMM_SOURCES[source]
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts = {}
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)", sass, re.S):
        name = _tile_name(fn)
        if name:
            counts[name] = {mma: len(re.findall(rf"\b{mma}", body)),
                            "UTMALDG": len(re.findall(r"\bUTMALDG", body))}
    log(f"SASS of {os.path.basename(str(lib_path))}, per TMA GEMM kernel: {counts}")
    require(counts and all(c[mma] > 0 for c in counts.values()),
            f"a {source} GEMM kernel compiled without {mma} (wgmma): {counts}")
    out["sass"] = counts
    return out


W16_SITES = [  # (site, K, M, stacked): the seven int8 products of a w8a16 decode step
    ("att R", 4096, 4096, True), ("att K", 4096, 4096, True), ("att V", 4096, 4096, True),
    ("att Wo", 4096, 4096, True), ("ffn Wk", 4096, 16384, True),
    ("ffn Wv", 16384, 4096, True), ("head", 4096, 65536, False),
]
# at prefill row counts: one site per shape (R, K, V and Wo share theirs)
W16_PREFILL_SITES = [("att R/K/V/Wo", 4096, 4096, True)] + W16_SITES[4:6]


def sum_excess(got, ref, sq_terms, K, c):
    """Largest |got - ref| / limit over the elements of a K-term float32 sum,
    where limit = c * 2^-24 * sqrt(K) * ||terms||_2 and sq_terms holds each
    element's sum of squared terms. A float32 sum of K random-signed terms
    errs by ~0.4 * 2^-24 * sqrt(K) * ||terms||_2 (one standard deviation);
    TF32 inputs would err by ~0.6 * 2^-11 * ||terms||_2, and a wrong tile by
    ~||terms||_2."""
    limit = c * 2.0 ** -24 * K ** 0.5 * sq_terms.double().sqrt() + 1e-30
    return float(((got.double() - ref.double()).abs() / limit).max())


def check_w16(dev, gen, B=64, sites=W16_SITES):
    """The w8a16 core (mm8_core_w16: xs @ q, float32 out) against its plain
    version (a float32 product of the widened operands; TF32 is off) at each
    site, with bf16 xs (the serving dtype) and float32 xs. The codes are
    K-major, as codes() builds them; stacked sites read layer 1. The limit
    is sum_excess's with c = 8 for float32 xs (~20 standard deviations of the
    two float32 sums) and c = 64 for bf16 xs (room for the tensor cores'
    own accumulation order). The comparison must reject two planted faults:
    the codes 32 columns on, and (float32 xs) TF32-rounded activations.
    Times at decode row counts (B <= 64) rotate over the layers of a stacked
    tensor larger than L2 (cold weights), with the layer-1-every-time (warm)
    figure beside them, and torch.matmul (xs times the codes converted to
    xs's dtype beforehand, K-major as they are) is timed the same way; the
    head is cold either way. The head site, bf16, is the JSON line's
    headline."""
    import itertools

    from chirrup_tpu_torch.ops import mm8_cuda

    sms = (torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda"
           else mm8_cuda.H100_SMS)
    rows = []
    for site, K, M, stacked in sites:
        L = cold_layers(K, M, B) if stacked else None
        q = codes(dev, gen, L, K, M)
        layer = 1 if stacked else None
        q_layer = q[layer] if stacked else q
        q_sq = q_layer.float().square()
        plan = mm8_cuda.w16_plan(B, K, M, q_layer.stride(), sms)
        cold = stacked and B <= 64
        for dtype, c in ((torch.bfloat16, 64), (torch.float32, 8)):
            xs = torch.randn((B, K), generator=gen, device=dev).to(dtype)
            got = mm8_cuda.mm8_core_w16(xs, q, layer=layer)
            ref = mm8_cuda.core_w16_reference(xs, q_layer)
            sq = torch.matmul(xs.float().square(), q_sq)
            torch.cuda.synchronize()
            require(tuple(got.shape) == (B, M) and got.dtype == torch.float32,
                    f"mm8_w16_gemm {site}: output {tuple(got.shape)} {got.dtype}")
            again = mm8_cuda.mm8_core_w16(xs, q, layer=layer)
            require(torch.equal(again, got), f"mm8_w16_gemm {site}: a second run differs")
            ex = sum_excess(got, ref, sq, K, c)
            faults = {"neighbour columns": mm8_cuda.core_w16_reference(
                xs, torch.roll(q_layer, 32, dims=1))}
            if dtype == torch.float32:
                tf32 = (xs.view(torch.int32) & ~0x1FFF).view(torch.float32)
                faults["TF32 xs"] = mm8_cuda.core_w16_reference(tf32, q_layer)
            fault_ex = {k: sum_excess(f, ref, sq, K, c) for k, f in faults.items()}
            err = max_abs(got, ref)
            name = "bf16" if dtype == torch.bfloat16 else "fp32"
            require(ex <= 1, f"mm8_w16_gemm {site} B{B} {name} xs: worst |err|/limit {ex}")
            require(min(fault_ex.values()) > 1,
                    f"mm8_w16_gemm {site} {name}: the check passes a planted fault {fault_ex}")
            plain = device_ms(lambda: mm8_cuda.core_w16_reference(xs, q_layer), iters=3)
            q_conv = q.to(dtype)  # every layer, K-major as the codes are
            call = lambda li: mm8_cuda.mm8_core_w16(xs, q, layer=li)
            lib_call = lambda li: torch.matmul(xs, q_conv if li is None else q_conv[li])
            warm = device_ms(lambda: call(layer))
            lib_warm = device_ms(lambda: lib_call(layer))
            if cold:
                cyc, cyc_lib = itertools.cycle(range(L)), itertools.cycle(range(L))
                ms = device_ms(lambda: call(next(cyc)))
                lib = device_ms(lambda: lib_call(next(cyc_lib)))
            else:
                ms, lib = warm, lib_warm
            b, by = bound_ms(nbytes(xs, q_layer, got), 2 * B * K * M, name)
            rows.append(dict(site=site, rows=B, xs=name, err=err, excess=ex,
                             fault_excess=fault_ex, ms=ms, plain_ms=plain, bound_ms=b,
                             bound_by=by, library_ms=lib, warm_ms=warm, library_warm_ms=lib_warm,
                             cold=cold or K * M >= 160 << 20,
                             plan=dict(bm=plan.bm, bn=plan.bn, stages=plan.stages,
                                       split=plan.split, grid=list(plan.grid)),
                             shape=f"({B}, {K}) {name} x ({K}, {M}) int8 -> f32"
                                   + (" (stacked)" if stacked else "")))
            temp = "cold" if rows[-1]["cold"] else "warm"
            log(f"mm8_w16_gemm {site} B{B} K{K} M{M} {name} xs (tile {plan.bm}x{plan.bn}, "
                f"{plan.stages} stages, split {plan.split}, grid {plan.grid}): err {err:.3e}, "
                f"worst |err|/limit {ex:.3f} (c {c}); planted faults "
                + ", ".join(f"{k} {v:.3g}" for k, v in fault_ex.items())
                + f"; {temp} {ms:.4f} ms, torch.matmul {name} {lib:.4f} ms ({ms / lib:.2f}x), "
                  f"bound {b:.4f} ms ({by}, {100 * b / ms:.1f}% of it); warm {warm:.4f} ms, "
                  f"torch.matmul warm {lib_warm:.4f} ms; plain {plain:.4f} ms")
            del xs, got, again, ref, sq, faults, q_conv
        del q, q_layer, q_sq
        torch.cuda.empty_cache()
    head = [r for r in rows if r["xs"] == "bf16"][-1]
    return dict(name="mm8_w16_gemm", route="cuda", source="chirrup_tpu_torch/csrc/mm8_w16.cu",
                replaces="chirrup_tpu/ops/mm8_pallas.py:122", max_abs_err=head["err"],
                ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                shape=head["shape"] + f" ({head['site']})",
                tolerance="per element c * 2^-24 * sqrt(K) * ||terms||_2, c 64 bf16 / 8 fp32",
                sites=rows)


# The bare kernel's WY form (T > 1, float32 state math; csrc/wkv7_batch.cu)
# per (request, head) tile of WT = 16 tokens, from its products' shapes:
# TF32 multiply-adds of one pass, 4 WT x WT x 64 (the four WT x WT
# matrices), 2 x 64 x 64 x WT (S0 A~^T, S0 R~^T), 3 x 64 x WT x WT (V M_ak^T,
# V M_rk^T, SA M_rb^T) and 2 x 64 x WT x 64 (V K^, SA B^); three passes each
# (hi*hi, hi*lo, lo*hi), two where v, bf16, is exact in TF32 (V M_ak^T,
# V M_rk^T, V K^); and its CUDA-core operations: 13 a token and column in
# the prep (the decay, g, A~, R~, K^, B^), the substitution's 2 x 64 x WT
# (WT - 1) / 2 and the 64 x 64 scaling by g_n.
WY_TILE = 16
WY_MACS = dict(p1=4 * 16 * 16 * 64, s0=2 * 64 * 64 * 16, vm=2 * 64 * 16 * 16, sam=64 * 16 * 16,
               vk=64 * 16 * 64, sab=64 * 16 * 64)
WY_CORE_OPS = 13 * 16 * 64 + 64 * 16 * 15 + 64 * 64
PEAK_TF32 = 495e12


def wy_work(lengths, T, C):
    """(TF32 tensor operations, CUDA-core operations) the WY form does on
    bf16 rows for these lengths: every tile a row's tokens reach, at every
    head."""
    tiles = int(((lengths.clamp(0, T) + WY_TILE - 1) // WY_TILE).sum()) * (C // 64)
    m = WY_MACS
    exact = m["vm"] + m["vk"]
    passes = 3 * (sum(m.values()) - exact) + 2 * exact
    return 2 * passes * tiles, WY_CORE_OPS * tiles


def batch_bounds(state_l, y, elapsed, lengths, P, T, C, valid, bf16, wy=False):
    """The bare kernel's bounds on one call: bytes (the live rows' state
    slabs once each way, the valid tokens' six input rows, y, the counters),
    the recurrence's operations (9 float32 a state element a token; the bf16
    mode's BF16_OPS at the packed bf16 rate), and where the WY form runs
    (wy) its own work: tensor operations at 495 TFLOP/s and CUDA-core
    operations at 67. Returns (bound ms, bound_by, extras dict)."""
    live = int((lengths > 0).sum())
    moved = 2 * live * 64 * C * state_l.element_size() + 6 * valid * C * 2 + nbytes(
        y, elapsed, lengths)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    bnd, by = (bound_ms(moved, BF16_OPS * valid * 64 * C, "bf16x2") if bf16
               else bound_ms(moved, 9 * valid * 64 * C, "fp32"))
    extra = dict(bytes_ms=t_bytes)
    if wy:
        tensor, core = wy_work(lengths, T, C)
        extra.update(design_tensor_ms=tensor / PEAK_TF32 * 1e3,
                     design_core_ms=core / PEAK_OPS_PER_S["fp32"] * 1e3)
    return bnd, by, extra


def batch_faults(before, args, lengths, T, kw, bf16):
    """The planted faults the bare kernel's check must reject, as (name,
    y, state) of the plain version: lengths ignored (float32 arithmetics) or
    the product form (bf16), and, where T > 1, the decay shifted by one
    token (w rolled along T)."""
    from chirrup_tpu_torch.ops.wkv7_cuda import wkv7_batch_reference

    out = []
    if bf16:
        with planted_product_form():
            out.append(("product form S * bf16(1 + d)",
                        *wkv7_batch_reference(before, *args, lengths, **kw)))
    else:
        out.append(("lengths ignored",
                    *wkv7_batch_reference(before, *args, torch.full_like(lengths, T))))
    if T > 1:
        r, w, *rest = args
        out.append(("decay shifted by a token",
                    *wkv7_batch_reference(before, r, w.roll(1, dims=1), *rest, lengths, **kw)))
    return out


def hold_batch(tag, state, li, before, neighbour, y, y_ref, s_ref, lengths, faults, bf16):
    """The bare kernel's result against its plain version: y per element
    (bf16_excess), the state per element or, in the bf16 mode, by
    chain_excess; the neighbouring layer and the length-0 rows untouched, y
    0 past each length; every planted fault rejected (excess > 1). Returns
    (worst y excess, worst state excess, max |err|, {fault: excess})."""
    P, T = y.shape[:2]
    require(y.dtype == torch.bfloat16 and tuple(y.shape) == (P, T, state.shape[-1]),
            f"{tag}: y {y.dtype} {tuple(y.shape)}")
    state_excess = chain_excess if bf16 else bf16_excess
    ex_y, ex_s = bf16_excess(y, y_ref), state_excess(state[li], s_ref)
    err = max(max_abs(y, y_ref), max_abs(state[li], s_ref))
    require(ex_y <= 1 and ex_s <= 1, f"{tag}: worst |err|/limit y {ex_y}, state {ex_s}")
    require(torch.equal(state[li - 1], neighbour), f"{tag}: another layer touched")
    idle = lengths == 0
    require(torch.equal(state[li][idle], before[idle]), f"{tag}: length-0 rows changed")
    past = torch.arange(T, device=y.device)[None, :] >= lengths[:, None]
    require(bool((y[past] == 0).all()), f"{tag}: output past a length")
    rejected = {}
    for name, y_f, s_f in faults:
        rejected[name] = max(bf16_excess(y_f, y_ref), state_excess(s_f, s_ref))
        require(rejected[name] > 1, f"{tag}: the check passes a kernel with the fault {name} "
                                    f"(worst |err|/limit {rejected[name]})")
    return ex_y, ex_s, err, rejected


def check_wkv_batch(dev, gen, variants=((64, 1), (8, 64), (8, 256), (32, 64)), C=4096,
                    L=32, li=5, precision="default"):
    """The bare WKV kernel against its plain version at the decode step (T = 1,
    batch 64) and at each prefill variant, bf16 rows and state, r/k/v as views
    of one merged (P, T, 3C) projection output, a = -kk and b = kk*iclr from
    a per-head unit kk, lengths that include 0, 1, T-3 and T, and a dither
    counter that crosses 2^31 mid-chunk (hold_batch: the WKV chunk kernel's
    per-element limit on y and state, planted faults rejected: batch_faults).
    Timed at T = 1 cold (the launches rotating over the L layers) and warm,
    at T > 1 with every row full (as path B runs) and on the variant's own
    lengths, each beside its bounds (batch_bounds) and, full rows, the plain
    version's time. Under "default", "highest" (batch_plan's same launch)
    runs once on the same inputs and must give the same bits, y and state.
    The first variant is the JSON headline (ms cold). precision "bf16": the
    kernel's bf16-mode instance, a quarter of the decays near 0
    (with_slow_decays), against a planted fault of its own
    (product_form_token), its operations counted at the packed bf16 rate."""
    from chirrup_tpu_torch.ops.wkv7_cuda import batch_plan, wkv7_batch, wkv7_batch_reference

    bf16 = precision == "bf16"
    kw = dict(precision=precision)
    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    sites = []
    for P, T in variants:
        rkv = rnd(P, T, 3 * C).to(bf)
        r, k, v = rkv.split(C, dim=-1)
        w = rnd(P, T, C).to(bf)
        kk = torch.nn.functional.normalize(rnd(P, T, C // 64, 64), dim=-1).reshape(P, T, C)
        a, b = (-kk).to(bf), (kk * torch.sigmoid(rnd(P, T, C))).to(bf)
        state = (rnd(L, P, 64, C) * 0.3).to(bf)
        elapsed = torch.randint(0, 2 ** 31 - 1, (P,), generator=gen, device=dev,
                                dtype=torch.int64).to(torch.int32)
        elapsed[0] = 2 ** 31 - 7
        lengths = torch.randint(0, T + 1, (P,), generator=gen, device=dev,
                                dtype=torch.int64).to(torch.int32)
        lengths[:4] = torch.tensor([0, 1, max(T - 3, 0), T], dtype=torch.int32)
        if bf16:
            w = with_slow_decays(w, gen)
        args = (r, w, k, v, a, b, elapsed)
        before, neighbour = state[li].clone(), state[li - 1].clone()
        y_ref, s_ref = wkv7_batch_reference(before, *args, lengths, **kw)
        y = wkv7_batch(state, *args, lengths, li, **kw)
        torch.cuda.synchronize()
        tag = f"wkv7_batch {precision} P{P} T{T}"
        ex_y, ex_s, err, rejected = hold_batch(tag, state, li, before, neighbour, y, y_ref, s_ref,
                                               lengths, batch_faults(before, args, lengths, T,
                                                                     kw, bf16), bf16)
        if precision == "default":  # "highest" takes the same launch: the same bits
            hi = state.clone()
            hi[li] = before
            y_hi = wkv7_batch(hi, *args, lengths, li, precision="highest")
            require(torch.equal(y_hi, y) and torch.equal(hi, state),
                    f"{tag}: \"highest\" differs from \"default\"")
            del hi, y_hi
        full = torch.full_like(lengths, T)   # with every row full, as path B runs
        plan = batch_plan(P, T, C, "bf16" if bf16 else precision)
        site = dict(variant=[P, T], plan=plan.path, err=err, excess_y=ex_y, excess_state=ex_s,
                    faults=rejected, valid_tokens=int(lengths.clamp(0, T).sum()))
        if T == 1:
            layers = itertools.cycle(range(L))
            site["ms"] = device_ms(lambda: wkv7_batch(state, *args, full, next(layers), **kw))
            site["warm_ms"] = device_ms(lambda: wkv7_batch(state, *args, full, li, **kw))
            timed = f"{site['ms']:.4f} ms cold, {site['warm_ms']:.4f} warm"
        else:
            site["ms"] = device_ms(lambda: wkv7_batch(state, *args, full, li, **kw))
            site["ragged_ms"] = device_ms(lambda: wkv7_batch(state, *args, lengths, li, **kw))
            timed = f"full rows {site['ms']:.4f} ms, ragged {site['ragged_ms']:.4f}"
        site["plain_ms"] = device_ms(lambda: wkv7_batch_reference(state[li], *args, full, **kw),
                                     iters=1, reps=3)
        wy = plan.path == "wy"
        site["bound_ms"], site["bound_by"], extra = batch_bounds(
            state[li], y, elapsed, full, P, T, C, P * T, bf16, wy)
        site.update(extra)
        bounds = (f"recurrence bound {site['bound_ms']:.4f} ms ({site['bound_by']}), bytes "
                  f"{extra['bytes_ms']:.4f}")
        if wy:
            bounds += (f", the WY form's work {extra['design_tensor_ms']:.4f} (TF32 at 495 "
                       f"TFLOP/s) / {extra['design_core_ms']:.4f} (CUDA cores)")
            site["ragged_bounds"] = batch_bounds(state[li], y, elapsed, lengths, P, T, C,
                                                 site["valid_tokens"], bf16, wy)[2]
        log(f"{tag} C{C} bf16 ({plan.path}; lengths {lengths[:4].tolist()}...): y/state err "
            f"{err:.3e}; worst |err|/limit y {ex_y:.3f}, state {ex_s:.3f} ("
            f"{'state chain_excess' if bf16 else 'limit 2^-7|ref| + 2^-8 rms(ref)'}"
            f"{'; highest bit-equal' if precision == 'default' else ''}); planted "
            f"faults " + ", ".join(f"({n}) {x:.2f}" for n, x in rejected.items())
            + f"; {timed}, plain {site['plain_ms']:.4f} ms; {bounds}")
        sites.append(site)
        del rkv, r, k, v, w, a, b, kk, state, before, neighbour, y, y_ref, s_ref
        torch.cuda.empty_cache()
    head = sites[0]
    return dict(name="wkv7_batch_bf16" if bf16 else "wkv7_batch", route="cuda",
                source="chirrup_tpu_torch/csrc/wkv7_batch.cu", precision=precision,
                replaces="chirrup_tpu/ops/wkv7_pallas.py:863",
                max_abs_err=max(x["err"] for x in sites), ms=head["ms"],
                warm_ms=head.get("warm_ms"), plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=None,
                shape=f"P{variants[0][0]} T{variants[0][1]} C{C}, state ({L}, P, 64, {C}) bf16, "
                      f"one layer a launch; ms cold (rotating over the layers), warm_ms on one",
                tolerance=BF16_TOLERANCE if bf16 else "per element 2^-7 |ref| + 2^-8 "
                                                      "rms(ref), y and state",
                sites=sites)


def check_wkv_batch_stress(dev, precision, C=4096, L=4, li=2, n=WY_TILE):
    """The bare kernel where the chunked WY form is weakest, from a generator
    of its own (seed 13), bf16 rows and state: a quarter of the columns with
    w_raw = +8 (d1 ~ 0.545, a 16-token tile's g down to 6e-5) and a quarter
    with -8 (d1 ~ 1), a_iclr ~ 1 on every other row (b = kk (1 - 2^-10)),
    lengths 0, 1, n - 1, n, n + 1, T - 3 and T (n the tile), and a long
    variant (2, 1024) that carries the state through 64 tiles; then two
    variants whose six input rows sit one element off the 16-byte grid, in
    base and token stride (the kernel stages them by element loads, not by
    TMA or cp.async): (4, 40), tiles cut mid-way, and (8, 1). Held as
    check_wkv_batch holds its variants (hold_batch, batch_faults). Returns
    each variant's worst excesses, the faults' and, for the long variant, its
    time with every row full."""
    from chirrup_tpu_torch.ops.wkv7_cuda import wkv7_batch, wkv7_batch_reference

    bf16 = precision == "bf16"
    kw = dict(precision=precision)
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(13)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    out = []
    for P, T, lens, unaligned in ((8, 64, [0, 1, n - 1, n, n + 1, 61, 64, 40], False),
                                  (8, 256, [0, 1, n - 1, n, n + 1, 253, 256, 150], False),
                                  (2, 1024, [1024, 1021], False), (4, 40, [0, n + 1, 37, 40], True),
                                  (8, 1, [0, 1, 1, 0, 1, 1, 1, 1], True)):
        rkv = rnd(P, T, 3 * C).to(bf)
        r, k, v = rkv.split(C, dim=-1)
        w = rnd(P, T, C)
        cols = torch.randperm(C, generator=gen, device=dev)
        w[..., cols[:C // 4]] = 8.0
        w[..., cols[C // 4:C // 2]] = -8.0
        w = w.to(bf)
        kk = torch.nn.functional.normalize(rnd(P, T, C // 64, 64), dim=-1).reshape(P, T, C)
        iclr = torch.sigmoid(rnd(P, T, C))
        iclr[1::2] = 1.0 - 2.0 ** -10
        a, b = (-kk).to(bf), (kk * iclr).to(bf)
        if unaligned:  # views one element into a (P, T, 6 C + 1) buffer
            buf = torch.empty(P, T, 6 * C + 1, dtype=bf, device=dev)
            views = [buf[..., 1 + q * C:1 + (q + 1) * C] for q in range(6)]
            for view, x in zip(views, (r, w, k, v, a, b)):
                view.copy_(x)
            r, w, k, v, a, b = views
        state = (rnd(L, P, 64, C) * 0.3).to(bf)
        elapsed = torch.randint(0, 2 ** 31 - 1, (P,), generator=gen, device=dev,
                                dtype=torch.int64).to(torch.int32)
        elapsed[0] = 2 ** 31 - 9
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (r, w, k, v, a, b, elapsed)
        before, neighbour = state[li].clone(), state[li - 1].clone()
        y_ref, s_ref = wkv7_batch_reference(before, *args, lengths, **kw)
        y = wkv7_batch(state, *args, lengths, li, **kw)
        torch.cuda.synchronize()
        tag = (f"wkv7_batch stress {precision} P{P} T{T}"
               + (" unaligned rows" if unaligned else ""))
        ex_y, ex_s, err, rejected = hold_batch(tag, state, li, before, neighbour, y, y_ref, s_ref,
                                               lengths, batch_faults(before, args, lengths, T,
                                                                     kw, bf16), bf16)
        site = dict(variant=[P, T], lengths=lens, unaligned=unaligned, err=err, excess_y=ex_y,
                    excess_state=ex_s, faults=rejected)
        if T >= 1024:
            full = torch.full_like(lengths, T)
            site["ms"] = device_ms(lambda: wkv7_batch(state, *args, full, li, **kw))
        log(f"{tag} C{C} bf16 (decay logits +8 and -8 on a quarter of the columns each, "
            f"a_iclr ~ 1 on odd rows, lengths {lens}): y/state err {err:.3e}; worst |err|/limit "
            f"y {ex_y:.3f}, state {ex_s:.3f}; planted faults "
            + ", ".join(f"({nm}) {x:.2f}" for nm, x in rejected.items())
            + (f"; full rows {site['ms']:.4f} ms" if "ms" in site else ""))
        out.append(site)
        del rkv, r, k, v, w, a, b, kk, iclr, state, before, neighbour, y, y_ref, s_ref, args
        torch.cuda.empty_cache()
    return out


# the float32 check's limit: the per-element limit times F32_SCALE
F32_SCALE = 2.0 ** -6


def sequential64(state_l, r, w, k, v, a, b, elapsed, lengths):
    """The bare recurrence token by token in float64, its decays d1 = 1 +
    decay_from_raw in float32 as the kernels compute them: y_t = S_t r_t,
    and past a row's length y = 0 and the state kept. Returns y (B, T, C)
    and the new slab, float64."""
    from chirrup_tpu_torch.ops.wkv7 import decay_from_raw

    B, T, C = r.shape
    H, f64 = C // 64, torch.float64
    heads = lambda x: x.to(f64).reshape(B, T, H, 64)
    rs, ks, vs, as_, bs = (heads(x) for x in (r, k, v, a, b))
    steps = (elapsed.to(torch.int64)[:, None, None, None]
             + torch.arange(T, device=r.device)[None, :, None, None])
    d1 = (1.0 + decay_from_raw(w.reshape(B, T, H, 64), steps)).to(f64)
    S = state_l.to(f64).reshape(B, 64, H, 64).permute(0, 2, 1, 3)  # (B, H, i, j)
    ys = []
    for t in range(T):
        act = (t < lengths).reshape(B, 1, 1)
        sa = torch.einsum("bhij,bhj->bhi", S, as_[:, t])
        new = (S * d1[:, t, :, None, :] + vs[:, t, :, :, None] * ks[:, t, :, None, :]
               + sa[..., None] * bs[:, t, :, None, :])
        S = torch.where(act[..., None], new, S)
        ys.append(torch.where(act, torch.einsum("bhij,bhj->bhi", S, rs[:, t]), 0.0))
    return torch.stack(ys, dim=1).reshape(B, T, C), S.permute(0, 2, 1, 3).reshape(B, 64, C)


def check_wkv_batch_float32(dev, C=4096, L=3, li=1, n=WY_TILE):
    """The WY form's arithmetic at a resolution bf16 hides: float32 rows and
    state, from a generator of their own (seed 14), at (8, 64), (8, 256),
    (32, 64) and (2, 1024), a quarter of the decay logits +8 and a quarter
    -8, a_iclr ~ 1 on every other row, ragged lengths at the tile's edges.
    The kernel ("default") against the float64 recurrence (sequential64),
    y and state per element within F32_SCALE (1/64) of the per-element
    limit; the same form with one TF32 pass a product
    (wkv7_batch_chunked_reference, rounding "tf32"), the planted fault, must
    break that limit (excess > 1), and so must the float32 plain version
    with the decay shifted by a token. Returns each variant's excesses."""
    from chirrup_tpu_torch.ops.wkv7_cuda import (wkv7_batch, wkv7_batch_chunked_reference,
                                                 wkv7_batch_reference)

    gen = torch.Generator(device=dev).manual_seed(14)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    excess = lambda got, ref: bf16_excess(got, ref) / F32_SCALE
    out = []
    for P, T in ((8, 64), (8, 256), (32, 64), (2, 1024)):
        rkv = rnd(P, T, 3 * C)
        r, k, v = rkv.split(C, dim=-1)
        w = rnd(P, T, C)
        cols = torch.randperm(C, generator=gen, device=dev)
        w[..., cols[:C // 4]] = 8.0
        w[..., cols[C // 4:C // 2]] = -8.0
        kk = torch.nn.functional.normalize(rnd(P, T, C // 64, 64), dim=-1).reshape(P, T, C)
        iclr = torch.sigmoid(rnd(P, T, C))
        iclr[1::2] = 1.0 - 2.0 ** -10
        a, b = -kk, kk * iclr
        state = rnd(L, P, 64, C) * 0.3
        elapsed = torch.randint(0, 2 ** 31 - 1, (P,), generator=gen, device=dev,
                                dtype=torch.int64).to(torch.int32)
        elapsed[0] = 2 ** 31 - 9
        lengths = torch.full((P,), T, dtype=torch.int32, device=dev)
        lengths[1:4] = torch.tensor([n + 1, T - 3, n - 1], dtype=torch.int32, device=dev)[:P - 1]
        args = (r, w, k, v, a, b, elapsed)
        before = state[li].clone()
        y_ref, s_ref = sequential64(before, *args, lengths)
        y = wkv7_batch(state, *args, lengths, li)
        torch.cuda.synchronize()
        tag = f"wkv7_batch float32 P{P} T{T}"
        ex_y, ex_s = excess(y, y_ref), excess(state[li], s_ref)
        require(ex_y <= 1 and ex_s <= 1, f"{tag}: worst |err|/(limit/64) y {ex_y}, state {ex_s}")
        faults = {"one TF32 pass": wkv7_batch_chunked_reference(before, *args, lengths, tile=n,
                                                                rounding="tf32"),
                  "decay shifted by a token": wkv7_batch_reference(
                      before, r, w.roll(1, dims=1), *args[2:], lengths)}
        rejected = {}
        for name, (y_f, s_f) in faults.items():
            rejected[name] = max(excess(y_f, y_ref), excess(s_f, s_ref))
            require(rejected[name] > 1, f"{tag}: the float32 check passes the fault {name} "
                                        f"(worst |err|/(limit/64) {rejected[name]})")
        log(f"{tag} C{C} (decay logits +8 and -8, a_iclr ~ 1 on odd rows, lengths "
            f"{lengths[:4].tolist()}...): against float64, worst |err|/(limit/64) y {ex_y:.3f}, "
            f"state {ex_s:.3f}; planted faults "
            + ", ".join(f"({nm}) {x:.2f}" for nm, x in rejected.items()))
        out.append(dict(variant=[P, T], excess_y=ex_y, excess_state=ex_s, faults=rejected,
                        limit_scale=F32_SCALE))
        del rkv, r, k, v, w, kk, iclr, a, b, state, before, y, y_ref, s_ref, faults, args
        torch.cuda.empty_cache()
    return out


def tail_inputs(dev, gen, B, V=65536):
    """Random penalty-tail inputs: bf16 logits with a tie planted at columns
    643 and 730 of row 1 (one chunk; batches above 1), sparse occurrence and presence, ~90%
    decaying rows and ~63% with a sample to record. Returns (logits, occ,
    pres, rest) with rest in the wrappers' order."""
    u = lambda *s: torch.rand(s, generator=gen, device=dev)
    logits = (torch.randn((B, V), generator=gen, device=dev) * 3).to(torch.bfloat16)
    occ = (u(B, V) < 0.001).float() * u(B, V)
    pres = (u(B, V) < 0.001).float() * 0.5
    decay, freq, pp = 0.99 + 0.01 * u(B), u(B), u(B)
    last = torch.randint(-1, V, (B,), generator=gen, device=dev, dtype=torch.int32)
    dec = u(B) < 0.9
    upd = (u(B) < 0.7) & (last >= 0) & dec
    if B > 1:
        logits[1, 640 + 3] = logits[1, 640 + 90] = 60.0  # a tie: the lower column wins
    return logits, occ, pres, (decay, freq, pp, last, upd, dec)


# the batches at which every split of a row is timed: one request, a few,
# the engine's default 32, chip_smoke's 64, and the prefill batches
TAIL_SWEEP = (1, 8, 32, 64, 128, 256, 512)


def tail_splits_ms(dev, gen, V=65536, batches=TAIL_SWEEP, splits=(1, 2, 4, 8)):
    """The tail at each split of a row over a cluster (tail_shape) at each
    batch, each launch checked against the plain version (occ, pres, cval,
    cidx bit-equal, lse within 1e-4): {B: {split: ms}}."""
    from chirrup_tpu_torch.ops.sampling_cuda import (penalty_tail_planned,
                                                     penalty_tail_reference, tail_plan,
                                                     tail_shape)

    out = {}
    for B in batches:
        logits, occ, pres, rest = tail_inputs(dev, gen, B, V)
        ref = penalty_tail_reference(logits, occ, pres, *rest)
        out[B] = {}
        for split in splits:
            plan = tail_shape(B, V, split)
            o2, p2 = occ.clone(), pres.clone()
            got = penalty_tail_planned(plan, logits, o2, p2, *rest)
            torch.cuda.synchronize()
            exact = all(torch.equal(g, r) for g, r in zip(got[:4], ref[:4]))
            require(exact and max_abs(got[4], ref[4]) <= 1e-4,
                    f"penalty_tail B{B} at {split} CTAs a row disagrees with its plain version")
            out[B][split] = device_ms(lambda: penalty_tail_planned(plan, logits, o2, p2, *rest))
        log(f"penalty_tail B{B} V{V} by CTAs a row: "
            + ", ".join(f"{k} {ms:.4f} ms" for k, ms in out[B].items())
            + f" (tail_plan: {tail_plan(B, V).split})")
        del logits, occ, pres, rest, ref
    torch.cuda.empty_cache()
    return out


def check_penalty_tail(dev, gen, V=65536, batches=(64, 512)):
    """The tail against its plain version at each batch: occ, pres, cval and
    cidx bit-equal, lse within 1e-4, the tie within a chunk (row 1) resolved
    to its lower column, and a tie planted across the first and the last CTA
    of row 2 resolved to the lower column by the sampler's greedy path. The
    bound counts what the function must move with this run's data: logits,
    occ and pres read, occ written on decaying rows, pres at each hit
    column, and cval, cidx and lse. Then every split of a row, timed at the
    batches of TAIL_SWEEP (tail_splits_ms)."""
    from chirrup_tpu_torch.ops.sampling_cuda import (penalty_tail, penalty_tail_reference,
                                                     tail_plan)

    result = None
    for B in batches:
        logits, occ, pres, rest = tail_inputs(dev, gen, B, V)
        plan = tail_plan(B, V)
        far = V - 1 - 60  # in the last CTA's chunks when the row is split
        logits[2, 100] = logits[2, far] = 70.0
        occ[2, [100, far]] = 0.0
        pres[2, [100, far]] = 0.0
        rest[3][2], rest[4][2] = -1, False
        ref = penalty_tail_reference(logits, occ, pres, *rest)
        o2, p2 = occ.clone(), pres.clone()
        got = penalty_tail(logits, o2, p2, *rest)
        torch.cuda.synchronize()
        exact = all(torch.equal(g, r) for g, r in zip(got[:4], ref[:4]))
        lse_err = max_abs(got[4], ref[4])
        greedy = int(got[3][2, torch.argmax(got[2][2])])
        require(exact and lse_err <= 1e-4 and int(got[3][1, 5]) == 643 and greedy == 100,
                f"penalty_tail B{B}: occ/pres/cval/cidx exact {exact}, lse err {lse_err}, "
                f"tie in a chunk -> {int(got[3][1, 5])} (643), across CTAs -> {greedy} (100)")
        ms = device_ms(lambda: penalty_tail(logits, o2, p2, *rest))
        plain = device_ms(lambda: penalty_tail_reference(logits, occ, pres, *rest), iters=5)
        decay_rows, hits = int(rest[5].sum()), int(rest[4].sum())
        moved = (nbytes(logits, *rest) + nbytes(occ, pres) + 4 * V * decay_rows + 4 * hits
                 + nbytes(*got[2:]))
        b, by = bound_ms(moved, 10 * B * V, "fp32")
        log(f"penalty_tail B{B} V{V} ({plan}): occ/pres/cval/cidx exact {exact}, lse err "
            f"{lse_err:.3e} (tol 1e-4), ties -> 643 and {greedy}; {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b:.4f} ms ({by}; {decay_rows} of {B} rows decay; "
            f"{100 * b / ms:.1f}% of it)")
        site = dict(batch=B, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, split=plan.split)
        if result is None:
            result = dict(name="penalty_tail", route="cuda",
                          source="chirrup_tpu_torch/csrc/penalty_tail.cu",
                          replaces="chirrup_tpu/ops/sampling_pallas.py:124", max_abs_err=lse_err,
                          ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
                          shape=f"({B}, {V}) bf16 logits, f32 penalty state",
                          tolerance="occ, pres, cval, cidx exact; lse 1e-4", sites=[])
        result["sites"].append(site)
        result["max_abs_err"] = max(result["max_abs_err"], lse_err)
        del logits, occ, pres, rest, ref, o2, p2, got
    result["splits_ms"] = tail_splits_ms(dev, gen, V)
    return result


# ------------------------------------------------- the exact-row sampler

def exact_draw(adj, temperature, top_p, top_k, gumbel, fault=None, lse=None):
    """The rwkv-pip exact draw (ops.sampling.sample_logits_rwkv_pip_compatible)
    written out again with a planted fault: "ties_high" breaks ties of the
    stable order toward the higher token id, "cutoff_excluded" drops the
    values equal to the top-p cutoff. With `lse` (n,), the kernel's
    arithmetic instead of float32's: p = exp(adj - lse), and the cumulative
    sum in float64 (the kernel's 2^-48 fixed-point sum is exact to ~1e-10).
    Rows (n, V) float32; (n,) tokens."""
    n, V = adj.shape
    if fault == "ties_high":  # the rows reversed: a stable order then favours high ids
        flipped = exact_draw(adj.flip(1), temperature, top_p, top_k, gumbel.flip(1))
        return (V - 1 - flipped).to(torch.int32)
    t = temperature.reshape(n, 1).float()
    p_ = top_p.reshape(n, 1).float()
    zero = t == 0
    t = torch.where(zero, 1.0, t)
    p_ = torch.where(zero, 0.0, p_)
    if lse is None:
        probs = torch.softmax(adj.float(), dim=-1)
    else:
        probs = torch.exp(adj.float() - lse.reshape(n, 1))
    sp, si = torch.sort(probs, dim=-1, descending=True, stable=True)
    cum = torch.cumsum(sp if lse is None else sp.double(), dim=-1)
    pos = (cum < p_.to(cum.dtype)).sum(-1, keepdim=True).clamp(0, V - 1)
    cut = torch.gather(sp, 1, pos)
    drop = probs <= cut if fault == "cutoff_excluded" else probs < cut
    probs = torch.where(drop, 0.0, probs)
    k = top_k.reshape(n, 1).long()
    ranks = torch.arange(V, device=adj.device)[None, :]
    outside = torch.zeros_like(probs, dtype=torch.bool)
    outside.scatter_(1, si, ranks >= torch.where(k > 0, k, V))
    probs = torch.where(outside, 0.0, probs)
    logp = torch.where(probs > 0, torch.log(probs) / t, -float("inf"))
    return torch.argmax(logp + gumbel, dim=-1).to(torch.int32)


def cutoff_kept(adj, lse, temperature, top_p):
    """How many values each row keeps at its top-p cutoff, (n,) twice: by
    the plain version's arithmetic (softmax, float32 cumulative sum) and by
    the kernel's (exp(adj - lse), the sum in float64). Rows (n, V)."""
    n, V = adj.shape
    p_ = torch.where(temperature.reshape(n, 1) == 0, 0.0, top_p.reshape(n, 1).float())
    kept = []
    for probs, dtype in ((torch.softmax(adj.float(), -1), torch.float32),
                         (torch.exp(adj.float() - lse.reshape(n, 1)), torch.float64)):
        sp = torch.sort(probs, dim=-1, descending=True).values
        cum = torch.cumsum(sp.to(dtype), dim=-1)
        pos = (cum < p_.to(dtype)).sum(-1, keepdim=True).clamp(0, V - 1)
        kept.append((probs >= torch.gather(sp, 1, pos)).sum(-1))
    return kept


def rounding_excused(rows, got, adj, lse, temperature, top_p, top_k, gumbel):
    """Of the rows where the kernel's token differs from the plain
    version's, those that float rounding of the top-p cutoff explains: the
    float32 and the float64 cumulative sums keep a different number of
    values (the cutoff falls on another value; on a row of equal values it
    never does), and the draw by the kernel's arithmetic (exact_draw with
    lse) gives the kernel's token."""
    if not rows:
        return []
    r = torch.tensor(rows, device=adj.device)
    kept32, kept64 = cutoff_kept(adj[r], lse[r], temperature[r], top_p[r])
    exact_sum = exact_draw(adj[r], temperature[r], top_p[r], top_k[r], gumbel[r], lse=lse[r])
    ok = (kept32 != kept64) & (exact_sum == got[r])
    return [row for row, o in zip(rows, ok.tolist()) if o]


def exact_rows_inputs(dev, gen, B=64, V=65536):
    """Rows for the exact-row kernel, five kinds in turn: (a) near-flat bf16
    logits (many exact ties) with top_p 1 and temperature 2; (b) exactly
    flat logits with top_k 200 (above the candidate sampler's k_max 128: the
    first 200 ids are kept); (c) randn * 3 with top_p 0.9, temperature 0.8,
    top_k 300; (d) randn * 2 with top_p 0.5 (a cutoff mid-row); (e)
    temperature 0 with top_k 1,000 and a tied maximum at columns 777 and
    40,000. Sparse penalties on every row. Returns (logits, pres2, occ2,
    freq, lse, temperature, top_p, top_k)."""
    u = lambda *s: torch.rand(s, generator=gen, device=dev)
    z = torch.randn((B, V), generator=gen, device=dev)
    kind = torch.arange(B, device=dev) % 5
    scale = torch.tensor([0.01, 0.0, 3.0, 2.0, 3.0], device=dev)[kind]
    logits = (z * scale[:, None]).to(torch.bfloat16)
    pres = (u(B, V) < 0.001).float() * 0.5
    occ = (u(B, V) < 0.001).float() * u(B, V)
    freq = u(B) * (kind != 1)
    flat = kind == 1
    pres[flat], occ[flat] = 0.0, 0.0
    tied = torch.nonzero(kind == 4).reshape(-1)
    cols = torch.tensor([777, 40000 % V], device=dev)
    logits[tied[:, None], cols] = 40.0
    pres[tied[:, None], cols] = occ[tied[:, None], cols] = 0.0
    temperature = torch.tensor([2.0, 1.5, 0.8, 1.0, 0.0], device=dev)[kind]
    top_p = torch.tensor([1.0, 1.0, 0.9, 0.5, 0.3], device=dev)[kind]
    top_k = torch.tensor([0, 200, 300, 0, 1000], device=dev, dtype=torch.int32)[kind]
    adj = logits.float() - pres - occ * freq[:, None]
    lse = torch.logsumexp(adj, dim=-1)
    return logits, pres, occ, freq, lse, temperature, top_p, top_k


def flagged_mask(B, n, dev):
    """n flagged rows spread over the batch (every row at n = B)."""
    need = torch.zeros(B, dtype=torch.bool, device=dev)
    if n:
        need[torch.linspace(0, B - 1, n, device=dev).round().long()] = True
    return need


def exact_rows_distribution(dev, V=65536, draws=4096, batch=512):
    """`draws` draws of one row from the kernel's own generator (seeds
    mode), at V columns: 64 distinct values (randn * 2) at spread columns, -30
    elsewhere, in bf16. For each case the frequency of every token lies
    within 0.03 of the analytic filtered distribution (float64, the rwkv-pip
    rule) and no draw falls outside its support (the rule of
    tests/test_torch_sampling.py's distribution test). Returns the worst
    frequency error by case."""
    from chirrup_tpu_torch.ops.sampling_cuda import sample_exact_rows

    g = torch.Generator(device=dev).manual_seed(21)
    row = torch.full((V,), -30.0, device=dev)
    cols = torch.arange(64, device=dev) * (V // 64)
    row[cols] = torch.randn(64, generator=g, device=dev) * 2
    row = row.to(torch.bfloat16)
    out = {}
    for temp, top_p, top_k in ((1.5, 1.0, 10), (1.0, 0.9, 0), (0.7, 0.6, 5)):
        x = row.double()
        p = torch.softmax(x, 0)
        sp, si = torch.sort(p, descending=True, stable=True)
        pos = min(int((torch.cumsum(sp, 0) < top_p).sum()), V - 1)
        p = torch.where(p < sp[pos], 0.0, p)
        if top_k:
            p[si[top_k:]] = 0.0
        p = p ** (1 / temp)
        expected = p / p.sum()
        counts = torch.zeros(V, dtype=torch.float64, device=dev)
        zero = torch.zeros((batch, V), device=dev)
        for i in range(draws // batch):
            tokens = torch.full((batch,), -1, dtype=torch.int32, device=dev)
            seeds = torch.randint(0, 2 ** 62, (batch,), generator=g, device=dev)
            sample_exact_rows(
                tokens, torch.ones(batch, dtype=torch.bool, device=dev),
                row[None].expand(batch, V).contiguous(), zero, zero,
                torch.zeros(batch, device=dev), torch.logsumexp(row.float(), 0).expand(batch).contiguous(),
                torch.full((batch,), temp, device=dev), torch.full((batch,), top_p, device=dev),
                torch.full((batch,), top_k, dtype=torch.int32, device=dev), seeds=seeds)
            counts += torch.bincount(tokens.long(), minlength=V).double()
        freq = counts / draws
        err = float((freq - expected).abs().max())
        outside = int(((freq > 0) & (expected == 0)).sum())
        log(f"sample_exact_rows, the kernel's own noise: {draws} draws of one row (V {V}, "
            f"temperature {temp}, top_p {top_p}, top_k {top_k}): worst frequency error {err:.4f} "
            f"(tol 0.03), {outside} tokens drawn outside the support")
        require(err < 0.03 and outside == 0,
                f"sample_exact_rows: in-kernel noise off the distribution ({err}, {outside})")
        out[f"T{temp}_p{top_p}_k{top_k}"] = err
    return out


def check_sample_exact(dev, gen, B=64, V=65536, counts=(0, 1, 8, 64)):
    """The exact-row kernel against its plain version at batch B, V columns
    (exact_rows_inputs), at each number of flagged rows: with handed noise
    the tokens of flagged rows equal the plain version's, except at most
    one row a count that rounding of the top-p cutoff explains
    (rounding_excused; counted and reported); rows not flagged keep their
    token, and max_abs_err is the largest |token - plain token| over every
    row and count. Two planted
    faults (exact_draw: ties toward the higher id; the cutoff value
    dropped) must each disagree with the kernel on rows where the plain
    version agrees. Then the draws of the kernel's own generator against
    the analytic distribution (exact_rows_distribution), the kernel's own
    noise against the plain version's Philox (at least 95% of the rows draw
    the same token), vocabularies of V - 61 and 3 columns, and each count
    timed in the serving mode (seeds) beside its bytes bound, the plain
    version, and the torch path the kernel replaced (library_ms: the exact
    draw on every row, a (B, V) sort, kept where flagged), and one flagged
    row of each kind alone."""
    from chirrup_tpu_torch.ops.sampling import gumbel_like, sample_logits_rwkv_pip_compatible
    from chirrup_tpu_torch.ops.sampling_cuda import (sample_exact_rows,
                                                     sample_exact_rows_reference)

    logits, pres, occ, freq, lse, temp, top_p, top_k = exact_rows_inputs(dev, gen, B, V)
    gumbel = -torch.log(torch.empty((B, V), device=dev).exponential_(generator=gen))
    adj = logits.float() - pres - occ * freq[:, None]
    marker = torch.full((B,), -7, dtype=torch.int32, device=dev)
    args = (logits, pres, occ, freq, lse, temp, top_p, top_k)
    sites, excused_rows, err = [], 0, 0
    for n in counts:
        need = flagged_mask(B, n, dev)
        got = sample_exact_rows(marker.clone(), need, *args, gumbel=gumbel)
        want = sample_exact_rows_reference(marker.clone(), need, *args, gumbel=gumbel)
        torch.cuda.synchronize()
        rows = torch.nonzero(got != want).reshape(-1).tolist()
        excused = rounding_excused([r for r in rows if bool(need[r])], got, adj, lse, temp,
                                   top_p, top_k, gumbel)
        require(set(rows) == set(excused) and len(excused) <= 1,
                f"sample_exact_rows, {n} flagged: tokens differ from the plain version at rows "
                f"{rows} (of which rounding of the top-p cutoff explains {excused}; at most "
                f"one a count may differ)")
        require(bool((got[~need] == -7).all()), "sample_exact_rows wrote a row not flagged")
        excused_rows += len(excused)
        err = max(err, int((got.long() - want.long()).abs().max()))
        seeds = torch.randint(0, 2 ** 62, (B,), generator=gen, device=dev)
        toks = marker.clone()
        ms = device_ms(lambda: sample_exact_rows(toks, need, *args, seeds=seeds))
        plain = device_ms(lambda: sample_exact_rows_reference(toks, need, *args, seeds=seeds),
                          iters=2, reps=3) if n else device_ms(
            lambda: sample_exact_rows_reference(toks, need, *args, seeds=seeds))

        def replaced():
            exact = sample_logits_rwkv_pip_compatible(
                logits.float() - pres - occ * freq[:, None], temp, top_p, top_k,
                gumbel=gumbel_like(adj, gen))
            return torch.where(need, exact, toks)

        library = device_ms(replaced, iters=5)
        moved = n * V * (logits.element_size() + 8) + nbytes(need) + 4 * n * 5
        b, by = bound_ms(moved, 0, "fp32")
        log(f"sample_exact_rows B{B} V{V}, {n} flagged: tokens equal the plain version's "
            f"but on {len(rows)} rows, {len(excused)} of them explained by rounding of the "
            f"top-p cutoff; {ms:.4f} ms (seeds), "
            f"bound {b:.4f} ms ({by}), plain {plain:.4f} ms, the replaced torch path "
            f"{library:.4f} ms")
        sites.append(dict(flagged=n, ms=ms, bound_ms=b, bound_by=by, plain_ms=plain,
                          library_ms=library, rows_differing=len(rows),
                          rounding_excused_rows=len(excused)))
    # the kernel's own noise against the plain version's Philox (numpy): the
    # same generator, so nearly every row draws the same token (logf and
    # numpy's log may round a score one step apart)
    need = flagged_mask(B, B, dev)
    seeds = torch.randint(0, 2 ** 62, (B,), generator=gen, device=dev)
    same = int((sample_exact_rows(marker.clone(), need, *args, seeds=seeds)
                == sample_exact_rows_reference(marker.clone(), need, *args, seeds=seeds)).sum())
    require(same >= 0.95 * B, f"sample_exact_rows: in-kernel noise draws the plain version's "
                              f"token on {same} of {B} rows")
    # a vocabulary that is no multiple of the slices or of 4, and a tiny one
    for b_odd, v_odd in ((5, V - 61), (3, 3)):
        odd = exact_rows_inputs(dev, gen, b_odd, v_odd)
        g_odd = -torch.log(torch.empty((b_odd, v_odd), device=dev).exponential_(generator=gen))
        all_rows = torch.ones(b_odd, dtype=torch.bool, device=dev)
        t_odd = torch.full((b_odd,), -7, dtype=torch.int32, device=dev)
        got = sample_exact_rows(t_odd.clone(), all_rows, *odd, gumbel=g_odd)
        want = sample_exact_rows_reference(t_odd.clone(), all_rows, *odd, gumbel=g_odd)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"sample_exact_rows B{b_odd} V{v_odd}: tokens "
                                        f"{got.tolist()}, plain {want.tolist()}")
    log(f"sample_exact_rows: in-kernel noise draws the plain version's token (its Philox in "
        f"numpy) on {same} of {B} rows; handed noise equal at B5 V{V - 61} and B3 V3")
    # one flagged row of each kind (exact_rows_inputs): the time a row takes
    seeds = torch.randint(0, 2 ** 62, (B,), generator=gen, device=dev)
    toks = marker.clone()
    by_kind = {}
    for kind in range(5):
        need = torch.zeros(B, dtype=torch.bool, device=dev)
        need[kind] = True
        by_kind["abcde"[kind]] = device_ms(lambda: sample_exact_rows(toks, need, *args,
                                                                     seeds=seeds))
    log("sample_exact_rows, one flagged row of each kind (exact_rows_inputs): "
        + ", ".join(f"({k}) {ms:.4f} ms" for k, ms in by_kind.items()))
    # planted faults, on every row
    need = flagged_mask(B, B, dev)
    got = sample_exact_rows(marker.clone(), need, *args, gumbel=gumbel)
    plain = exact_draw(adj, temp, top_p, top_k, gumbel)
    faults = {}
    for fault in ("ties_high", "cutoff_excluded"):
        bad = exact_draw(adj, temp, top_p, top_k, gumbel, fault=fault)
        caught = int(((bad != got) & (plain == got)).sum())
        faults[fault] = caught
        require(caught >= 4, f"sample_exact_rows: the planted fault {fault} disagrees with the "
                             f"kernel on only {caught} rows")
    log(f"sample_exact_rows: planted faults rejected (rows where the fault disagrees and the "
        f"plain version agrees: {faults}); {excused_rows} rows over all counts explained by "
        f"rounding of the top-p cutoff; largest |token - plain token| {err}")
    dist = exact_rows_distribution(dev, V)
    top = sites[-1]
    return dict(name="sample_exact_rows", route="cuda",
                source="chirrup_tpu_torch/csrc/sample_exact.cu",
                replaces="chirrup_tpu/ops/sampling_pallas.py:282", max_abs_err=err,
                ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=top["library_ms"],
                shape=f"({B}, {V}) bf16 logits, {top['flagged']} flagged rows",
                tolerance="tokens equal, except at most one row a count that rounding of the "
                          "top-p cutoff explains (max_abs_err in token ids)",
                rounding_excused_rows=excused_rows, planted_faults=faults,
                distribution_err=dist, one_row_ms_by_kind=by_kind,
                philox_rows_equal=same, sites=sites)


# ------------------------------------------------- small model, end to end

def check_small_model(dev, wkv_precision="default"):
    """The decode path on a small INT8 model, kernels against plain versions:
    the same weights and teacher-forced tokens on the GPU and on the CPU.
    wkv_precision "bf16" runs the bf16 configuration alone (a bf16 state;
    on a float32 one the mode is the default) with the bf16 tolerance."""
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
    runs = ((torch.float32, 2e-3), (torch.bfloat16, 3e-2))
    for dtype, tol in runs[1:] if wkv_precision == "bf16" else runs:
        rt = RuntimeConfig(activation_dtype=dtype, wkv_state_dtype=dtype, quantization="int8",
                           wkv_precision=wkv_precision)
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
        log(f"small model L2 C256 V16384 B{B} {dtype}, wkv_precision {wkv_precision!r}: logits "
            f"err <= {worst:.3e} of scale (tol {tol}), greedy tokens differing on near-ties "
            f"{flips}/{B * steps}")


def check_small_prefill(dev, chunk=16, mm8_core="auto", wkv_precision="default"):
    """The compact prefill, then greedy decode, on a small INT8 model with the
    given mm8 core: the same weights and prompts on the GPU (kernels) and the
    CPU (plain versions), at float32 and bf16. At float32 on the GPU, chunked prefill must also agree
    with feeding the same prompts token by token through the decode step. The
    tolerances and the clear-margin rule for greedy tokens are the decode
    check's. wkv_precision "bf16" runs the bf16 configuration alone."""
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
    rng = np.random.default_rng(2)
    lens = [33, 17, 2, 25, 16, 40, 11, 30]   # prompt lengths; the last token decodes
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in lens]
    order = np.arange(B)[::-1].astype(np.int32)  # compact rows map to slots in reverse

    def prefill(m, c):
        done = [0] * B
        while any(done[s] < lens[s] - 1 for s in range(B)):
            tokens = np.zeros((B, chunk), np.int32)
            lengths = np.zeros(B, np.int32)
            for row, s in enumerate(order):
                n = min(chunk, lens[s] - 1 - done[s])
                tokens[row, :n] = prompts[s][done[s]:done[s] + n]
                lengths[row] = n
                done[s] += n
            m.prefill_step_compact(c, tokens, lengths, order)

    def feed(m, c):
        """Token by token through the decode step, as ONE_PREFILL does."""
        for t in range(max(lens) - 1):
            act = np.array([t < n - 1 for n in lens])
            toks = np.array([p[t] if a else 0 for p, a in zip(prompts, act)], np.int32)
            m.decode_step(c, toks, act, np.zeros(B, bool))

    def decode(m, c):
        toks = np.array([p[-1] for p in prompts], np.int32)
        on, out = np.ones(B, bool), []
        for t in range(steps):
            _, s_t, l_t = m.decode_step(c, toks, on, on, np.full(B, t > 0))
            out.append((s_t.cpu(), l_t.float().cpu()))
        return out

    def compare(label, got, want, tol):
        """Logits within tol of scale; greedy tokens equal where want's top-2
        margin is clear. Returns (worst err / scale, near-tie flips)."""
        worst, flips = 0.0, 0
        for (s_g, l_g), (s_w, l_w) in zip(got, want):
            require(bool(torch.isfinite(l_g).all()), f"{label}: non-finite logits")
            scale = float(l_w.abs().max())
            err = max_abs(l_g, l_w)
            worst = max(worst, err / scale)
            require(err <= tol * scale, f"{label}: logits err {err} > {tol}*{scale}")
            top2 = torch.topk(l_w, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * tol * scale
            diff = s_g != s_w
            flips += int(diff.sum())
            require(not bool((diff & clear).any()), f"{label}: greedy tokens differ")
        return worst, flips

    def state_err(c_got, c_want):
        worst = 0.0
        for name in ("shift", "wkv"):
            g = getattr(c_got.state, name).float().cpu()
            w = getattr(c_want.state, name).float().cpu()
            worst = max(worst, max_abs(g, w) / float(w.abs().max()))
        require(torch.equal(c_got.state.elapsed.cpu(), c_want.state.elapsed.cpu()),
                "small prefill: elapsed differs")
        return worst

    runs = ((torch.float32, 2e-3), (torch.bfloat16, 3e-2))
    for dtype, tol in runs[1:] if wkv_precision == "bf16" else runs:
        rt = RuntimeConfig(activation_dtype=dtype, wkv_state_dtype=dtype, quantization="int8",
                           mm8_core=mm8_core, wkv_precision=wkv_precision)
        params = synthetic_params_int8(cfg, seed=5, dtype=dtype, device=dev)
        models = [ServingModel(cfg, params, rt, B, prefill_chunk=chunk, device=d)
                  for d in (dev, "cpu")]
        carries = [m.init_carry() for m in models]
        for m, c in zip(models, carries):
            for s in range(B):
                m.insert_slot(c, s, None, Greedy)
            prefill(m, c)
        s_err = state_err(*carries)
        require(s_err <= tol, f"small prefill {dtype}: state err {s_err} of scale > {tol}")
        gpu, cpu = (decode(m, c) for m, c in zip(models, carries))
        worst, flips = compare(f"small prefill {dtype}", gpu, cpu, tol)
        log(f"small model prefill (compact, chunk {chunk}) + decode, mm8_core {mm8_core!r}, "
            f"wkv_precision {wkv_precision!r}, L2 C256 B{B} {dtype}, "
            f"GPU vs CPU: state err {s_err:.3e} of scale, logits err <= {worst:.3e} of scale "
            f"(tol {tol}), greedy tokens differing on near-ties {flips}/{B * steps}")
        if dtype == torch.float32:
            m = models[0]
            c = m.init_carry()
            for s in range(B):
                m.insert_slot(c, s, None, Greedy)
            feed(m, c)
            prefill_carry = m.init_carry()
            for s in range(B):
                m.insert_slot(prefill_carry, s, None, Greedy)
            prefill(m, prefill_carry)
            s_err = state_err(prefill_carry, c)
            require(s_err <= tol, f"chunked vs token-by-token: state err {s_err} > {tol}")
            worst, flips = compare("chunked vs token-by-token", decode(m, prefill_carry),
                                   decode(m, c), tol)
            log(f"small model float32 on the GPU, mm8_core {mm8_core!r}, chunked prefill vs "
                f"token by token: state "
                f"err {s_err:.3e} of scale, logits err <= {worst:.3e} of scale (tol {tol}), "
                f"greedy tokens differing on near-ties {flips}/{B * steps}")


def check_small_unfused(dev):
    """Path B on a small INT8 w8a16 model: forward_chunk (ragged rows, one
    empty) then forward_step (that row inactive) with wkv_fn=wkv7_batch, on
    the GPU against the CPU at float32 and bf16, and on the GPU against the
    fused kernels at float32; logits of the active rows and the state within
    the decode check's tolerances of their scale."""
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.models import rwkv7 as tmodel
    from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
    from chirrup_tpu_torch.models.loader import synthetic_params_int8
    from chirrup_tpu_torch.ops.wkv7_cuda import wkv7_batch

    cfg = RWKV7Config(n_layer=2, n_embd=256, vocab_size=16384)
    B, T = 8, 16
    gen = torch.Generator().manual_seed(7)
    tokens = torch.randint(1, cfg.vocab_size, (B, T + 1), generator=gen, dtype=torch.int32)
    lengths = torch.tensor([16, 0, 1, 5, 16, 9, 13, 16], dtype=torch.int32)
    active = lengths > 0

    def run(m, wkv_fn):
        d, rt = m.device, m.runtime
        st = tmodel.init_state(cfg, B, shift_dtype=rt.activation_dtype,
                               wkv_dtype=rt.wkv_state_dtype, device=d)
        kw = dict(compute_dtype=rt.activation_dtype, use_dither=rt.use_dither,
                  mm8_core=m.mm8_core, wkv_fn=wkv_fn)
        tmodel.forward_chunk(m.params, tokens[:, :T].to(d), st, lengths.to(d), **kw)
        logits, _ = tmodel.forward_step(m.params, tokens[:, T].to(d), st, active.to(d), **kw)
        return logits.float().cpu()[active], st

    def rel_err(label, got, want, tol):
        (l_g, s_g), (l_w, s_w) = got, want
        require(bool(torch.isfinite(l_g).all()), f"{label}: non-finite logits")
        errs = [max_abs(l_g, l_w) / float(l_w.abs().max())]
        for name in ("shift", "wkv"):
            g, w = getattr(s_g, name).float().cpu(), getattr(s_w, name).float().cpu()
            errs.append(max_abs(g, w) / float(w.abs().max()))
        require(max(errs) <= tol, f"{label}: logits / shift / wkv err of scale {errs} > {tol}")
        require(torch.equal(s_g.elapsed.cpu(), s_w.elapsed.cpu()), f"{label}: elapsed differs")
        return errs

    for dtype, tol in ((torch.float32, 2e-3), (torch.bfloat16, 3e-2)):
        rt = RuntimeConfig(activation_dtype=dtype, wkv_state_dtype=dtype, quantization="int8",
                           mm8_core="pallas")
        params = synthetic_params_int8(cfg, seed=5, dtype=dtype, device=dev)
        gpu_m, cpu_m = (ServingModel(cfg, params, rt, B, device=d) for d in (dev, "cpu"))
        gpu = run(gpu_m, wkv7_batch)
        errs = rel_err(f"small unfused {dtype} GPU vs CPU", gpu, run(cpu_m, wkv7_batch), tol)
        msg = (f"small model unfused TMix (wkv7_batch), w8a16, L2 C256 B{B} {dtype}, chunk "
               f"then step: GPU vs CPU logits / shift / wkv err "
               f"{', '.join(f'{e:.3e}' for e in errs)} of scale (tol {tol})")
        if dtype == torch.float32:
            errs = rel_err("small unfused vs fused", gpu, run(gpu_m, None), tol)
            msg += (f"; against the fused kernels on the GPU "
                    f"{', '.join(f'{e:.3e}' for e in errs)}")
        log(msg)


def summarize_quant(kernels, mm8_prefill):
    """The quantizer over a w8a8 decode step, reckoned from its per-site
    times at batch 64 (32 layers of R/K/V, Wo, FFN Wk and FFN Wv, and the
    head: 129 launches), and each site's share of its bytes bound at 2,048
    rows."""
    sites = {q["site"]: q for q in next(k for k in kernels
                                        if k["name"] == "mm8_a8_quant_rows")["sites"]}
    layer = ("att R/K/V", "att Wo", "ffn Wk", "ffn Wv")
    step_ms = 32 * sum(sites[s]["ms"] for s in layer) + sites["head"]["ms"]
    rows = next(k for k in mm8_prefill[2048] if k["name"] == "mm8_a8_quant_rows")["sites"]
    share = {q["site"]: q["bound_ms"] / q["ms"] for q in rows}
    log(f"mm8_a8_quant_rows over a decode step (batch 64, 129 launches, from the per-site "
        f"times): {step_ms:.4f} ms; at 2,048 rows, share of the bytes bound: "
        + ", ".join(f"{k} {100 * v:.1f}%" for k, v in share.items()))
    return dict(decode_step_ms=step_ms, share_of_bound_2048=share)


# ------------------------------------------------------------- main path

def expected_launches(L, core, kind, wkv_precision="default"):
    """Kernel launches per decode step (kind "step") or per prefill chunk
    ("chunk") of the serving path under mm8 core `core`: one fused WKV kernel
    per layer (its bf16-mode instance under wkv_precision "bf16"); per layer
    the w8a8 core ("auto") runs quantize + GEMM for the
    merged R/K/V, Wo, FFN k and FFN v, and the w8a16 core ("pallas") one GEMM
    for each of R, K, V, Wo, FFN k and FFN v; a step adds the head, one
    penalty tail and one exact-row sampler launch."""
    from chirrup_tpu_torch.ops import _kernels

    step = int(kind == "step")
    out = dict.fromkeys(_kernels.LAUNCHES, 0)
    mode = "_bf16" if wkv_precision == "bf16" else ""
    out[("wkv7_step_fused" if step else "wkv7_chunk_fused") + mode] = L
    if core == "pallas":
        out["mm8_w16_gemm"] = 6 * L + step
    else:
        out["mm8_a8_quant_rows"] = out["mm8_a8_gemm"] = 4 * L + step
    out["penalty_tail"] = out["sample_exact_rows"] = step
    return out


def code_bytes(params):
    """(bytes of every int8 code tensor of params, bytes of the storages
    under them): equal when no code tensor keeps a second copy alive."""
    from chirrup_tpu_torch.ops import mm8

    qs = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (mm8.Mm8Weight, mm8.Mm8MultiWeight)):
            qs.append(t.q)

    walk(params)
    return sum(q.numel() for q in qs), sum(q.untyped_storage().nbytes() for q in qs)


def write_vocab(path: str, size: int = 65536) -> None:
    """A byte-complete vocab of `size` ids: id 0 is implicit, ids 1..256 the
    single bytes, the rest distinct multi-byte ASCII strings."""
    lines = [f"{b + 1} {bytes([b])!r} 1" for b in range(256)]
    for i in range(size - 257):
        tok = str(10 + i).encode()
        lines.append(f"{257 + i} {tok!r} {len(tok)}")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))


# the kernels of a (B, V) sort (cub's radix sorts and PyTorch's segmented-sort
# helpers: the exact draw in plain PyTorch); a sort of the (B, V / 128)
# candidates runs PyTorch's in-place small sort (radixSortKVInPlace) instead
STEP_GROUPS_SORT = (r"DeviceRadixSort|DeviceSegmentedRadixSort|SegmentedSort|sort_postprocess|"
                    r"fill_index_and_segment")
# groups of a decode step's kernels by name (group_kernels): the port's own
# kernels, then PyTorch's glue by what it does; a kernel joins the first
# group whose pattern its name matches
STEP_GROUPS = [
    ("mm8_a8_gemm", r"gemm_kernel<"),
    ("mm8_w16_gemm", r"w16_bf16_kernel|w16_f32"),
    ("wkv7_step_fused", r"wkv7_step_fused_kernel"),
    ("mm8_a8_quant_rows", r"quant_rows_kernel"),
    ("penalty_tail", r"penalty_tail_kernel"),
    ("sample_exact_rows", r"sample_exact_kernel"),
    ("sampler: a (B, V) sort", STEP_GROUPS_SORT),
    ("sampler: the candidates' sort", r"radixSortKVInPlace|bitonicSort|sortKeyValueInplace|"
                                      r"warpMergeSort"),
    ("sampler: cumsum, softmax, gathers, noise", r"scan_innermost|SoftMax|scatter_gather|"
                                                 r"distribution_|vectorized_gather"),
    ("copies and casts", r"direct_copy|Memcpy|bfloat16_copy|CatArray|Memset"),
    ("adds", r"CUDAFunctor_add"),
    ("layer norms", r"layer_norm"),
    ("cuBLAS products (the LoRA chains)", r"nvjet|gemv|gemm|cutlass|xmma"),
    ("reductions (sums, argmax)", r"reduce_kernel"),
    ("where", r"where_kernel"),
    ("other elementwise (mul, sigmoid, tanh, compares, fills)", r"."),
]


def group_kernels(by_kernel):
    """[(group, ms, launches)] of profiler rows (name, ms, launches) summed
    by STEP_GROUPS, in that order, groups without a kernel left out."""
    import re

    sums = {g: [0.0, 0.0] for g, _ in STEP_GROUPS}
    for name, ms, n in by_kernel:
        g = next(g for g, pat in STEP_GROUPS if re.search(pat, name))
        sums[g][0] += ms
        sums[g][1] += n
    return [(g, ms, n) for g, (ms, n) in sums.items() if n > 0]


class Sampled:
    """Sampling with penalties on: rows the candidates cover when the logits
    are peaked, flagged for the exact draw when they are flat."""
    temperature, top_p, top_k = 1.0, 0.3, 0
    frequency_penalty, presence_penalty, penalty_decay = 0.5, 0.5, 0.996
    forbidden_tokens = ()


class Greedy(Sampled):
    temperature = 0.0


class Hostile(Sampled):
    """Flagged on every row: top_p 1 at a high temperature."""
    temperature, top_p = 2.0, 1.0


class WideK(Sampled):
    """Flagged on every row: top_k above the candidate sampler's k_max."""
    top_p, top_k = 0.9, 200


def steady_decode(model, carry, K, blocks):
    """Steady decode as the worker runs it, every slot decoding: `blocks`
    K-step blocks, each followed by its one host read. Per block: host
    dispatch (until decode_block returns), the main thread's CPU time within
    it, and the wall time through the read."""
    import numpy as np

    B = model.batch_size
    ones = np.ones((K, B), bool)
    tokens = np.full((K, B), 300, np.int32)
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
    step_ms = sum(wall_ms) / (blocks * K)
    return dict(step_ms=step_ms, decode_tok_s=blocks * K * B / (sum(wall_ms) / 1e3),
                blocks=blocks, host_dispatch_ms=host_ms, host_cpu_ms=cpu_ms,
                block_wall_ms=wall_ms, load_average=[load_before[0], load_after[0]])


def spread(xs):
    return f"median {statistics.median(xs):.1f}, min {min(xs):.1f}, max {max(xs):.1f}"


def profile_block(model, carry, K):
    """One more block under torch.profiler: (device busy ms a step or None,
    [(kernel, ms a step, launches a step)], groups, the profiler's
    averages)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile as torch_profile

    B = model.batch_size
    ones = np.ones((K, B), bool)
    tokens = np.full((K, B), 300, np.int32)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        carry, sampled, _ = model.decode_block(carry, tokens, ones, ones, ones)
        sampled.cpu()
    averages = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in averages
                  if e.device_type.name == "CUDA") / 1e3
    by_kernel = sorted(((e.key, e.self_device_time_total / 1e3 / K, e.count / K)
                        for e in averages
                        if e.device_type.name == "CUDA" and e.self_device_time_total > 0),
                       key=lambda kv: -kv[1])
    return (busy_ms / K if busy_ms > 0 else None), by_kernel, group_kernels(by_kernel), averages


def decode_report(label, B, K, steady, busy, by_kernel, groups):
    log(f"{label}: steady decode at batch {B}: {steady['step_ms']:.3f} ms per step, "
        f"{steady['decode_tok_s']:.1f} tok/s (host clock over {steady['blocks']} blocks of "
        f"{K}); per block: host dispatch ms {spread(steady['host_dispatch_ms'])}; main-thread "
        f"CPU ms {spread(steady['host_cpu_ms'])}; wall ms {spread(steady['block_wall_ms'])}; "
        f"{os.cpu_count()} CPUs, load average {steady['load_average'][0]:.2f} -> "
        f"{steady['load_average'][1]:.2f}")
    if busy is None:
        log(f"{label}: device busy per step: not measured (the profiler recorded no device "
            f"time)")
        return None
    idle = 1 - busy / steady["step_ms"]
    log(f"{label}: device busy per step {busy:.3f} ms (profiler, one block of {K}); against "
        f"the steady wall {steady['step_ms']:.3f} ms the device is idle {100 * idle:.1f}% of "
        f"the time; wall / busy {steady['step_ms'] / busy:.3f}; a step by kernel (ms, "
        f"launches): " + "; ".join(f"{name[:60]} {ms:.4f} ({n:g})"
                                   for name, ms, n in by_kernel[:16])
        + "; by group: " + "; ".join(f"{g} {ms:.4f} ({n:g})" for g, ms, n in groups))
    return idle


def carry_diff(a, b):
    """The carry fields in which two carries differ (bit for bit)."""
    fields = dict(shift=(a.state.shift, b.state.shift), wkv=(a.state.wkv, b.state.wkv),
                  elapsed=(a.state.elapsed, b.state.elapsed),
                  occurrence=(a.occurrence, b.occurrence),
                  presence=(a.presence_vec, b.presence_vec),
                  last_sampled=(a.last_sampled, b.last_sampled))
    return [name for name, (x, y) in fields.items() if not torch.equal(x, y)]


def check_graphs(dev, m0, K, seed=17, prefill_batch=256):
    """The serving programs as CUDA graphs against the same bodies run
    eagerly, at the engine model's width and weights: two ServingModels on
    m0's prepared weights, one with graphs and one with graphs=False, the
    same generator seed, the same random state and slot parameters. Bit for
    bit, the tokens and the whole carry (shift, wkv, elapsed, occurrence,
    presence, last_sampled) after: a K-step block with every row greedy;
    a K-step block with sampling and penalties on at the fixed seed (a
    quarter of the rows each greedy, Sampled, Hostile and WideK: the last
    two kinds are flagged on every step and take the exact-row kernel);
    decode_step (and its raw logits); each compact prefill variant on
    ragged rows, of the batch-B models and of two batch-`prefill_batch`
    models from one random state (both variants). Then two consecutive replays
    must draw different noise, one replay runs under sync debug mode
    "error", and a replay counts expected_launches(...) plus one exact-row
    kernel a step. Returns the capture seconds and memory of each program."""
    import numpy as np
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.ops import _kernels

    B, L, V = m0.batch_size, m0.config.n_layer, m0.config.vocab_size
    models = {g: ServingModel(m0.config, m0.params, m0.runtime, B,
                              prefill_chunk=m0.prefill_chunk, device=dev, seed=seed, graphs=g)
              for g in (True, False)}
    require(models[True].graphs == (dev.type == "cuda") and not models[False].graphs,
            "graphs=True did not capture on the card, or graphs=False did")
    carries = {g: m.init_carry() for g, m in models.items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    kinds = (Greedy, Sampled, Hostile, WideK)
    for g, m in models.items():
        for s in range(B):
            m.insert_slot(carries[g], s, None, Greedy)
    shift = torch.randn(carries[True].state.shift.shape, generator=gen, device=dev)
    for li in range(L):
        w = (torch.randn(carries[True].state.wkv[li].shape, generator=gen, device=dev)
             * 0.3).to(carries[True].state.wkv.dtype)
        for c in carries.values():
            c.state.wkv[li].copy_(w)
    elapsed = torch.randint(0, 2 ** 20, (B,), generator=gen, device=dev, dtype=torch.int32)
    for c in carries.values():
        c.state.shift.copy_(shift)
        c.state.elapsed.copy_(elapsed)
    ptrs = {name: t.data_ptr() for name, t in (("wkv", carries[True].state.wkv),
                                                ("occurrence", carries[True].occurrence))}
    ones = np.ones((K, B), bool)
    first = ones.copy()
    first[0] = False
    tokens = np.full((K, B), 300, np.int32)
    mem0 = (torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev))
    out, checks = {}, []

    def same(label, results):
        diff = carry_diff(carries[True], carries[False])
        toks = [torch.equal(a, b) for a, b in zip(*results)]
        require(not diff and all(toks), f"graphs against eager, {label}: carry fields that "
                                        f"differ {diff}, outputs equal {toks}")
        checks.append(label)

    res = {True: models[True].decode_block(carries[True], tokens, first, ones, ones)[1:]}
    torch.cuda.synchronize()
    mem1 = (torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev))
    res[False] = models[False].decode_block(carries[False], tokens, first, ones, ones)[1:]
    same(f"greedy {K}-step block", (res[True], res[False]))
    for g, m in models.items():
        for s in range(B):
            m._set_params(carries[g], s, kinds[s % 4])
    res = {g: m.decode_block(carries[g], tokens, first, ones, ones)[1:]
           for g, m in models.items()}
    same(f"sampled {K}-step block (seed {seed}, penalties on, hostile rows)",
         (res[True], res[False]))
    res = {g: m.decode_step(carries[g], tokens[0], ones[0], ones[0], ones[0])[1:]
           for g, m in models.items()}
    same("decode_step (tokens and raw logits)", (res[True], res[False]))
    rng = np.random.default_rng(seed)
    for P, T in models[True].prefill_variants:
        slot_idx = rng.permutation(B)[:P].astype(np.int32)
        lengths = rng.integers(0, T + 1, P).astype(np.int32)
        toks = rng.integers(1, V, (P, T)).astype(np.int32)
        for g, m in models.items():
            m.prefill_step_compact(carries[g], toks, lengths, slot_idx)
        same(f"prefill_step_compact ({P}, {T}), ragged", ((), ()))
    require(ptrs == {"wkv": carries[True].state.wkv.data_ptr(),
                     "occurrence": carries[True].occurrence.data_ptr()},
            "a serving program rebound a carry tensor")
    # both variants of a batch-`prefill_batch` model (the batch-B model has one)
    wide = {g: ServingModel(m0.config, m0.params, m0.runtime, prefill_batch,
                            prefill_chunk=m0.prefill_chunk, device=dev, seed=seed, graphs=g)
            for g in (True, False)}
    wcarries = {g: m.init_carry() for g, m in wide.items()}
    for li in range(L):
        w = (torch.randn(wcarries[True].state.wkv[li].shape, generator=gen, device=dev)
             * 0.3).to(wcarries[True].state.wkv.dtype)
        for c in wcarries.values():
            c.state.wkv[li].copy_(w)
    for P, T in wide[True].prefill_variants:
        slot_idx = rng.permutation(prefill_batch)[:P].astype(np.int32)
        lengths = rng.integers(0, T + 1, P).astype(np.int32)
        toks = rng.integers(1, V, (P, T)).astype(np.int32)
        for g, m in wide.items():
            m.prefill_step_compact(wcarries[g], toks, lengths, slot_idx)
        diff = carry_diff(wcarries[True], wcarries[False])
        require(not diff, f"graphs against eager, prefill_step_compact ({P}, {T}) at batch "
                          f"{prefill_batch}: carry fields that differ {diff}")
        checks.append(f"prefill_step_compact ({P}, {T}) at batch {prefill_batch}, ragged")
    del wide, wcarries, w
    # two consecutive replays draw different noise
    gm, gcarry = models[True], carries[True]
    prog = gcarry.programs[("block", K)]
    noise = []
    for _ in range(2):
        gm.decode_block(gcarry, tokens, ones, ones, ones)
        noise.append([t.clone() for t in prog.noise])
    require(not torch.equal(noise[0][0], noise[1][0]) and not torch.equal(noise[0][1],
                                                                            noise[1][1]),
            "two consecutive replays drew the same noise")
    # one replay under sync debug mode "error", its launches counted
    torch.cuda.synchronize()
    _kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gm.decode_block(gcarry, tokens, ones, ones, ones)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    per_step = {name: n / K for name, n in _kernels.LAUNCHES.items()}
    expected = expected_launches(L, m0.mm8_core, "step")
    require(per_step == expected, f"graph replay: launches per step {per_step}, "
                                  f"expected {expected}")
    seconds = {" ".join(map(str, key)): p.seconds for key, p in gcarry.programs.items()}
    log(f"graphs against eager ({m0.mm8_core!r}, batch {B}, 7.2B width): bit-equal tokens and "
        f"carry after: {'; '.join(checks)}; no carry tensor rebound; two consecutive replays "
        f"drew different noise; a replay ran under sync debug mode 'error' with launches per "
        f"step {per_step}; warm-up and capture seconds by program {seconds}; the block "
        f"program's capture added {(mem1[0] - mem0[0]) / 2 ** 20:.1f} MiB allocated and "
        f"{(mem1[1] - mem0[1]) / 2 ** 20:.1f} MiB reserved (graph pool)")
    out.update(checks=checks, launches_per_step=per_step, capture_seconds=seconds,
               block_capture_allocated_mib=(mem1[0] - mem0[0]) / 2 ** 20,
               block_capture_reserved_mib=(mem1[1] - mem0[1]) / 2 ** 20)
    return models, carries, out


def serve_requests(dev, cfg, B, requests, n_tok, model_factory=None):
    """Serve `requests` ((prompt, prefill tokens, temperature, penalty)) through
    one AsyncEngineCore worker with warmup_programs=True: every serving
    program runs (on the card: is captured) before the handshake. Returns
    the worker's model and block size, the completions, prompt lengths,
    texts, wall seconds, the launch counters over the requests, the rows fed
    by each compact prefill chunk, the seconds to load and warm up, and the
    warm-up and capture seconds of each program on the worker's carry."""
    from chirrup_tpu_torch.engine.engine import AsyncEngineCore
    from chirrup_tpu_torch.ops import _kernels

    async def serve():
        engine = AsyncEngineCore()
        t0 = time.perf_counter()
        await engine.init(worker_num=1, model_config=cfg, batch_size=B, load_timeout=900,
                          device=dev, model_factory=model_factory, warmup_programs=True)
        load_s = time.perf_counter() - t0
        worker = engine.workers[0]
        model = worker.model
        captures = {" ".join(map(str, key)): p.seconds
                    for key, p in worker.carry.programs.items()}
        compact_calls = []
        compact = model.prefill_step_compact

        def counted(carry, tokens, lengths, slot_idx):
            compact_calls.append(int((lengths > 0).sum()))
            return compact(carry, tokens, lengths, slot_idx)

        model.prefill_step_compact = counted
        try:
            _kernels.reset_launches()
            t0 = time.perf_counter()
            comps = [engine.completion(prompt, prefill_tokens=ids, max_tokens=n_tok,
                                       stop_tokens=(), temperature=temp,
                                       presence_penalty=pen, frequency_penalty=pen)
                     for prompt, ids, temp, pen in requests]
            n_prompt = [len(c.task.prefill_tokens) for c in comps]  # before admission
            texts = await asyncio.gather(*[c.get_full_completion() for c in comps])
            wall = time.perf_counter() - t0
            launches = dict(_kernels.LAUNCHES)
        finally:
            engine.shutdown()
            engine.join(timeout=30)
            del model.prefill_step_compact
        return (model, worker.decode_block_size, comps, n_prompt, texts, wall, launches,
                compact_calls, load_s, captures)

    return asyncio.run(serve())


def report_requests(label, comps, n_prompt, texts, n_tok):
    """Each request's status and time to first token; the TTFTs."""
    ttft = []
    for i, (c, text) in enumerate(zip(comps, texts)):
        require(c.task.is_finished() and len(c.task.generated_tokens) == n_tok and text,
                f"{label} request {i}: status {c.task.request_status}, "
                f"{len(c.task.generated_tokens)} tokens, text {text!r}")
        timing = c.task.timing
        ttft.append(timing["first_token"] - timing["enqueue"])
        log(f"{label} request {i}: {c.task.request_status}, prompt {n_prompt[i]} tokens, "
            f"{len(c.task.generated_tokens)} generated, time to first token {ttft[-1]:.3f} s, "
            f"text {text[:40]!r}")
    return ttft


def run_engine(dev, profile: bool, B=64, L=32, C=4096, V=65536, n_tok=32, blocks=8,
               long_prompt=1024, mm8_core="auto", tag="", eager_blocks=3, eager_engine=False,
               graph_checks=True):
    """The engine phase under mm8 core `mm8_core` ("auto": w8a8; "pallas":
    w8a16, path A); `tag` names its profile files. The engine serves with
    graphs (warmed and captured before the handshake); with `eager_engine`
    the same requests again on a model with graphs=False sharing the
    weights (time to first token, eager). Then steady decode with graphs
    (launches a step over one replay under sync debug mode "error", `blocks`
    timed blocks, one profiled) beside the same with graphs=False
    (`eager_blocks` timed, one profiled); a profiled graph block with every
    row greedy (no row flagged: no (B, V) sort, one exact-row launch a step);
    and, with `graph_checks`, check_graphs."""
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.engine.structures import ModelLoadConfig
    from chirrup_tpu_torch.ops import _kernels
    from chirrup_tpu_torch.utils.tokenizer import WorldTokenizer

    tmp = tempfile.TemporaryDirectory()
    vocab = os.path.join(tmp.name, "vocab.txt")
    write_vocab(vocab, V)
    cfg = ModelLoadConfig(model_path="<synthetic>", vocab_path=vocab, vocab_size=V,
                          quantization="int8", mm8_core=mm8_core,
                          synthetic_config=dict(n_layer=L, n_embd=C, vocab_size=V))
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator().manual_seed(3)
    # (prompt, prefill tokens, temperature, penalties): four short prompts that
    # prefill in one chunk, one under min_forward_seq_len (ONE_PREFILL), and
    # four long ones
    requests = [(f"Request {i}: the port answers", None, temp, pen)
                for i, (temp, pen) in enumerate([(0.0, 0.0), (0.0, 0.0), (1.0, 0.5),
                                                 (1.0, 0.5)])]
    requests.append(("Hi there", None, 0.0, 0.0))
    requests += [("", torch.randint(1, V, (long_prompt,), generator=gen).tolist(), temp, 0.0)
                 for temp in (0.0, 0.0, 1.0, 1.0)]

    (model, K, comps, n_prompt, texts, wall, launches, compact_calls, load_s,
     captures) = serve_requests(dev, cfg, B, requests, n_tok)
    log(f"engine: INT8 model (L{L} C{C} V{V}, mm8_core {mm8_core!r}) loaded, warmed and "
        f"captured in {load_s:.1f} s (graphs {model.graphs}), batch {B}, decode block {K}, "
        f"prefill variants {model.prefill_variants}; warm-up and capture seconds by program "
        f"on the worker's carry: {captures}")
    numel, stored = code_bytes(model.params)
    log(f"engine: int8 codes {numel / 2 ** 30:.3f} GiB in storages of "
        f"{stored / 2 ** 30:.3f} GiB; device memory allocated "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB after serving")
    require(numel == stored, "a code tensor holds a second copy of its codes")
    peak = torch.cuda.max_memory_allocated(dev)
    n_gen = sum(len(c.task.generated_tokens) for c in comps)
    ttft = report_requests("graphs:", comps, n_prompt, texts, n_tok)
    log(f"engine: {len(comps)} requests, {n_gen} tokens in {wall:.3f} s "
        f"({n_gen / wall:.1f} tok/s, {len(comps)} of {B} slots busy); "
        f"{len(compact_calls)} compact prefill chunks (rows fed {compact_calls}); "
        f"launches {launches}; peak memory {peak / 2 ** 30:.2f} GiB")
    require(len(compact_calls) > 0, "the engine never dispatched prefill_step_compact")
    # the path's kernels, each launched at least once; no other kernel
    expected = expected_launches(L, mm8_core, "step")
    on_path = {n for kind in ("step", "chunk")
               for n, c in expected_launches(L, mm8_core, kind).items() if c > 0}
    for name, count in launches.items():
        require((count > 0) == (name in on_path),
                f"kernel {name} launched {count} times on the {mm8_core!r} engine path")
    out = dict(engine_tok_s=n_gen / wall, ttft_s=ttft, compact_chunks=len(compact_calls),
               engine_load_warm_s=load_s, block_steps=K, engine_capture_seconds=captures)

    def eager_model():
        return ServingModel(model.config, model.params, model.runtime, B,
                            prefill_chunk=model.prefill_chunk, device=dev, graphs=False)

    if eager_engine:
        em, _, comps_e, n_prompt_e, texts_e, wall_e, _, _, load_e, _ = serve_requests(
            dev, cfg, B, requests, n_tok,
            model_factory=lambda: (eager_model(), WorldTokenizer(vocab)))
        require(not em.graphs, "the eager engine's model captured graphs")
        ttft_e = report_requests("eager:", comps_e, n_prompt_e, texts_e, n_tok)
        n_gen_e = sum(len(c.task.generated_tokens) for c in comps_e)
        log(f"engine, eager (graphs=False): {n_gen_e} tokens in {wall_e:.3f} s "
            f"({n_gen_e / wall_e:.1f} tok/s); loaded and warmed in {load_e:.1f} s")
        out.update(eager_engine_tok_s=n_gen_e / wall_e, eager_ttft_s=ttft_e)
        del em, comps_e

    # steady decode with graphs: every slot decoding, K-step blocks on device
    # feedback, penalties on
    import numpy as np
    carry = model.init_carry()
    for s in range(B):
        model.insert_slot(carry, s, None, Sampled)
    ones = np.ones((K, B), bool)
    first = ones.copy()
    first[0] = False
    tokens = np.full((K, B), 300, np.int32)
    t0 = time.perf_counter()
    carry, sampled, _ = model.decode_block(carry, tokens, first, ones, ones)  # captures
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    # launches per step, counted over one replay; the replay must also run
    # without a host synchronisation
    _kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, sampled, _ = model.decode_block(carry, tokens, ones, ones, ones)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    per_step = {name: n / K for name, n in _kernels.LAUNCHES.items()}
    torch.cuda.synchronize()
    log(f"decode_block: the first call on a new carry (warm-up and capture, then a replay) "
        f"{first_call_s:.2f} s; no host synchronisation inside a replay (sync debug mode "
        f"'error'); launches per step {per_step}")
    require(per_step == expected, f"launches per step {per_step}, expected {expected}")
    logits = model.decode_step(carry, tokens[0], ones[0], ones[0], ones[0])[2]
    require(tuple(logits.shape) == (B, V) and bool(torch.isfinite(logits).all()),
            "decode logits not finite or of the wrong shape")
    steady = steady_decode(model, carry, K, blocks)
    busy, by_kernel, groups, averages = profile_block(model, carry, K)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"chip_smoke{tag}_profile.txt"), "w") as f:
        f.write(averages.table(sort_by="self_cuda_time_total", row_limit=40))
    idle = decode_report("graphs" if model.graphs else "eager (the CPU)", B, K, steady, busy,
                         by_kernel, groups)
    if profile:
        log(averages.table(sort_by="self_cuda_time_total", row_limit=30))
    out.update(steady, first_block_call_s=first_call_s, device_busy_step_ms=busy,
               idle_share=idle, device_ms_by_kernel_step=by_kernel,
               device_ms_by_group_step=groups)

    # a greedy block: no row flagged, so the exact-row kernel returns at once
    # on every row and nothing sorts a (B, V) row
    for s in range(B):
        model._set_params(carry, s, Greedy)
    model.decode_block(carry, tokens, first, ones, ones)
    g_busy, g_kernels, g_groups, g_avg = profile_block(model, carry, K)
    with open(os.path.join(OUT_DIR, f"chip_smoke{tag}_greedy_profile.txt"), "w") as f:
        f.write(g_avg.table(sort_by="self_cuda_time_total", row_limit=40))
    if g_busy is not None:
        exact = [(n, ms, c) for n, ms, c in g_kernels if "sample_exact_kernel" in n]
        sorts = [(n, ms, c) for n, ms, c in g_kernels
                 if re.search(STEP_GROUPS_SORT, n)]
        log(f"graphs, every row greedy: device busy per step {g_busy:.3f} ms; the exact-row "
            f"kernel {exact} (ms, launches a step); (B, V) sort kernels {sorts}")
        require(not sorts and exact and exact[0][2] == 1,
                f"a greedy graph step sorted a (B, V) row ({sorts}) or ran the exact-row "
                f"kernel otherwise than once ({exact})")
        out.update(greedy_device_busy_step_ms=g_busy,
                   greedy_exact_rows_ms_step=exact[0][1])
    else:
        log("graphs, every row greedy: not measured (the profiler recorded no device time)")

    # the same steady decode eagerly (graphs=False), on the same weights
    if not eager_blocks:
        torch.cuda.empty_cache()
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        return model, launches, per_step, out
    em = eager_model()
    ecarry = em.init_carry()
    for s in range(B):
        em.insert_slot(ecarry, s, None, Sampled)
    em.decode_block(ecarry, tokens, first, ones, ones)
    e_steady = steady_decode(em, ecarry, K, eager_blocks)
    e_busy, e_kernels, e_groups, e_avg = profile_block(em, ecarry, K)
    with open(os.path.join(OUT_DIR, f"chip_smoke{tag}_eager_profile.txt"), "w") as f:
        f.write(e_avg.table(sort_by="self_cuda_time_total", row_limit=40))
    e_idle = decode_report("eager (graphs=False)", B, K, e_steady, e_busy, e_kernels, e_groups)
    out["eager"] = dict(e_steady, device_busy_step_ms=e_busy, idle_share=e_idle,
                        device_ms_by_group_step=e_groups)
    del em, ecarry
    if graph_checks:
        _, _, out["graphs"] = check_graphs(dev, model, K)
    torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return model, launches, per_step, out


PREFIX_GREEDY = dict(temperature=0.0, presence_penalty=0.0, frequency_penalty=0.0,
                     stop_tokens=())


async def cache_request(engine, ids, n_tok, on_snapshot=None, **kw):
    """One greedy request: (tokens, its cache_prefill payload or None, time to
    first token in s); on_snapshot(payload) runs as the event arrives, as a
    server caches it."""
    comp = engine.completion("", prefill_tokens=list(ids), max_tokens=n_tok, **PREFIX_GREEDY,
                             **kw)
    toks, snap = [], None
    async for ev in comp:
        if ev[0] == "token":
            toks.append(ev[1])
        elif ev[0] == "cache_prefill":
            snap = ev[1]
            if on_snapshot is not None:
                on_snapshot(snap)
    timing = comp.task.timing
    require(comp.task.is_finished() and "first_token" in timing,
            f"prefix cache: a request ended {comp.task.request_status} with {len(toks)} tokens")
    return toks, snap, timing["first_token"] - timing["enqueue"]


def pcie_d2h_ms(dev, nbytes):
    """Device time of one copy of `nbytes` from the device into pinned host
    memory (CUDA events, device_ms): the rate a host snapshot's move gets."""
    src = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    dst = torch.empty((nbytes,), dtype=torch.uint8, pin_memory=True)
    return device_ms(lambda: dst.copy_(src, non_blocking=True), iters=10, reps=5)


def host_us(fn, reps=20):
    """Median host microseconds of fn() (its dispatch), each call after a
    synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def run_prefix_cache(dev, m0, B=64, n_tok=16, long_prompt=1024, pad=3, state_pool_size=8,
                     burst=16, burst_prompt=128, wave=8):
    """The prefix-state cache path on the engine model's weights (w8a8, 7.2B
    width), through AsyncEngineCore with graphs and warmup_programs=True:

    - state pool on (state_pool_size + 4 rows): a `long_prompt`-token prompt
      with cache_prefill and padding `pad`, greedy, `n_tok` tokens (the
      miss), then the same prompt resumed from its PoolHandle with the
      `pad`-token suffix (the hit): equal tokens, both times to first token,
      and the kernels' launches over the two (each kernel of the path at
      least once, no other); then `burst` snapshots of `burst_prompt`-token
      prompts into a PrefixStateCache while the first row is pinned by an
      in-flight resume: evictions counted, no skip, the pinned row never
      revoked, and its resume still gives the miss's tokens;
    - state pool off: the same miss and hit through a host snapshot
      (extract_slot_async), whose tensors equal the pool row bit for bit;
    - on a carry of the engine's model with a random state: pool rows
      against the carry rows they came from and a load back (bit-equal),
      pool_store_many / pool_load / extract_slot_async under sync debug mode
      "error" (no host synchronisation), their host time a call and device
      time a row against the bound (a row read and written), the host
      snapshot taken before a write that follows it on the stream, its move
      against the card's device-to-host rate, and a wave of `wave`
      admissions through insert_slots_batched against insert_slot each."""
    import warnings

    import numpy as np
    from chirrup_tpu_torch.engine.engine import AsyncEngineCore
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.engine.state_cache import PrefixStateCache
    from chirrup_tpu_torch.engine.structures import ModelLoadConfig, PoolHandle, RequestState
    from chirrup_tpu_torch.ops import _kernels
    from chirrup_tpu_torch.utils.tokenizer import WorldTokenizer

    mc = m0.config
    L, C, V = mc.n_layer, mc.n_embd, mc.vocab_size
    tmp = tempfile.TemporaryDirectory()
    vocab = os.path.join(tmp.name, "vocab.txt")
    write_vocab(vocab, V)
    cfg = ModelLoadConfig(model_path="<synthetic>", vocab_path=vocab, vocab_size=V,
                          quantization="int8",
                          synthetic_config=dict(n_layer=L, n_embd=C, vocab_size=V))
    models = []

    def factory():
        models.append(ServingModel(mc, m0.params, m0.runtime, B, prefill_chunk=m0.prefill_chunk,
                                   device=dev))
        return models[-1], WorldTokenizer(vocab)

    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(1, V, (long_prompt,), generator=gen).tolist()
    bursts = [torch.randint(1, V, (burst_prompt,), generator=gen).tolist()
              for _ in range(burst)]
    on_path = {n for kind in ("step", "chunk")
               for n, c in expected_launches(L, "auto", kind).items() if c > 0}
    out = {}

    async def serve(pool_size, body):
        engine = AsyncEngineCore()
        t0 = time.perf_counter()
        await engine.init(worker_num=1, model_config=cfg, batch_size=B, load_timeout=900,
                          device=dev, model_factory=factory, warmup_programs=True,
                          state_pool_size=pool_size)
        load_s = time.perf_counter() - t0
        try:
            return load_s, await body(engine, engine.workers[0])
        finally:
            engine.shutdown()
            engine.join(timeout=30)

    async def with_pool(engine, worker):
        _kernels.reset_launches()
        miss, snap, ttft_miss = await cache_request(engine, prompt, n_tok, cache_prefill=True,
                                                    cache_prefill_padding=pad)
        handle = snap["state"]
        require(isinstance(handle, PoolHandle) and snap["prefilled_tokens"] == tuple(
            prompt[:-pad]), f"prefix cache: the pool snapshot is {snap}")
        row = {k: worker.state_pool[k][handle.row].cpu() for k in ("shift", "wkv", "elapsed")}
        cache = PrefixStateCache(max_size=100)
        cache.cache(snap["prefilled_tokens"], handle)
        require(handle.try_acquire(), "prefix cache: the snapshot's handle is dead")
        hit, _, ttft_hit = await cache_request(engine, prompt[-pad:], n_tok, state=handle)
        launches = dict(_kernels.LAUNCHES)
        require(hit == miss, f"prefix cache: pool hit tokens {hit} != uncached {miss}")
        for name, count in launches.items():
            require((count > 0) == (name in on_path),
                    f"prefix cache: kernel {name} launched {count} times on the cache path")
        require(handle.refs == 1 and worker.pool_allocator.available() == worker.pool_allocator.size - 1,
                "prefix cache: the resume did not release its reference")
        # a burst of more snapshots than rows while an in-flight resume pins the row
        require(handle.try_acquire(), "prefix cache: the snapshot's handle is dead")
        evictions = worker.snapshot_evictions
        snaps = await asyncio.gather(*[
            cache_request(engine, ids, 2, cache_prefill=True, cache_prefill_padding=pad,
                          on_snapshot=lambda s: cache.cache(s["prefilled_tokens"], s["state"]))
            for ids in bursts])
        handles = [s for _, s, _ in snaps]
        for s in handles:
            require(s is not None and isinstance(s["state"], PoolHandle),
                    f"prefix cache: a burst snapshot was {s}")
        evicted = worker.snapshot_evictions - evictions
        revoked = sum(s["state"].revoked for s in handles)
        require(evicted == revoked == burst + 1 - worker.pool_allocator.size
                and worker.snapshot_skips == 0 and handle.alive and handle.refs == 2,
                f"prefix cache: {burst} snapshots into {worker.pool_allocator.size} rows: "
                f"{evicted} evictions, {revoked} revoked, {worker.snapshot_skips} skips, the "
                f"pinned handle alive {handle.alive} with {handle.refs} refs")
        again, _, ttft_again = await cache_request(engine, prompt[-pad:], n_tok, state=handle)
        require(again == miss, f"prefix cache: the pinned row's resume {again} != {miss}")
        return dict(miss=miss, row=row, ttft_miss_s=ttft_miss, ttft_hit_s=ttft_hit,
                    ttft_hit_after_burst_s=ttft_again, launches=launches, evictions=evicted,
                    rows=worker.pool_allocator.size, row_bytes=handle.device_bytes)

    async def without_pool(engine, worker):
        miss, snap, ttft_miss = await cache_request(engine, prompt, n_tok, cache_prefill=True,
                                                    cache_prefill_padding=pad)
        state = snap["state"]
        require(isinstance(state, RequestState) and state.wkv.is_pinned()
                and snap["prefilled_tokens"] == tuple(prompt[:-pad]),
                f"prefix cache: the host snapshot is {snap}")
        hit, _, ttft_hit = await cache_request(engine, prompt[-pad:], n_tok, state=state)
        require(worker.state_pool is None and hit == miss,
                f"prefix cache: host hit tokens {hit} != uncached {miss}")
        return dict(miss=miss, state=state, ttft_miss_s=ttft_miss, ttft_hit_s=ttft_hit)

    load_pool, pooled = asyncio.run(serve(state_pool_size, with_pool))
    load_host, host = asyncio.run(serve(0, without_pool))
    row, state = pooled.pop("row"), host.pop("state")
    require(host["miss"] == pooled["miss"], "prefix cache: the two engines' tokens differ")
    require(torch.equal(row["shift"], state.shift) and torch.equal(row["wkv"], state.wkv)
            and int(row["elapsed"]) == state.elapsed == long_prompt - pad,
            "prefix cache: the pool row and the host snapshot of one prompt differ")
    log(f"prefix cache, state pool of {pooled['rows']} rows ({pooled['row_bytes']:,} bytes a "
        f"row; engine loaded, warmed and captured in {load_pool:.1f} s): {long_prompt}-token "
        f"prompt, padding {pad}: time to first token uncached (snapshot on the way) "
        f"{pooled['ttft_miss_s']:.3f} s, resumed from its PoolHandle with the {pad}-token "
        f"suffix {pooled['ttft_hit_s']:.3f} s, {n_tok} greedy tokens equal; launches over "
        f"the two {pooled['launches']}; {burst} snapshots of {burst_prompt} tokens into the "
        f"pool with its first row pinned: {pooled['evictions']} evictions, 0 skips, the "
        f"pinned row's resume {pooled['ttft_hit_after_burst_s']:.3f} s to first token, tokens "
        f"equal")
    log(f"prefix cache, state pool off (host snapshots; engine loaded in {load_host:.1f} s): "
        f"time to first token uncached {host['ttft_miss_s']:.3f} s, resumed from the host "
        f"RequestState {host['ttft_hit_s']:.3f} s, tokens equal to the pool run's; the host "
        f"snapshot equals the pool row bit for bit")
    out.update(pool=pooled, host=host, load_s=dict(pool=load_pool, host=load_host))

    # the pool operations and the admission on a carry of the engine's model
    model = models[0]
    carry = model.init_carry()
    st = carry.state
    g = torch.Generator(device=dev).manual_seed(6)
    st.shift.copy_(torch.randn(st.shift.shape, generator=g, device=dev))
    st.wkv.copy_(torch.randn(st.wkv.shape, generator=g, device=dev))
    st.elapsed.copy_(torch.randint(0, 10_000, (B,), generator=g, device=dev))
    pool = model.init_state_pool(wave + 1)
    row_bytes = model.pool_row_bytes()
    pairs = [((3 + 7 * i) % B, 1 + i) for i in range(wave)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.pool_store_many(carry, pool, pairs)
        model.pool_load(carry, pool, 1, 2)
        resolve = model.extract_slot_async(carry, 5)
        before = model.extract_slot_async(carry, 9)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for slot, r in pairs:
        require(torch.equal(pool["shift"][r], st.shift[:, :, slot])
                and torch.equal(pool["wkv"][r], st.wkv[:, slot])
                and torch.equal(pool["elapsed"][r], st.elapsed[slot]),
                f"prefix cache: pool row {r} differs from carry slot {slot}")
    require(torch.equal(st.shift[:, :, 2], st.shift[:, :, 3]) and torch.equal(
        st.wkv[:, 2], st.wkv[:, 3]) and torch.equal(st.elapsed[2], st.elapsed[3]),
        "prefix cache: pool_load did not give slot 2 the row of slot 3")
    # a snapshot is taken at its call: a write queued after it must not reach it
    ref = model.extract_slot(carry, 9)
    st.wkv.add_(1)
    snap9 = before()
    require(torch.equal(snap9.wkv, ref.wkv) and torch.equal(snap9.shift, ref.shift),
            "prefix cache: the host snapshot holds a write queued after it")
    resolve()
    store1_us = host_us(lambda: model.pool_store_many(carry, pool, pairs[:1]))
    store8_us = host_us(lambda: model.pool_store_many(carry, pool, pairs))
    load_us = host_us(lambda: model.pool_load(carry, pool, 1, 2))
    extract_us = host_us(lambda: model.extract_slot_async(carry, 5))
    resolve_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.extract_slot_async(carry, 5)()
        resolve_ms.append((time.perf_counter() - t0) * 1e3)
    store_row_ms = device_ms(lambda: model.pool_store_many(carry, pool, pairs[:1]))
    load_row_ms = device_ms(lambda: model.pool_load(carry, pool, 1, 2))
    row_bound = bound_ms(2 * row_bytes, 0, "bf16")[0]
    # the same row and the admission's state fill element by element (PyTorch
    # moves a strided bf16 operand one element at a time), against the
    # 8-byte words the pool ops and insert_slots_batched move
    slot0, row0 = pairs[0]
    elem_row_ms = device_ms(lambda: (pool["shift"][row0].copy_(st.shift[:, :, slot0]),
                                     pool["wkv"][row0].copy_(st.wkv[:, slot0])))
    mask_dev = torch.zeros((B,), dtype=torch.bool, device=dev)
    mask_dev[[s for s, _ in pairs]] = True
    fill_ms = {kind: device_ms(lambda: view(st.wkv).masked_fill_(mask_dev[None, :, None, None], 0))
               for kind, view in (("elements", lambda t: t), ("words", lambda t: t.view(torch.int64)))}
    d2h_ms = pcie_d2h_ms(dev, row_bytes)
    log(f"prefix cache, pool ops on a carry at batch {B} (no host synchronisation under sync "
        f"debug mode 'error'; rows bit-equal to the carry rows): host us a call "
        f"pool_store_many of 1 pair {store1_us:.1f}, of {wave} pairs {store8_us:.1f}, "
        f"pool_load {load_us:.1f}, extract_slot_async {extract_us:.1f}; device ms a row "
        f"store {store_row_ms:.4f}, load {load_row_ms:.4f} against a bound of {row_bound:.4f} "
        f"({2 * row_bytes:,} bytes read and written at 3.35 TB/s; the row element by element "
        f"{elem_row_ms:.4f}); the admission's masked fill of the wkv state as 8-byte words "
        f"{fill_ms['words']:.4f} ms, element by element {fill_ms['elements']:.4f}; the host snapshot "
        f"resolved {spread(resolve_ms)} ms after its call (synchronised before it), a "
        f"{row_bytes:,}-byte device-to-host copy into pinned memory {d2h_ms:.4f} ms "
        f"({row_bytes / d2h_ms / 1e6:.1f} GB/s)")

    class Task:
        temperature, top_p, top_k = 0.8, 0.5, 20
        frequency_penalty, presence_penalty, penalty_decay = 0.3, 0.3, 0.996
        forbidden_tokens = (11, 22, 33)

    slots = [(4 + 7 * i) % B for i in range(wave)]
    mask = np.zeros((B,), bool)
    mask[slots] = True
    tasks = [Task if mask[i] else None for i in range(B)]

    def per_slot():
        for s in slots:
            model.insert_slot(carry, s, None, Task)

    def wall_ms(fn, reps=10):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    model.insert_slots_batched(carry, mask, tasks)  # first call: captured
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.insert_slots_batched(carry, mask, tasks)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            per_slot()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    batched_us = host_us(lambda: model.insert_slots_batched(carry, mask, tasks))
    serial_us = host_us(per_slot)
    batched_wall, serial_wall = wall_ms(lambda: model.insert_slots_batched(carry, mask, tasks)), \
        wall_ms(per_slot)
    # two calls a rep: the staging's two pinned buffers, no wait on the host
    batched_dev = device_ms(lambda: model.insert_slots_batched(carry, mask, tasks), iters=2)
    log(f"prefix cache, a wave of {wave} admissions at batch {B}: insert_slots_batched "
        f"(one staged upload, a captured graph; no host synchronisation under sync debug mode "
        f"'error') host {batched_us:.1f} us, wall through a synchronise {batched_wall:.3f} ms, "
        f"device {batched_dev:.4f} ms; {wave} x insert_slot host {serial_us:.1f} us, wall "
        f"{serial_wall:.3f} ms, {syncs} synchronising calls flagged by sync debug mode 'warn'")
    out["ops"] = dict(pool_store_1_host_us=store1_us, pool_store_wave_host_us=store8_us,
                      pool_load_host_us=load_us, extract_async_host_us=extract_us,
                      host_snapshot_resolve_ms=resolve_ms, pool_store_row_ms=store_row_ms,
                      pool_load_row_ms=load_row_ms, row_bound_ms=row_bound,
                      pool_store_row_elements_ms=elem_row_ms, wkv_fill_ms=fill_ms,
                      d2h_row_ms=d2h_ms, d2h_gb_s=row_bytes / d2h_ms / 1e6,
                      insert_batched_host_us=batched_us, insert_batched_wall_ms=batched_wall,
                      insert_batched_device_ms=batched_dev, insert_slot_wave_host_us=serial_us,
                      insert_slot_wave_wall_ms=serial_wall, insert_slot_wave_syncs=syncs)
    del carry, pool, models[:]
    torch.cuda.empty_cache()
    return out


SERVER_PROMPT = "Tell me about the port of a serving engine from one chip to another"


async def http_call(port, method, path, body=None, timeout=300.0):
    """One request over a fresh connection (asyncio streams, the standard
    library): status, the de-chunked body, the seconds from the send to the
    head, to the first body bytes and to the end, and for a stream of
    server-sent events the seconds to the first `data:` line."""
    t0 = time.perf_counter()
    reader, writer = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port), 30)
    try:
        data = b"" if body is None else json.dumps(body).encode()
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n"
                     f"Content-Type: application/json\r\nContent-Length: {len(data)}\r\n\r\n"
                     .encode() + data)
        await writer.drain()
        raw, t_head, t_body, t_data = b"", None, None, None
        while True:
            chunk = await asyncio.wait_for(reader.read(65536), timeout)
            if not chunk:
                break
            now = time.perf_counter() - t0
            raw += chunk
            end = raw.find(b"\r\n\r\n")
            if t_head is None and end >= 0:
                t_head = now
            if t_head is not None and t_body is None and len(raw) > end + 4:
                t_body = now
            if t_data is None and b"data: " in raw:
                t_data = now
    finally:
        writer.close()
    total = time.perf_counter() - t0
    head, _, rest = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    if b"transfer-encoding: chunked" in head.lower():
        out = b""
        while rest:
            size, _, rest = rest.partition(b"\r\n")
            n = int(size, 16)
            if n == 0:
                break
            out, rest = out + rest[:n], rest[n + 2:]
        rest = out
    return dict(status=status, body=rest, head_s=t_head, first_byte_s=t_body,
                first_data_s=t_data, total_s=total)


def http_sync(port, method, path, body=None, timeout=300.0):
    return asyncio.run(http_call(port, method, path, body, timeout))


def sse_result(body: bytes):
    """(content, completion tokens, finish reason) of a chat completion's
    server-sent events, which must end in `data: [DONE]`."""
    lines = [l for l in body.decode().split("\n") if l.startswith("data: ")]
    require(lines and lines[-1] == "data: [DONE]", f"server: a stream ended {lines[-1:]}")
    frames = [json.loads(l[6:]) for l in lines[:-1]]
    content = "".join(f["choices"][0]["delta"].get("content", "") for f in frames)
    return (content, frames[-1]["usage"]["completion_tokens"],
            frames[-1]["choices"][0]["finish_reason"])


def chat_result(r):
    """(content, completion tokens, finish reason) of a non-streamed chat
    completion."""
    require(r["status"] == 200, f"server: status {r['status']}: {r['body'][:300]!r}")
    body = json.loads(r["body"])
    require("error" not in body, f"server: {body}")
    return (body["choices"][0]["message"]["content"], body["usage"]["completion_tokens"],
            body["choices"][0]["finish_reason"])


class ServerProcess:
    """`python -m chirrup_tpu_torch.server ...` (or another `module` taking
    --host and --port, the router) as a child process on the card. A thread
    copies its log (stderr and stdout) into chiprun_out/<log_name> and
    finds the port it reports."""

    def __init__(self, args, module="chirrup_tpu_torch.server",
                 log_name="chip_smoke_server.log"):
        os.makedirs(OUT_DIR, exist_ok=True)
        root = os.path.dirname(os.path.abspath(__file__))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, "--host", "127.0.0.1",
             "--port", "0", *args], cwd=root,
            env=dict(os.environ, PYTHONPATH=root, PYTHONUNBUFFERED="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.port = None
        self.lines = []
        self._log = open(os.path.join(OUT_DIR, log_name), "w")
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self._log.write(line)
            self._log.flush()
            self.lines.append(line)
            m = re.search(r"listening on http://[\d.]+:(\d+)", line)
            if m:
                self.port = int(m.group(1))

    def wait_healthy(self, timeout=600.0):
        """Seconds from the spawn to the first /health 200."""
        deadline = self.t0 + timeout
        while True:
            require(self.proc.poll() is None,
                    f"server exited {self.proc.returncode}: {''.join(self.lines[-20:])}")
            require(time.perf_counter() < deadline, "server: not healthy in time")
            if self.port is not None:
                try:
                    if http_sync(self.port, "GET", "/health", timeout=10)["status"] == 200:
                        return time.perf_counter() - self.t0
                except OSError:
                    pass
            time.sleep(0.2)

    def stop(self, timeout=120.0):
        """SIGINT, then the exit code (killed after `timeout` s: None)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
        try:
            code = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            code = None
        self._reader.join(timeout=10)
        self._log.close()
        return code


def pth_state_dict(dev, L, C, V, seed=0, dtype=torch.bfloat16):
    """A seeded RWKV-LM state dict (the public `.pth` key names and shapes,
    LoRA widths of RWKV7Config's defaults), generated on `dev` and moved to
    the host."""
    from chirrup_tpu_torch.models.config import RWKV7Config

    cfg = RWKV7Config(n_layer=L, n_embd=C, vocab_size=V)
    H, N, F = cfg.n_head, cfg.head_size, cfg.d_ffn
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, scale=0.02):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype).cpu()

    sd = {"emb.weight": r(V, C, scale=1.0), "blocks.0.ln0.weight": 1 + r(C),
          "blocks.0.ln0.bias": r(C), "ln_out.weight": 1 + r(C), "ln_out.bias": r(C),
          "head.weight": r(V, C, scale=0.05)}
    for i in range(L):
        pre, att, ffn = f"blocks.{i}.", f"blocks.{i}.att.", f"blocks.{i}.ffn."
        for k in ("ln1", "ln2"):
            sd[f"{pre}{k}.weight"], sd[f"{pre}{k}.bias"] = 1 + r(C), r(C)
        for k in ("x_r", "x_w", "x_k", "x_v", "x_a", "x_g", "w0", "a0", "k_k", "k_a"):
            sd[att + k] = r(1, 1, C, scale=0.5)
        for k, d in (("w", cfg.d_decay_lora), ("a", cfg.d_iclr_lora), ("g", cfg.d_gate_lora),
                     ("v", cfg.d_v_lora)):
            if k == "v" and i == 0:
                continue  # block 0 carries no value residual
            sd[f"{att}{k}1"], sd[f"{att}{k}2"] = r(C, d, scale=0.1), r(d, C, scale=0.1)
        if i > 0:
            sd[att + "v0"] = r(1, 1, C, scale=0.5)
        sd[att + "r_k"] = r(H, N, scale=0.5)
        for k in ("receptance", "key", "value", "output"):
            sd[f"{att}{k}.weight"] = r(C, C)
        sd[att + "ln_x.weight"], sd[att + "ln_x.bias"] = 1 + r(C), r(C)
        sd[ffn + "x_k"] = r(1, 1, C, scale=0.5)
        sd[ffn + "key.weight"], sd[ffn + "value.weight"] = r(F, C), r(C, F)
    return cfg, sd


def tree_tensors(tree, prefix=""):
    """{path: tensor} of a prepared parameter tree (dicts and dataclasses)."""
    import dataclasses

    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = (tree.items() if isinstance(tree, dict) else
             ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)))
    out = {}
    for k, v in items:
        out.update(tree_tensors(v, f"{prefix}.{k}" if prefix else k))
    return out


PTH_RUNS = (  # (label, mm8 core, activation and state dtype, logits gated)
    ("w8a8 bf16", "auto", "bfloat16", False),     # the serving configuration
    ("w8a16 float32", "pallas", "float32", True),
)


def check_pth(dev, tmp, L=2, C=4096, V=65536, B=8, runs=PTH_RUNS):
    """A bf16 `.pth` at 7.2B widths and L layers (torch.save of seeded
    weights), loaded through build_model_factory on the card and on the CPU
    under each of `runs` (INT8): every prepared leaf bit-equal between the
    two (the quantizer is exact), and the first decode step's logits of the
    same tokens, card against CPU. Gated: the w8a16 core in float32, within
    check_small_model's float32 tolerance, greedy tokens equal where the
    margin is clear. The w8a8 core rounds its activations to int8 codes, and
    float32 products summed in another order put a code on the other side
    of a rounding boundary now and then: each such code moves the logits by
    up to a few hundredths of their scale on these weights (a real model's
    quantization, relu² rows), so its distance is reported, not held."""
    import numpy as np
    from chirrup_tpu_torch.engine.engine import build_model_factory
    from chirrup_tpu_torch.engine.structures import ModelLoadConfig

    t0 = time.perf_counter()
    cfg, sd = pth_state_dict(dev, L, C, V)
    path = os.path.join(tmp, "model.pth")
    torch.save(sd, path)
    del sd
    write_s = time.perf_counter() - t0
    vocab = os.path.join(tmp, "vocab.txt")

    class Greedy:
        temperature, top_p, top_k = 0.0, 0.3, 0
        frequency_penalty, presence_penalty, penalty_decay = 0.5, 0.5, 0.996
        forbidden_tokens = ()

    toks = np.random.default_rng(7).integers(1, V, B).astype(np.int32)
    on = np.ones(B, bool)
    out = dict(layers=L, file_bytes=os.path.getsize(path), write_s=write_s, runs={})
    for label, core, dtype, gated in runs:
        mc = ModelLoadConfig(model_path=path, vocab_path=vocab, vocab_size=V,
                             quantization="int8", mm8_core=core, activation_dtype=dtype,
                             wkv_state_dtype=dtype)
        models, res = [], dict(core=core, dtype=dtype)
        for d in (dev, torch.device("cpu")):
            t0 = time.perf_counter()
            models.append(build_model_factory(mc, B, device=d)()[0])
            if d == dev:
                torch.cuda.synchronize()
                res["load_gpu_s"] = time.perf_counter() - t0
        gpu, cpu = (tree_tensors(m.params) for m in models)
        require(sorted(gpu) == sorted(cpu), f"pth {label}: the two trees differ in their leaves")
        for k in cpu:
            g = gpu[k].cpu()
            require(g.dtype == cpu[k].dtype and g.shape == cpu[k].shape
                    and torch.equal(g, cpu[k]),
                    f"pth {label}: leaf {k} differs between the card and the CPU")
        res.update(leaves=len(cpu),
                   int8_codes=sum(t.numel() for t in cpu.values() if t.dtype == torch.int8))
        first = []
        for m in models:
            carry = m.init_carry()
            for s in range(B):
                m.insert_slot(carry, s, None, Greedy)
            _, sampled, lg = m.decode_step(carry, toks, on, on)
            first.append((sampled.cpu(), lg.float().cpu()))
        del models, gpu, cpu, carry
        torch.cuda.empty_cache()
        (s_gpu, l_gpu), (s_cpu, l_cpu) = first
        require(bool(torch.isfinite(l_gpu).all()), f"pth {label}: non-finite logits")
        scale = float(l_cpu.abs().max())
        res["logits_err_of_scale"] = err = max_abs(l_gpu, l_cpu) / scale
        res["greedy_equal"] = int((s_gpu == s_cpu).sum())
        if gated:
            tol = 2e-3
            require(err <= tol, f"pth {label}: first-step logits err {err:.3e} of scale > {tol}")
            top2 = torch.topk(l_cpu, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * tol * scale
            require(not bool(((s_gpu != s_cpu) & clear).any()), f"pth {label}: greedy differs")
        out["runs"][label] = res
        log(f"server phase, .pth {label}: build_model_factory on the card {res['load_gpu_s']:.1f} "
            f"s; {res['leaves']} prepared leaves ({res['int8_codes']:,} int8 codes) bit-equal "
            f"between the card and the CPU; first-step logits err {err:.3e} of scale"
            f"{' (tol 2e-3)' if gated else ' (reported)'}, greedy tokens equal "
            f"{res['greedy_equal']}/{B}")
    os.unlink(path)
    log(f"server phase, .pth: L{L} C{C} V{V} bf16, {out['file_bytes']:,} bytes written in "
        f"{write_s:.1f} s")
    return out


def run_server(dev, model, decode_tok_s, B=64, L=32, C=4096, V=65536, n_tok=16,
               conv_chars=1024, dedup=8, burst=64, burst_tokens=128):
    """The OpenAI-compatible server on the card, end to end (the engine
    model `model` in this process serves the in-process reference: the same
    seed-0 weights):

    1. synthetic_params_int8(seed=0) written as a native checkpoint
       (save_native: bytes, seconds); `python -m chirrup_tpu_torch.server
       --model-path <dir> --profile h100-7b2` spawned; seconds to the first
       /health 200 (imports, the checkpoint's upload, warm-up and graph
       capture); /v1/models, and /metrics reporting the C trie;
    2. one non-streamed and one streamed greedy chat completion
       (ignore_eos, `n_tok` tokens), whose content must equal the same
       prompt's greedy tokens from the in-process AsyncEngineCore through
       the server's parser; the stream must end in `data: [DONE]`; the
       client's time to the first byte;
    3. the cache's server half: a ~1,024-token conversation, then the same
       with one more turn, which must resume (state_cache hits + 1) with a
       time to first token well below the first's and the content of the
       same request with use_state_cache false; then `dedup` identical
       prompts at once: one snapshot (the leader's), the rest resumed;
    4. `burst` concurrent streamed requests (ignore_eos, `burst_tokens`
       each): tokens a second at the client against `decode_tok_s`, the
       engine phase's in-process steady decode rate;
    5. the kernels' launches over 2-4, from /metrics (counted from the end
       of loading): each kernel of the w8a8 serving path launched, no other;
    6. SIGINT: exit code 0;
    7. a bf16 `.pth` at 7.2B widths, 2 layers, through build_model_factory
       on the card and the CPU (check_pth)."""
    import numpy as np
    from chirrup_tpu_torch.engine.structures import ModelLoadConfig
    from chirrup_tpu_torch.models import checkpoint, loader
    from chirrup_tpu_torch.models.config import RWKV7Config
    from chirrup_tpu_torch.utils.streaming_parser import (StreamingStringParser,
                                                          TRIE_THINK_NO_TRIGGER)
    from chirrup_tpu_torch.utils.tokenizer import WorldTokenizer

    out = {}
    tmp = tempfile.TemporaryDirectory()
    ckpt_dir = os.path.join(tmp.name, "native")
    vocab = os.path.join(tmp.name, "vocab.txt")
    write_vocab(vocab, V)
    cfg = RWKV7Config(n_layer=L, n_embd=C, vocab_size=V)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = loader.synthetic_params_int8(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    checkpoint.save_native(ckpt_dir, cfg, params)
    write_s = time.perf_counter() - t1
    del params
    torch.cuda.empty_cache()
    files = os.listdir(ckpt_dir)
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt_dir, f)) for f in files)
    out.update(checkpoint_bytes=ckpt_bytes, checkpoint_files=len(files),
               checkpoint_write_s=write_s, synthetic_s=t1 - t0)
    log(f"server phase: native checkpoint of the L{L} C{C} V{V} INT8 tree (seed 0), {len(files)} "
        f"files, {ckpt_bytes:,} bytes, written in {write_s:.1f} s "
        f"({ckpt_bytes / write_s / 1e9:.2f} GB/s; the tree made in {t1 - t0:.1f} s)")

    srv = ServerProcess(["--model-path", ckpt_dir, "--vocab-path", vocab, "--profile",
                         "h100-7b2", "--batch-size", str(B)])
    try:
        healthy_s = srv.wait_healthy()
        port = srv.port
        out["spawn_to_healthy_s"] = healthy_s
        log(f"server phase: spawn to the first /health 200 in {healthy_s:.1f} s (port {port})")
        models = json.loads(http_sync(port, "GET", "/v1/models")["body"])
        require([m["id"] for m in models["data"]] == [
            "rwkv-latest", "rwkv-latest:thinking", "rwkv-latest:no-thinking"],
            f"server: /v1/models {models}")
        metrics = json.loads(http_sync(port, "GET", "/metrics")["body"])
        require(metrics["tokenizer"] == "c", f"server: tokenizer trie {metrics['tokenizer']}")
        require(not any(metrics["kernel_launches"].values()),
                f"server: launches counted before the first request {metrics['kernel_launches']}")

        # 2. served tokens against in-process tokens
        greedy = dict(model="rwkv-latest:no-thinking", temperature=0.0, ignore_eos=True,
                      max_tokens=n_tok, use_state_cache=False, cache_prefill=False)
        messages = [{"role": "user", "content": SERVER_PROMPT}]
        plain = chat_result(http_sync(port, "POST", "/v1/chat/completions",
                                      dict(greedy, messages=messages)))
        streamed = http_sync(port, "POST", "/v1/chat/completions",
                             dict(greedy, messages=messages, stream=True))
        require(streamed["status"] == 200, f"server: stream status {streamed['status']}")
        s_content = sse_result(streamed["body"])
        tok = WorldTokenizer(vocab)
        prompt = "User: " + SERVER_PROMPT + "\n\nAssistant:"
        mc = ModelLoadConfig(model_path="<in-process>", vocab_path=vocab, vocab_size=V)
        served = serve_requests(dev, mc, B, [(prompt, [0] + tok.encode(prompt), 0.0, 0.5)],
                                n_tok, model_factory=lambda: (model, tok))
        comp, text = served[2][0], served[4][0]
        parser = StreamingStringParser(tries=TRIE_THINK_NO_TRIGGER)
        parser.parse("Assistant:")
        ref = "".join(t for t, st in parser.parse(text) if st == "content")
        require(plain == (ref, n_tok, "length") and s_content == plain,
                f"server: served {plain} / streamed {s_content} != in-process {ref!r} "
                f"({len(comp.task.generated_tokens)} tokens)")
        out.update(first_byte_stream_s=streamed["first_data_s"],
                   first_byte_plain_s=http_sync(port, "POST", "/v1/chat/completions", dict(
                       greedy, messages=messages, max_tokens=1))["total_s"])
        log(f"server phase: greedy {n_tok} tokens served, non-streamed and streamed, equal to "
            f"the in-process engine's on the same weights ({ref[:40]!r}); the stream's first "
            f"data frame at {streamed['first_data_s']:.3f} s at the client, a 1-token "
            f"completion in {out['first_byte_plain_s']:.3f} s")

        # 3. the cache's server half
        rng = np.random.default_rng(11)
        words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
                 for _ in range(conv_chars // 4)]
        long_text = " ".join(words)[:conv_chars]
        conv = [{"role": "user", "content": long_text}]
        cached = dict(model="rwkv-latest:no-thinking", temperature=0.0, ignore_eos=True,
                      max_tokens=n_tok, stream=True)

        def cache_stats():
            return json.loads(http_sync(port, "GET", "/metrics")["body"])["state_cache"]

        st0 = cache_stats()
        first = http_sync(port, "POST", "/v1/chat/completions", dict(cached, messages=conv))
        reply = sse_result(first["body"])[0]
        st1 = cache_stats()
        conv2 = conv + [{"role": "assistant", "content": reply or "ok"},
                        {"role": "user", "content": "and one more question about it"}]
        second = http_sync(port, "POST", "/v1/chat/completions", dict(cached, messages=conv2))
        st2 = cache_stats()
        uncached = http_sync(port, "POST", "/v1/chat/completions", dict(
            cached, messages=conv2, use_state_cache=False, cache_prefill=False))
        resumed_c, uncached_c = sse_result(second["body"]), sse_result(uncached["body"])
        n_conv = len(tok.encode("User: " + long_text + "\n\nAssistant:")) + 1
        out["cache"] = dict(prompt_tokens=n_conv, ttft_first_s=first["first_data_s"],
                            ttft_resumed_s=second["first_data_s"],
                            ttft_uncached_s=uncached["first_data_s"],
                            tokens_saved=st2["tokens_saved"] - st1["tokens_saved"],
                            stats=[st0, st1, st2])
        log(f"server phase, cache: a {n_conv}-token conversation, first data frame at "
            f"{first['first_data_s']:.3f} s; with one more turn resumed at "
            f"{second['first_data_s']:.3f} s ({st2['tokens_saved'] - st1['tokens_saved']} "
            f"tokens skipped), with use_state_cache false {uncached['first_data_s']:.3f} s; "
            f"content resumed {resumed_c[0][:30]!r} / uncached {uncached_c[0][:30]!r}")
        require(st1["entries"] == st0["entries"] + 1 and st2["hits"] == st1["hits"] + 1,
                f"server: the conversation did not resume from its snapshot: {st0} {st1} {st2}")
        # the resumed request is the leader of its own longer prefix: it also
        # pauses one block for its snapshot, as the first did
        require(second["first_data_s"] < min(0.8 * first["first_data_s"],
                                             uncached["first_data_s"]),
                f"server: resumed first data frame at {second['first_data_s']:.3f} s, the "
                f"first conversation's at {first['first_data_s']:.3f} s, the same request "
                f"uncached at {uncached['first_data_s']:.3f} s")
        require(resumed_c == uncached_c, f"server: resumed {resumed_c} != uncached {uncached_c}")

        dedup_text = " ".join(words[::-1])[:conv_chars // 4]
        dedup_body = dict(cached, stream=False, max_tokens=4,
                          messages=[{"role": "user", "content": dedup_text}])

        async def at_once(n, body):
            return await asyncio.gather(*[http_call(port, "POST", "/v1/chat/completions", body)
                                          for _ in range(n)])

        st3 = cache_stats()
        results = asyncio.run(at_once(dedup, dedup_body))
        st4 = cache_stats()
        texts = {chat_result(r) for r in results}
        out["dedup"] = dict(n=dedup, new_entries=st4["entries"] - st3["entries"],
                            hits=st4["hits"] - st3["hits"], misses=st4["misses"] - st3["misses"],
                            wall_s=max(r["total_s"] for r in results))
        log(f"server phase, dedup: {dedup} identical prompts at once: {out['dedup']}")
        require(len(texts) == 1 and st4["entries"] == st3["entries"] + 1
                and st4["hits"] - st3["hits"] == dedup - 1
                and st4["misses"] - st3["misses"] == 1,
                f"server: {dedup} identical prompts took other than one snapshot: {out['dedup']}")

        # 4. a burst over live HTTP
        burst_body = [dict(model="rwkv-latest:no-thinking", temperature=1.0, ignore_eos=True,
                           max_tokens=burst_tokens, stream=True, use_state_cache=False,
                           cache_prefill=False,
                           messages=[{"role": "user", "content": f"Request {i}: go on"}])
                      for i in range(burst)]

        async def burst_run():
            t0 = time.perf_counter()
            rs = await asyncio.gather(*[http_call(port, "POST", "/v1/chat/completions", b)
                                        for b in burst_body])
            return rs, time.perf_counter() - t0

        rs, wall = asyncio.run(burst_run())
        n_gen = 0
        for r in rs:
            require(r["status"] == 200, f"server: burst status {r['status']}")
            _, n, reason = sse_result(r["body"])
            require(n == burst_tokens and reason == "length",
                    f"server: a burst request gave {n} tokens ({reason})")
            n_gen += n
        tok_s = n_gen / wall
        ttfb = sorted(r["first_data_s"] for r in rs)
        out["burst"] = dict(requests=burst, tokens=n_gen, wall_s=wall, tok_s=tok_s,
                            in_process_decode_tok_s=decode_tok_s,
                            ratio=tok_s / decode_tok_s,
                            first_data_p50_s=ttfb[len(ttfb) // 2], first_data_max_s=ttfb[-1])
        log(f"server phase, burst: {burst} streamed requests x {burst_tokens} tokens over HTTP "
            f"in {wall:.2f} s: {tok_s:.1f} tok/s at the client, {tok_s / decode_tok_s:.3f} of "
            f"the engine phase's in-process steady decode ({decode_tok_s:.1f} tok/s); first data "
            f"frame p50 {ttfb[len(ttfb) // 2]:.3f} s, max {ttfb[-1]:.3f} s")

        # 5. the kernels of the serving path, counted by the server
        metrics = json.loads(http_sync(port, "GET", "/metrics")["body"])
        launches = metrics["kernel_launches"]
        on_path = {n for kind in ("step", "chunk")
                   for n, c in expected_launches(L, "auto", kind).items() if c > 0}
        out.update(launches=launches, worker=metrics["workers"],
                   ttft_breakdown=metrics["ttft_breakdown"])
        log(f"server phase: kernel launches over the requests {launches}; TTFT breakdown "
            f"{metrics['ttft_breakdown']}")
        for name, count in launches.items():
            require((count > 0) == (name in on_path),
                    f"server: kernel {name} launched {count} times on the serving path")
    finally:
        code = srv.stop()
    out["exit_code"] = code
    require(code == 0, f"server: exit code {code} after SIGINT")
    shutil.rmtree(ckpt_dir)
    torch.cuda.empty_cache()
    out["pth"] = check_pth(dev, tmp.name, C=C, V=V)
    tmp.cleanup()
    return out


def run_prefill(dev, engine_model, profile: bool, B=256, chunks=4, tag="", graphs=True):
    """Compact prefill at 7.2B width on a batch-B ServingModel that shares
    the engine model's prepared weights, with CUDA graphs or (graphs=False)
    eagerly, for each (P, T) variant: the first chunk (with graphs: warm-up
    and capture), launches per chunk (one chunk under sync debug mode
    "error"), then `chunks` chunks timed on the host clock (dispatch, and
    wall through a synchronise), then one more under the profiler for the
    device busy time by kernel."""
    import numpy as np
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.ops import _kernels
    from torch.profiler import ProfilerActivity, profile as torch_profile

    m0 = engine_model
    model = ServingModel(m0.config, m0.params, m0.runtime, B,
                         prefill_chunk=m0.prefill_chunk, device=dev, graphs=graphs)
    ptr = lambda w: getattr(w, "q", w).data_ptr()
    require(all(ptr(a) == ptr(b) for a, b in zip(model.params["blocks"]["att"].values(),
                                                 m0.params["blocks"]["att"].values())),
            "the batch-256 model copied the weights")
    mode = "graphs" if model.graphs else "eager (graphs=False)"
    L, V = m0.config.n_layer, m0.config.vocab_size
    carry = model.init_carry()
    rng = np.random.default_rng(4)
    results, tables = [], []
    for P, T in model.prefill_variants:
        slot_idx = (np.arange(P) * (B // P)).astype(np.int32)
        lengths = np.full(P, T, np.int32)

        def chunk():
            tokens = rng.integers(1, V, (P, T)).astype(np.int32)
            return model.prefill_step_compact(carry, tokens, lengths, slot_idx)

        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        _kernels.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            chunk()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        per_chunk = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        expected = expected_launches(L, m0.mm8_core, "chunk")
        require(per_chunk == expected,
                f"prefill ({P}, {T}): launches per chunk {per_chunk}, expected {expected}")
        host_ms, wall_ms = [], []
        for _ in range(chunks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunk()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host_ms.append((t1 - t0) * 1e3)
            wall_ms.append((time.perf_counter() - t0) * 1e3)
        tok_s = P * T * chunks / (sum(wall_ms) / 1e3)
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chunk()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        kernels = sorted(((e.key, e.self_device_time_total / 1e3) for e in averages
                          if e.device_type.name == "CUDA" and e.self_device_time_total > 0),
                         key=lambda kv: -kv[1])
        busy = sum(ms for _, ms in kernels)
        tables.append(f"prefill chunk ({P}, {T})\n"
                      + averages.table(sort_by="self_cuda_time_total", row_limit=30))
        wall = statistics.median(wall_ms)
        top = "; ".join(f"{name[:48]} {ms:.2f}" for name, ms in kernels[:6])
        log(f"prefill ({P}, {T}) at batch {B}, 7.2B width, mm8_core {m0.mm8_core!r}, {mode}: "
            f"first chunk {first_s:.2f} s; launches per chunk {per_chunk} "
            f"(no host synchronisation: sync debug mode 'error'); {tok_s:.1f} prompt tok/s "
            f"over {chunks} chunks; per chunk host dispatch ms "
            f"{statistics.median(host_ms):.1f} (min {min(host_ms):.1f}, max {max(host_ms):.1f}), "
            f"wall ms {wall:.1f} (min {min(wall_ms):.1f}, max {max(wall_ms):.1f}); device busy "
            f"{busy:.2f} ms a chunk (profiler), idle {100 * (1 - busy / wall):.1f}% of the "
            f"median wall; by kernel (ms): {top}")
        results.append(dict(variant=[P, T], graphs=model.graphs, first_chunk_s=first_s,
                            launches_per_chunk=per_chunk, prompt_tok_s=tok_s,
                            host_dispatch_ms=host_ms, chunk_wall_ms=wall_ms,
                            device_busy_chunk_ms=busy, device_ms_by_kernel=kernels[:12]))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"chip_smoke{tag}_prefill_profile.txt"), "w") as f:
        f.write("\n\n".join(tables))
    if profile:
        log("\n\n".join(tables))
    del carry, model
    return results


def run_bf16_mode(dev, engine_model, K, B=64, prefill_batch=256, tol=4e-2):
    """The serving path in the WKV kernels' bf16 mode at 7.2B width:
    ServingModels built with RuntimeConfig(wkv_precision="bf16") on the
    engine model's prepared weights (batch B for decode, `prefill_batch` for
    compact prefill), beside default-mode models on the same weights:
    - the first decode step from the same random state and tokens in both
      modes: the bf16 mode's logits within `tol` of the default mode's scale
      and its new state within tol + tol |default| per element (the 4e-2 the
      JAX package's tests/test_wkv7_pallas.py::test_bf16_compute_fused_step
      allows its bf16-mode kernel against its default one);
    - K-step decode blocks in each mode: one to warm up, in bf16 mode one
      counted under sync debug mode "error" (launches per step), then one
      profiled: device busy and the WKV step kernel's ms a step;
    - compact prefill in each mode, each variant ((8, 256) and (32, 64) at
      batch 256): a warm-up chunk, in bf16 mode one counted under sync debug
      mode "error" (launches per chunk), then one profiled: device busy and
      the WKV chunk kernel's ms a chunk.
    The launch counters are reset at the start; the bf16-mode kernels'
    counts over the run are returned with the numbers."""
    import dataclasses
    import re

    import numpy as np
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.ops import _kernels
    from torch.profiler import ProfilerActivity, profile as torch_profile

    m0 = engine_model
    require(m0.runtime.wkv_precision == "default", "the engine model is not in the default mode")
    L, V, core = m0.config.n_layer, m0.config.vocab_size, m0.mm8_core
    runtimes = {"default": m0.runtime,
                "bf16": dataclasses.replace(m0.runtime, wkv_precision="bf16")}
    ptr = lambda w: getattr(w, "q", w).data_ptr()

    def model(mode, batch):
        m = ServingModel(m0.config, m0.params, runtimes[mode], batch,
                         prefill_chunk=m0.prefill_chunk, device=dev)
        require(all(ptr(a) == ptr(b) for a, b in zip(m.params["blocks"]["att"].values(),
                                                     m0.params["blocks"]["att"].values())),
                "a bf16-mode model copied the weights")
        return m

    def profiled(fn, pattern):
        """(device busy ms, ms and launches of the kernels matching pattern)
        of one call of fn, from the profiler."""
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
        hits = [(ms, n) for key, ms, n in rows if re.search(pattern, key)]
        return sum(ms for _, ms, _ in rows), sum(ms for ms, _ in hits), sum(n for _, n in hits)

    def counted(fn):
        """Launches of one call of fn, run under sync debug mode "error"."""
        before = dict(_kernels.LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return {k: n - before[k] for k, n in _kernels.LAUNCHES.items()}

    class Greedy:
        temperature, top_p, top_k = 0.0, 0.3, 0
        frequency_penalty, presence_penalty, penalty_decay = 0.5, 0.5, 0.996
        forbidden_tokens = ()

    _kernels.reset_launches()
    out = {}
    # the first decode step, both modes from the same random state and tokens
    gen = torch.Generator(device=dev).manual_seed(13)
    models = {mode: model(mode, B) for mode in runtimes}
    carries = {mode: m.init_carry() for mode, m in models.items()}
    for mode, m in models.items():
        for slot in range(B):
            m.insert_slot(carries[mode], slot, None, Greedy)
    for li in range(L):
        w = torch.randn((B, 64, m0.config.n_embd), generator=gen, device=dev) * 0.3
        for c in carries.values():
            c.state.wkv[li].copy_(w)
    shift = torch.randn(carries["bf16"].state.shift.shape, generator=gen, device=dev)
    elapsed = torch.randint(0, 2 ** 31 - 1, (B,), generator=gen, device=dev)
    for c in carries.values():
        c.state.shift.copy_(shift)
        c.state.elapsed.copy_(elapsed)
    tokens0 = torch.randint(1, V, (B,), generator=gen, device=dev).cpu().numpy().astype(np.int32)
    on = np.ones(B, bool)
    logits = {mode: m.decode_step(carries[mode], tokens0, on, on)[2].float()
              for mode, m in models.items()}
    torch.cuda.synchronize()
    ref, got = logits["default"], logits["bf16"]
    require(tuple(got.shape) == (B, V) and bool(torch.isfinite(got).all()),
            "bf16 mode: logits not finite or of the wrong shape")
    logits_err = max_abs(got, ref) / float(ref.abs().max())
    state_excess, state_err = 0.0, 0.0
    s_ref, s_got = carries["default"].state.wkv, carries["bf16"].state.wkv
    for li in range(L):
        a, b = s_got[li].float(), s_ref[li].float()
        state_excess = max(state_excess, float(((a - b).abs() / (tol + tol * b.abs())).max()))
        state_err = max(state_err, max_abs(a, b) / float(b.abs().max()))
    log(f"bf16 mode, 7.2B width, batch {B}: first decode step against the default mode from "
        f"the same random state: logits err {logits_err:.3e} of scale (tol {tol}); new state "
        f"err {state_err:.3e} of scale, worst |err| / ({tol} + {tol}|ref|) {state_excess:.3f}")
    require(logits_err <= tol and state_excess <= 1,
            f"bf16 mode: first step against the default mode: logits err {logits_err} of "
            f"scale, state |err|/limit {state_excess} (tol {tol})")
    out.update(first_step_logits_err_of_scale=logits_err, first_step_state_err_of_scale=state_err,
               first_step_state_excess=state_excess)

    # decode blocks
    ones = np.ones((K, B), bool)
    tokens = np.full((K, B), 300, np.int32)
    block = {mode: (lambda m=m, mode=mode: m.decode_block(carries[mode], tokens, ones, ones,
                                                           ones)[1].cpu())
             for mode, m in models.items()}
    for mode in runtimes:
        block[mode]()
    per_step = {k: n / K for k, n in counted(lambda: models["bf16"].decode_block(
        carries["bf16"], tokens, ones, ones, ones)).items()}
    expected = expected_launches(L, core, "step", "bf16")
    require(per_step == expected, f"bf16 mode: launches per step {per_step}, expected {expected}")
    decode = {}
    for mode in runtimes:
        busy, wkv_ms, n = profiled(block[mode], r"wkv7_step_fused_kernel")
        decode[mode] = dict(device_busy_step_ms=busy / K, wkv_step_ms=wkv_ms / K,
                            wkv_launches_step=n / K)
    log(f"bf16 mode decode at batch {B}: launches per step {per_step} (no host "
        f"synchronisation: sync debug mode 'error'); a step (profiler, one block of {K} "
        f"each): device busy {decode['bf16']['device_busy_step_ms']:.3f} ms, "
        f"wkv7_step_fused {decode['bf16']['wkv_step_ms']:.4f} ms "
        f"({decode['bf16']['wkv_launches_step']:g} launches); default mode, same call: device "
        f"busy {decode['default']['device_busy_step_ms']:.3f} ms, wkv7_step_fused "
        f"{decode['default']['wkv_step_ms']:.4f} ms")
    out.update(launches_per_step=per_step, decode=decode)
    del models, carries, logits, ref, got, s_ref, s_got, a, b, w
    torch.cuda.empty_cache()

    # compact prefill at batch prefill_batch
    prefill = {mode: {} for mode in runtimes}
    per_chunk = {}
    for mode in runtimes:
        m = model(mode, prefill_batch)
        c = m.init_carry()
        rng = np.random.default_rng(4)
        for P, T in m.prefill_variants:
            slot_idx = (np.arange(P) * (prefill_batch // P)).astype(np.int32)
            lengths = np.full(P, T, np.int32)

            def chunk():
                toks = rng.integers(1, V, (P, T)).astype(np.int32)
                m.prefill_step_compact(c, toks, lengths, slot_idx)

            chunk()
            torch.cuda.synchronize()
            if mode == "bf16":
                per_chunk[f"{P}x{T}"] = got_launches = counted(chunk)
                expected = expected_launches(L, core, "chunk", "bf16")
                require(got_launches == expected, f"bf16 mode prefill ({P}, {T}): launches per "
                                                  f"chunk {got_launches}, expected {expected}")
            busy, wkv_ms, n = profiled(chunk, r"wkv7_chunk_fused_kernel")
            prefill[mode][f"{P}x{T}"] = dict(device_busy_chunk_ms=busy, wkv_chunk_ms=wkv_ms,
                                             wkv_launches_chunk=n)
        del m, c
        torch.cuda.empty_cache()
    for key, x in prefill["bf16"].items():
        d = prefill["default"][key]
        log(f"bf16 mode prefill {key} at batch {prefill_batch}: launches per chunk "
            f"{per_chunk[key]} (sync debug mode 'error'); a chunk (profiler): device busy "
            f"{x['device_busy_chunk_ms']:.2f} ms, wkv7_chunk_fused {x['wkv_chunk_ms']:.4f} ms "
            f"({x['wkv_launches_chunk']} launches); default mode, same call: device busy "
            f"{d['device_busy_chunk_ms']:.2f} ms, wkv7_chunk_fused {d['wkv_chunk_ms']:.4f} ms")
    out.update(launches_per_chunk=per_chunk, prefill=prefill,
               launches={k: n for k, n in _kernels.LAUNCHES.items() if k.endswith("_bf16")})
    return out


def run_unfused(dev, m, B=64, P=8, T=256, tol=3e-2, precision="default"):
    """Path B at 7.2B width on the engine model's prepared weights: one
    forward_chunk at (P, T) from a zero state and one forward_step at batch B
    from a random state, each with wkv_fn=wkv7_batch and, from a copy of the
    same state, with the fused kernels (wkv_fn=None). Launches are counted
    around each unfused call: L bare WKV kernels, no fused one, the mm8
    kernels as on the serving path. Each call's wall time ends in a
    synchronise. The two paths round differently in bf16 (the unfused glue
    rounds kk, k~, y and the bonus; the fused kernels keep them in float32),
    and 32 layers carry that on, so they are held to the bf16 end-to-end
    tolerance of phase 4 (logits and every layer's state within `tol` of
    their scale; greedy tokens equal where the fused top-2 margin is clear);
    layer 0, whose WKV inputs are the same on both paths, is reported per
    element against the WKV kernels' limit, and held to it at float32
    (unfused_layer0_float32). precision "bf16": both paths in the WKV
    kernels' bf16 mode, the bare kernel's through
    functools.partial(wkv7_batch, precision="bf16") and the fused kernels'
    through wkv_precision, without the float32 layer-0 run (on a float32
    state the mode is the default)."""
    import functools

    from chirrup_tpu_torch.models import rwkv7 as tmodel
    from chirrup_tpu_torch.ops import _kernels
    from chirrup_tpu_torch.ops.wkv7_cuda import wkv7_batch

    cfg, rt = m.config, m.runtime
    L, V = cfg.n_layer, cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(11)
    kw = dict(compute_dtype=rt.activation_dtype, use_dither=rt.use_dither, mm8_core=m.mm8_core,
              wkv_precision=precision)
    bf16 = precision == "bf16"
    bare = functools.partial(wkv7_batch, precision="bf16") if bf16 else wkv7_batch

    def state(n, random):
        st = tmodel.init_state(cfg, n, shift_dtype=rt.activation_dtype,
                               wkv_dtype=rt.wkv_state_dtype, device=dev)
        if random:
            st.wkv.copy_(torch.randn(st.wkv.shape, generator=gen, device=dev) * 0.3)
            st.shift.copy_(torch.randn(st.shift.shape, generator=gen, device=dev))
            st.elapsed.copy_(torch.randint(0, 2 ** 31 - 1, (n,), generator=gen, device=dev))
        return st

    results = {}
    for kind, n in (("chunk", P), ("step", B)):
        st0 = state(n, random=kind == "step")
        shape = (n, T) if kind == "chunk" else (n,)
        tokens = torch.randint(1, V, shape, generator=gen, device=dev, dtype=torch.int32)
        runs = {}
        for label, fn in (("fused", None), ("unfused", bare)):
            st = tmodel.RWKVState(st0.shift.clone(), st0.wkv.clone(), st0.elapsed.clone())
            torch.cuda.synchronize()
            _kernels.reset_launches()
            t0 = time.perf_counter()
            if kind == "chunk":
                tmodel.forward_chunk(m.params, tokens, st, wkv_fn=fn, **kw)
                logits = None
            else:
                logits = tmodel.forward_step(m.params, tokens, st, wkv_fn=fn, **kw)[0]
            torch.cuda.synchronize()
            runs[label] = (logits, st, (time.perf_counter() - t0) * 1e3, dict(_kernels.LAUNCHES))
        (l_f, s_f, ms_f, _), (l_u, s_u, ms_u, launches) = runs["fused"], runs["unfused"]
        expected = expected_launches(L, m.mm8_core, kind)
        expected.update({"wkv7_step_fused": 0, "wkv7_chunk_fused": 0, "penalty_tail": 0,
                         "sample_exact_rows": 0, "wkv7_batch_bf16" if bf16 else "wkv7_batch": L})
        require(launches == expected,
                f"path B {precision} {kind}: launches {launches}, expected {expected}")
        errs, excess = {}, {}
        pairs = [("shift", s_u.shift, s_f.shift), ("wkv", s_u.wkv, s_f.wkv),
                 ("wkv layer 0", s_u.wkv[0], s_f.wkv[0])]
        if logits is not None:
            require(tuple(l_u.shape) == (B, V) and bool(torch.isfinite(l_u).all()),
                    "path B: logits not finite or of the wrong shape")
            pairs.insert(0, ("logits", l_u, l_f))
            top2 = torch.topk(l_f.float(), 2, dim=-1).values
            scale = float(l_f.float().abs().max())
            clear = (top2[:, 0] - top2[:, 1]) > 2 * tol * scale
            diff = l_u.float().argmax(-1) != l_f.float().argmax(-1)
            require(not bool((diff & clear).any()), "path B: greedy tokens differ")
        for name, got, want in pairs:
            errs[name] = max_abs(got, want) / float(want.float().abs().max())
            excess[name] = bf16_excess(got, want)
        require(torch.equal(s_u.elapsed, s_f.elapsed), f"path B {kind}: elapsed differs")
        require(max(v for k, v in errs.items() if k != "wkv layer 0") <= tol,
                f"path B {kind}: unfused vs fused err of scale {errs} > {tol}")
        label = f"forward_chunk ({P}, {T})" if kind == "chunk" else f"forward_step at batch {B}"
        log(f"path B {label}, 7.2B width, mm8_core {m.mm8_core!r}, precision {precision!r}: "
            f"launches {launches}; "
            f"unfused {ms_u:.1f} ms, fused {ms_f:.1f} ms (one call each, wall through a "
            f"synchronise); unfused vs fused err of scale "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (tol {tol}); per-element |err|/limit (2^-7|ref| + 2^-8 rms(ref)) "
            + ", ".join(f"{k} {v:.3f}" for k, v in excess.items()))
        results[kind] = dict(launches=launches, unfused_ms=ms_u, fused_ms=ms_f,
                             err_of_scale=errs, bf16_excess=excess)
        del runs, st0, s_f, s_u, l_f, l_u
        torch.cuda.empty_cache()
    if not bf16:
        results["layer0_float32"] = unfused_layer0_float32(dev, m, B, P, T)
    return results


def unfused_layer0_float32(dev, m, B, P, T):
    """Where the bf16 disagreement of the two TMix forms comes from, at full
    width on layer 0 (a one-layer state runs the first layer, then the head):
    with float32 activations and state, the unfused form must agree with the
    fused kernels per element within the WKV kernels' limit on the layer's
    state, its token shifts and the logits. A second unfused run rounds only
    what the bf16 glue rounds around the bare kernel (k~, -kk, kk*a and y) to
    bf16 and is reported beside it."""
    import dataclasses

    from chirrup_tpu_torch.models import rwkv7 as tmodel
    from chirrup_tpu_torch.ops.wkv7_cuda import wkv7_batch

    f32, bf = torch.float32, torch.bfloat16
    cfg1 = dataclasses.replace(m.config, n_layer=1)
    params = tmodel.cast_dense(m.params, f32)
    gen = torch.Generator(device=dev).manual_seed(12)
    kw = dict(compute_dtype=f32, use_dither=m.runtime.use_dither, mm8_core=m.mm8_core)

    def glue_in_bf16(state, r, w, k, v, a, b, *rest, **kwargs):
        rnd = lambda t: t.to(bf).to(t.dtype)
        return rnd(wkv7_batch(state, r, w, rnd(k), v, rnd(a), rnd(b), *rest, **kwargs))

    out = {}
    for kind, n in (("chunk", P), ("step", B)):
        st0 = tmodel.init_state(cfg1, n, shift_dtype=f32, wkv_dtype=f32, device=dev)
        if kind == "step":
            st0.wkv.copy_(torch.randn(st0.wkv.shape, generator=gen, device=dev) * 0.3)
            st0.shift.copy_(torch.randn(st0.shift.shape, generator=gen, device=dev))
            st0.elapsed.copy_(torch.randint(0, 2 ** 31 - 1, (n,), generator=gen, device=dev))
        shape = (n, T) if kind == "chunk" else (n,)
        tokens = torch.randint(1, cfg1.vocab_size, shape, generator=gen, device=dev,
                               dtype=torch.int32)
        runs = {}
        for label, fn in (("fused", None), ("unfused", wkv7_batch),
                          ("unfused, glue rounded to bf16", glue_in_bf16)):
            st = tmodel.RWKVState(st0.shift.clone(), st0.wkv.clone(), st0.elapsed.clone())
            if kind == "chunk":
                tmodel.forward_chunk(params, tokens, st, wkv_fn=fn, **kw)
                runs[label] = {}
            else:
                runs[label] = {"logits": tmodel.forward_step(params, tokens, st, wkv_fn=fn,
                                                             **kw)[0]}
            runs[label].update(shift=st.shift, wkv=st.wkv)
        torch.cuda.synchronize()
        ref = runs.pop("fused")
        excess = {label: {k: bf16_excess(got[k], ref[k]) for k in ref}
                  for label, got in runs.items()}
        require(all(torch.isfinite(t).all() for t in ref.values()),
                f"path B float32 layer 0 {kind}: fused results not finite")
        require(max(excess["unfused"].values()) <= 1,
                f"path B float32 layer 0 {kind}: per-element |err|/limit {excess['unfused']}")
        log(f"path B {kind} at float32, layer 0 only, 7.2B width: per-element |err|/limit "
            f"(2^-7|ref| + 2^-8 rms(ref)) against the fused kernels: "
            + "; ".join(f"{label} " + ", ".join(f"{k} {v:.4f}" for k, v in e.items())
                        for label, e in excess.items()))
        out[kind] = excess
        del runs, ref, st0, st
    del params
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- two trees compared

# the step kernel's dtype pairs (rows, state) timed by compare_step_tail:
# the served pair first, then a float32 state (RuntimeConfig's
# wkv_state_dtype) under bf16 and float32 rows, and float32 rows on a bf16
# state
STEP_PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
              (torch.float32, torch.float32), (torch.float32, torch.bfloat16))
TAIL_BATCHES = (32, 64, 128, 256, 512)


# --------------------------------------------------------- tensor parallel


def tp_mm8_shapes(tp, C=4096, F=16384, V=65536):
    """MM8_SHAPES at one rank's shard of tp: R/K/V, FFN Wk and the head
    column-parallel (each rank merges its own R/K/V), Wo and FFN Wv
    row-parallel (parallel/tp.py)."""
    return [("att R/K/V", C, 3 * C // tp, 3, "mix", False, True),
            ("att Wo", C // tp, C, 1, "mul", False, True),
            ("ffn Wk", C, F // tp, 1, "plain", True, True),
            ("ffn Wv", F // tp, C, 1, "plain", False, True),
            ("head", C, V // tp, 1, "plain", False, False)]


def tp_w16_sites(tp, C=4096, F=16384, V=65536):
    """W16_SITES at one rank's shard of tp."""
    return [("att R", C, C // tp, True), ("att K", C, C // tp, True),
            ("att V", C, C // tp, True), ("att Wo", C // tp, C, True),
            ("ffn Wk", C, F // tp, True), ("ffn Wv", F // tp, C, True),
            ("head", C, V // tp, False)]


def check_tp_shards(dev, gen, tps=(2, 4), B=64, prefill_rows=512, C=4096, L=32,
                    chunk_variants=((8, 64), (8, 256))):
    """Every kernel of the tensor-parallel path at the shard shapes of 7.2B
    under tp = 2 and 4, with the checks of the full-width phase (each against
    its plain version, planted faults, bound, plain and library times): the
    WKV step at batch B on H/tp heads, the WKV chunk at the compact prefill
    variants, the quantizer and the w8a8 GEMM at tp_mm8_shapes and the
    w8a16 GEMM at tp_w16_sites, at B rows and at `prefill_rows` (a prefill
    chunk; no head). The penalty tail and the exact-row sampler run on the
    gathered (B, V) logits, the full-width shapes checked above. Returns
    {tp: {kernel: {ms, bound_ms, bound_by, plain_ms, library_ms, max_abs_err,
    shape}}} (the headline site of each, as the kernels line) and the whole
    results by tp."""
    rows, whole = {}, {}
    for tp in tps:
        Cl = C // tp
        step = check_wkv(dev, gen, B=B, C=Cl, L=L, li=17)
        chunk = check_chunk(dev, gen, variants=chunk_variants, C=Cl, L=L, li=9)
        decode = [*check_mm8(dev, gen, B=B, shapes=tp_mm8_shapes(tp, C)),
                  check_w16(dev, gen, B=B, sites=tp_w16_sites(tp, C))]
        prefill = [*check_mm8(dev, gen, B=prefill_rows, shapes=tp_mm8_shapes(tp, C)[:4]),
                   check_w16(dev, gen, B=prefill_rows, sites=tp_w16_sites(tp, C)[3:6])]
        torch.cuda.empty_cache()
        keys = ("ms", "bound_ms", "bound_by", "plain_ms", "library_ms", "max_abs_err", "shape")
        rows[tp] = {k["name"]: {f: k.get(f) for f in keys} for k in (step, chunk, *decode)}
        whole[tp] = dict(step=step, chunk=chunk, decode=decode, prefill=prefill)
        log(f"tp {tp} shard shapes (C/tp {Cl}, H/tp {Cl // 64}, F/tp {16384 // tp}, "
            f"V/tp {65536 // tp}): " + "; ".join(
                f"{name} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}"
                + (f", library {r['library_ms']:.4f}" if r["library_ms"] is not None else "")
                + ")" for name, r in rows[tp].items()))
    return rows, whole


def tp_config(vocab, L, C, V, mm8_core="auto", dtype="bfloat16", tp=1):
    from chirrup_tpu_torch.engine.structures import ModelLoadConfig

    return ModelLoadConfig(model_path="<synthetic>", vocab_path=vocab, vocab_size=V,
                           quantization="int8", mm8_core=mm8_core, activation_dtype=dtype,
                           wkv_state_dtype=dtype, tensor_parallel=tp,
                           synthetic_config=dict(n_layer=L, n_embd=C, vocab_size=V))


def random_state(carry, gen):
    """A random recurrent state in every slot (as check_graphs draws one)."""
    st = carry.state
    st.shift.copy_(torch.randn(st.shift.shape, generator=gen, device=st.shift.device))
    for li in range(st.wkv.shape[0]):
        st.wkv[li].copy_((torch.randn(st.wkv[li].shape, generator=gen, device=st.wkv.device)
                          * 0.3).to(st.wkv.dtype))
    st.elapsed.copy_(torch.randint(0, 2 ** 20, st.elapsed.shape, generator=gen,
                                   device=st.elapsed.device, dtype=torch.int32))


def run_tp1(dev, m0, B=64, L=32, C=4096, V=65536, n_tok=16, long_prompt=1024, blocks=4,
            seed=23, backend="nccl"):
    """The tensor-parallel path at tp = 1 over a real one-rank NCCL group, with
    graphs, at 7.2B width: AsyncEngineCore.init(tensor_parallel=1,
    tp_backend="nccl") builds its own model from the seed of the meshless
    engine's (m0) weights, warms up and captures every serving program with
    the collectives inside (two all-reduces a layer, the vocabulary gather a
    step). Requirements: five greedy requests (four short, one of
    `long_prompt` tokens) give the tokens of a meshless engine on m0's
    weights; from one random state, a greedy K-step block gives m0's tokens
    and carry bit for bit; the launches of the path's kernels a step (one
    replay under sync debug mode "error") and a compact chunk equal m0's (the
    collectives are not counted). Then steady decode in turns (m0, tp1, tp1,
    m0), `blocks` blocks each, and one profiled block each: ms a step and
    device busy of the tp path itself beside meshless."""
    import numpy as np
    from chirrup_tpu_torch.engine.engine import AsyncEngineCore
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.ops import _kernels
    from chirrup_tpu_torch.utils.tokenizer import WorldTokenizer

    tmp = tempfile.TemporaryDirectory()
    vocab = os.path.join(tmp.name, "vocab.txt")
    write_vocab(vocab, V)
    cfg = tp_config(vocab, L, C, V)
    gen = torch.Generator().manual_seed(seed)
    requests = [(f"Request {i}: tensor parallel at one rank", None, 0.0, 0.0) for i in range(4)]
    requests.append(("", torch.randint(1, V, (long_prompt,), generator=gen).tolist(), 0.0, 0.0))
    out = {}

    async def serve(engine_kw, model_factory=None, measure=None):
        engine = AsyncEngineCore()
        t0 = time.perf_counter()
        try:
            await engine.init(worker_num=1, model_config=cfg, batch_size=B, load_timeout=900,
                              device=dev, model_factory=model_factory, warmup_programs=True,
                              **engine_kw)
            load_s = time.perf_counter() - t0
            _kernels.reset_launches()
            comps = [engine.completion(p, prefill_tokens=ids, max_tokens=n_tok, stop_tokens=(),
                                       temperature=t, presence_penalty=pen,
                                       frequency_penalty=pen) for p, ids, t, pen in requests]
            await asyncio.gather(*[c.get_full_completion() for c in comps])
            launches = dict(_kernels.LAUNCHES)
            toks = [list(c.task.generated_tokens) for c in comps]
            extra = measure(engine.workers[0].model) if measure is not None else None
            return toks, launches, load_s, extra
        finally:
            engine.shutdown()
            engine.join(timeout=60)

    def measure(m1):
        """Against m0 while the tp engine is up (its worker idles)."""
        require(m1.tp is not None and m1.tp.backend == backend and m1.tp.world == 1
                and m1.graphs == (dev.type == "cuda"),
                "the tp engine's model is not a captured one-rank NCCL model")
        K = 16
        res = {}
        carries = {"meshless": m0.init_carry(), "tp1": m1.init_carry()}
        models = {"meshless": m0, "tp1": m1}
        for name, c in carries.items():
            for s in range(B):
                models[name].insert_slot(c, s, None, Greedy)
            random_state(c, torch.Generator(device=dev).manual_seed(seed))
        ones = np.ones((K, B), bool)
        first = ones.copy()
        first[0] = False
        tokens = np.full((K, B), 300, np.int32)
        sampled = {n: models[n].decode_block(c, tokens, first, ones, ones)[1].cpu()
                   for n, c in carries.items()}
        require(torch.equal(sampled["tp1"], sampled["meshless"])
                and not carry_diff(carries["tp1"], carries["meshless"]),
                f"tp1: a greedy block differs from meshless (carry fields "
                f"{carry_diff(carries['tp1'], carries['meshless'])})")
        per_step = {}
        for n, c in carries.items():
            _kernels.reset_launches()
            torch.cuda.set_sync_debug_mode("error")
            try:
                models[n].decode_block(c, tokens, ones, ones, ones)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            per_step[n] = {k: v / K for k, v in _kernels.LAUNCHES.items()}
        require(per_step["tp1"] == per_step["meshless"] == expected_launches(L, "auto", "step"),
                f"tp1 launches a step {per_step['tp1']}, meshless {per_step['meshless']}")
        P, T = m1.prefill_variants[0]
        per_chunk = {}
        for n, c in carries.items():
            models[n].prefill_step_compact(c, np.full((P, T), 300, np.int32),
                                           np.full((P,), T, np.int32), np.arange(P, dtype=np.int32))
            torch.cuda.synchronize()
            _kernels.reset_launches()
            models[n].prefill_step_compact(c, np.full((P, T), 300, np.int32),
                                           np.full((P,), T, np.int32), np.arange(P, dtype=np.int32))
            torch.cuda.synchronize()
            per_chunk[n] = dict(_kernels.LAUNCHES)
        require(per_chunk["tp1"] == per_chunk["meshless"] == expected_launches(L, "auto", "chunk"),
                f"tp1 launches a chunk {per_chunk['tp1']}, meshless {per_chunk['meshless']}")
        require(not carry_diff(carries["tp1"], carries["meshless"]),
                "tp1: the carry after two compact chunks differs from meshless")
        steady = {"meshless": [], "tp1": []}
        for n in ("meshless", "tp1", "tp1", "meshless"):
            steady[n].append(steady_decode(models[n], carries[n], K, blocks))
        for n in ("meshless", "tp1"):
            busy, by_kernel, groups, averages = profile_block(models[n], carries[n], K)
            with open(os.path.join(OUT_DIR, f"chip_smoke_tp1_{n}_profile.txt"), "w") as f:
                f.write(averages.table(sort_by="self_cuda_time_total", row_limit=40))
            # the profiler may drop events at the edge of its window: the share
            # of the block it saw, by the WKV steps (L a step)
            seen = sum(c for k, _, c in by_kernel if "wkv7_step_fused_kernel" in k) / L or 1.0
            dtod = sum(c for k, _, c in by_kernel if "Memcpy DtoD" in k) / seen
            step_ms = statistics.median(s["step_ms"] for s in steady[n])
            busy = None if busy is None else busy / seen
            res[n] = dict(step_ms_turns=[s["step_ms"] for s in steady[n]], step_ms=step_ms,
                          decode_tok_s=B / step_ms * 1e3, device_busy_step_ms=busy,
                          idle_share=None if busy is None else 1 - busy / step_ms,
                          steps_profiled=seen * K, dtod_copies_step=dtod,
                          device_ops_step=sum(c for _, _, c in by_kernel) / seen,
                          host_dispatch_ms=[x for s in steady[n] for x in s["host_dispatch_ms"]])
            log(f"tp1 vs meshless, {n}: {step_ms:.3f} ms a step (median of turns "
                f"{[round(s['step_ms'], 3) for s in steady[n]]}), "
                f"{res[n]['decode_tok_s']:.1f} tok/s; host dispatch a block "
                f"{spread(res[n]['host_dispatch_ms'])} ms; device busy "
                + (f"{busy:.3f} ms a step, idle {100 * res[n]['idle_share']:.1f}%"
                   if busy is not None else "not measured")
                + f" ({seen * K:.3f} of {K} steps in the profiler's window); "
                  f"{res[n]['device_ops_step']:g} device operations a step, of them "
                  f"{dtod:g} device-to-device copies (a one-rank NCCL collective is one, "
                  f"or nothing in place)")
        res["per_step"], res["per_chunk"] = per_step["tp1"], per_chunk["tp1"]
        return res

    toks1, launches1, load1, res = asyncio.run(serve(
        dict(tensor_parallel=1, tp_backend=backend, tp_devices=[dev]), measure=measure))
    shared = lambda: (ServingModel(m0.config, m0.params, m0.runtime, B,
                                   prefill_chunk=m0.prefill_chunk, device=dev),
                      WorldTokenizer(vocab))
    toks0, launches0, load0, _ = asyncio.run(serve({}, model_factory=shared))
    require(toks1 == toks0 and all(len(t) == n_tok for t in toks1),
            f"tp1: the engine's greedy tokens differ from the meshless engine's")
    on_path = {n for kind in ("step", "chunk")
               for n, c in expected_launches(L, "auto", kind).items() if c > 0}
    for name, count in launches1.items():
        require((count > 0) == (name in on_path),
                f"tp1 engine: kernel {name} launched {count} times")
    log(f"tp1 engine (one-rank NCCL group, graphs): loaded, warmed and captured in {load1:.1f} s "
        f"(meshless on shared weights {load0:.1f} s); {len(requests)} greedy requests "
        f"({long_prompt}-token prompt among them) equal to meshless token for token; launches "
        f"over them {launches1} (meshless {launches0})")
    out.update(res, load_s=load1, meshless_load_s=load0, launches=launches1,
               meshless_launches=launches0, tokens_equal=True)
    tmp.cleanup()
    return out


def run_tp2_shared_card(dev, B=8, L=8, C=4096, V=65536, prompt=60, steps=16, seed=29):
    """tp = 2 as two processes sharing the one card over gloo (NCCL refuses
    two ranks on one device), eager (gloo collectives stage through the
    host, which a graph cannot capture), at 7.2B width and depth L, float32
    activations and state, under each INT8 core: rank 0 here, rank 1 spawned
    (tp.start), each building its shard of the synthetic model (seed 0), and
    the meshless model on the same weights. One prompt is prefilled (compact
    chunk) and `steps` greedy steps run. Requirements: the first step's
    logits within the CPU tests' limit of the meshless model's (w8a16
    "pallas": 2e-4 of scale, tests/test_torch_tp.py; w8a8: 5e-2), elapsed
    equal, every rank's replicated carry (tokens, penalties, shift) bit-equal
    after every step (replica_report), and each rank's launch counters
    showing the path's kernels at the shard shapes. Its wall time is a check
    of correctness over host-staged collectives, not a tp rate."""
    import dataclasses
    import functools

    import numpy as np
    from chirrup_tpu_torch.engine.engine import build_serving_model
    from chirrup_tpu_torch.ops import _kernels
    from chirrup_tpu_torch.parallel import tp as tp_mod

    tmp = tempfile.TemporaryDirectory()
    vocab = os.path.join(tmp.name, "vocab.txt")
    write_vocab(vocab, V)
    ids = torch.randint(1, V, (prompt,), generator=torch.Generator().manual_seed(seed)).tolist()
    out = {}
    for core, tol in (("pallas", 2e-4), ("auto", 5e-2)):
        cfg = tp_config(vocab, L, C, V, mm8_core=core, dtype="float32", tp=2)
        meshless = build_serving_model(dataclasses.replace(cfg, tensor_parallel=1), B,
                                       device=dev, seed=0, graphs=False)
        build = functools.partial(build_serving_model, cfg, B, seed=0, graphs=False)
        t0 = time.perf_counter()
        connect, procs = tp_mod.start(2, build, [dev, dev], backend="gloo", timeout=300)
        model = None
        try:
            ctx = connect()
            model = build(ctx)
            load_s = time.perf_counter() - t0
            require(model.wkv_width == C // 2 and model.params["head"].q.shape[-1] == V // 2,
                    "tp2: rank 0 does not hold its shard")
            _kernels.reset_launches()
            t0 = time.perf_counter()
            results, reports = {}, []
            for name, m in (("tp2", model), ("meshless", meshless)):
                c = m.init_carry()
                m.insert_slot(c, 0, None, Greedy)
                P, T = m.prefill_variants[0]
                toks = np.zeros((P, T), np.int32)
                toks[0, :prompt - 1] = ids[:-1]
                lengths = np.zeros((P,), np.int32)
                lengths[0] = prompt - 1
                m.prefill_step_compact(c, toks, lengths, np.arange(P, dtype=np.int32))
                act = np.zeros((B,), bool)
                act[0] = True
                step = np.zeros((B,), np.int32)
                step[0] = ids[-1]
                fb = np.zeros((B,), bool)
                sampled, first = [], None
                for k in range(steps):
                    c, s, raw = m.decode_step(c, step, act, act, fb)
                    if first is None:
                        first = raw[0].float().cpu()
                    sampled.append(int(s[0]))
                    fb = act.copy()
                    if name == "tp2":
                        reports.append(m.replica_report(c))
                results[name] = dict(first=first, tokens=sampled,
                                     elapsed=int(c.state.elapsed[0]))
                if name == "tp2":
                    wall = time.perf_counter() - t0
                    launches = [r["launches"] for r in reports[-1]]
        finally:
            if model is not None:
                model.close()
            codes = tp_mod.stop(procs, 60.0)
        require(codes == [0], f"tp2 ({core}): the follower exited with {codes}")
        a, b = results["tp2"]["first"], results["meshless"]["first"]
        scale = float(b.abs().max())
        err = max_abs(a, b)
        require(bool(torch.isfinite(a).all()) and err <= tol * scale,
                f"tp2 ({core}): first-step logits err {err} > {tol} * {scale}")
        require(results["tp2"]["elapsed"] == results["meshless"]["elapsed"] == prompt - 1 + steps,
                f"tp2 ({core}): elapsed {results['tp2']['elapsed']} against "
                f"{results['meshless']['elapsed']}")
        for k, rep in enumerate(reports):
            require(len(rep) == 2 and rep[0]["digest"] == rep[1]["digest"]
                    and rep[0]["last_sampled"] == rep[1]["last_sampled"],
                    f"tp2 ({core}): the ranks' carries differ after step {k}")
        mm8 = ("mm8_w16_gemm",) if core == "pallas" else ("mm8_a8_quant_rows", "mm8_a8_gemm")
        for r, counts in enumerate(launches):
            for name in ("wkv7_chunk_fused", "wkv7_step_fused", "penalty_tail",
                         "sample_exact_rows", *mm8):
                require(counts[name] > 0, f"tp2 ({core}): rank {r} never launched {name}")
        same = results["tp2"]["tokens"] == results["meshless"]["tokens"]
        log(f"tp2 on one card over gloo ({core}, L{L} C{C} V{V}, float32, B{B}): ranks joined "
            f"and built in {load_s:.1f} s; first-step logits {err:.3e} from meshless "
            f"({err / scale:.2e} of scale {scale:.3f}; limit {tol}); elapsed "
            f"{results['tp2']['elapsed']}; {steps} greedy steps, the two ranks' carries bit-equal "
            f"after each; tokens {'equal to' if same else 'not equal to'} meshless "
            f"({results['tp2']['tokens'][:8]}...); wall {wall:.2f} s for the prefill and "
            f"{steps} steps with {len(reports)} replica reports (a correctness check over "
            f"host-staged collectives, not a tp rate); launches by rank {launches}")
        out[core] = dict(first_logits_err=err, scale=scale, limit=tol,
                         elapsed=results["tp2"]["elapsed"], tokens=results["tp2"]["tokens"],
                         tokens_equal_meshless=same, wall_s=wall, load_s=load_s,
                         launches_by_rank=launches)
        del meshless
        gc.collect()
        torch.cuda.empty_cache()
    tmp.cleanup()
    return out


def run_tp_cards(n, B=64, L=32, C=4096, V=65536, n_tok=16, long_prompt=1024, blocks=4,
                 prompt=60, devices=None, backend=None, seed=31):
    """`--tp N`: the engine at tensor_parallel=N over NCCL, rank r on CUDA
    device r (devices and backend given only to rehearse on the CPU), w8a8,
    bf16, graphs, 7.2B width, against the meshless model on device 0 with
    the same weights. Five greedy requests (one of `long_prompt` tokens)
    through the tp engine and through a meshless engine on the meshless
    model's weights (tokens compared and counted: per-rank activation scales
    may move a near tie); then, while the tp engine idles, one prompt
    prefilled into every slot of a new carry of each model and a first
    decode step, whose logits must agree within the w8a8 limit of the CPU
    tests (5e-2 of scale), the ranks' carries bit-equal (replica_report)
    after it and after steady decode, each rank's launches of the path's
    kernels; steady decode in turns (meshless, tp, tp, meshless), `blocks`
    blocks of 16 each, and one profiled block each (rank 0's device busy):
    the tp rate of one model over N cards beside one card's."""
    import dataclasses

    import numpy as np
    from chirrup_tpu_torch.engine.engine import AsyncEngineCore, build_serving_model
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.ops import _kernels
    from chirrup_tpu_torch.utils.tokenizer import WorldTokenizer

    dev = torch.device("cuda", 0) if devices is None else torch.device(devices[0])
    tmp = tempfile.TemporaryDirectory()
    vocab = os.path.join(tmp.name, "vocab.txt")
    write_vocab(vocab, V)
    cfg = tp_config(vocab, L, C, V, tp=n)
    m0 = build_serving_model(dataclasses.replace(cfg, tensor_parallel=1), B, device=dev, seed=0)
    gen = torch.Generator().manual_seed(seed)
    requests = [(f"Request {i}: one model over {n} cards", None) for i in range(4)]
    requests.append(("", torch.randint(1, V, (long_prompt,), generator=gen).tolist()))
    ids = torch.randint(1, V, (prompt,), generator=gen).tolist()
    K = 16
    out = {}

    async def serve(engine_kw, model_factory=None, measure=None):
        engine = AsyncEngineCore()
        t0 = time.perf_counter()
        try:
            await engine.init(worker_num=1, model_config=cfg, batch_size=B, load_timeout=600,
                              model_factory=model_factory, warmup_programs=True, **engine_kw)
            load_s = time.perf_counter() - t0
            _kernels.reset_launches()
            comps = [engine.completion(p, prefill_tokens=i, max_tokens=n_tok, stop_tokens=(),
                                       temperature=0.0, presence_penalty=0.0,
                                       frequency_penalty=0.0) for p, i in requests]
            await asyncio.gather(*[c.get_full_completion() for c in comps])
            toks = [list(c.task.generated_tokens) for c in comps]
            extra = measure(engine.workers[0].model) if measure is not None else None
            return toks, load_s, extra
        finally:
            engine.shutdown()
            engine.join(timeout=60)

    def measure(m):
        require(m.tp is not None and m.tp.world == n and m.graphs == (dev.type == "cuda"),
                f"the tp engine's model is not a captured {n}-rank model")
        models = {"meshless": m0, f"tp{n}": m}
        carries, first = {}, {}
        for name, mod in models.items():
            c = mod.init_carry()
            for s in range(B):
                mod.insert_slot(c, s, None, Greedy)
            P, T = mod.prefill_variants[0]
            for start in range(0, B, P):
                toks = np.zeros((P, T), np.int32)
                toks[:, :prompt - 1] = ids[:-1]
                mod.prefill_step_compact(c, toks, np.full((P,), prompt - 1, np.int32),
                                         np.arange(start, start + P, dtype=np.int32))
            on = np.ones((B,), bool)
            c, _, raw = mod.decode_step(c, np.full((B,), ids[-1], np.int32), on, on)
            first[name] = raw.float().cpu()
            carries[name] = c
        a, b = first[f"tp{n}"], first["meshless"]
        scale = float(b.abs().max())
        err = max_abs(a, b)
        require(bool(torch.isfinite(a).all()) and err <= 5e-2 * scale,
                f"tp{n}: first-step logits err {err} > 5e-2 * {scale}")
        report = m.replica_report(carries[f"tp{n}"])
        require(len({r["digest"] for r in report}) == 1, f"tp{n}: the ranks' carries differ")
        ones = np.ones((K, B), bool)
        for name, c in carries.items():  # the block's capture on this carry
            models[name].decode_block(c, np.full((K, B), 300, np.int32), ones, ones, ones)
        steady = {k: [] for k in models}
        for name in ("meshless", f"tp{n}", f"tp{n}", "meshless"):
            steady[name].append(steady_decode(models[name], carries[name], K, blocks))
        report = m.replica_report(carries[f"tp{n}"])
        require(len({r["digest"] for r in report}) == 1,
                f"tp{n}: the ranks' carries differ after steady decode")
        res = dict(first_logits_err=err, scale=scale,
                   launches_by_rank=[r["launches"] for r in report])
        for name in models:
            busy, by_kernel, _, averages = profile_block(models[name], carries[name], K)
            with open(os.path.join(OUT_DIR, f"chip_smoke_tp_cards_{name}_profile.txt"),
                      "w") as f:
                f.write(averages.table(sort_by="self_cuda_time_total", row_limit=40))
            seen = sum(c for k, _, c in by_kernel if "wkv7_step_fused_kernel" in k) / L or 1.0
            busy = None if busy is None else busy / seen
            nccl = sum(ms for k, ms, _ in by_kernel if "nccl" in k.lower()) / seen
            step_ms = statistics.median(s["step_ms"] for s in steady[name])
            res[name] = dict(step_ms_turns=[s["step_ms"] for s in steady[name]],
                             step_ms=step_ms, decode_tok_s=B / step_ms * 1e3,
                             device_busy_step_ms=busy, nccl_ms_step=nccl,
                             host_dispatch_ms=[x for s in steady[name]
                                               for x in s["host_dispatch_ms"]])
            log(f"tp on {n} cards, {name}: {step_ms:.3f} ms a step (turns "
                f"{[round(s['step_ms'], 3) for s in steady[name]]}), "
                f"{res[name]['decode_tok_s']:.1f} tok/s; host dispatch a block "
                f"{spread(res[name]['host_dispatch_ms'])} ms; card 0 busy "
                + (f"{busy:.3f} ms a step" if busy is not None else "not measured")
                + f", of it NCCL kernels {nccl:.4f} ms")
        return res

    tp_kw = dict(tp_timeout=120) if devices is None else dict(
        tp_devices=devices, tp_backend=backend, tp_timeout=120)
    toks_tp, load_tp, res = asyncio.run(serve(tp_kw, measure=measure))
    shared = lambda: (ServingModel(m0.config, m0.params, m0.runtime, B,
                                   prefill_chunk=m0.prefill_chunk, device=dev),
                      WorldTokenizer(vocab))
    toks_0, load_0, _ = asyncio.run(serve(dict(device=dev, tensor_parallel=1),
                                          model_factory=shared))
    equal = sum(a == b for a, b in zip(toks_tp, toks_0))
    require(all(len(t) == n_tok for t in toks_tp), f"tp{n}: a request fell short")
    mm8 = ("mm8_a8_quant_rows", "mm8_a8_gemm")
    for r, counts in enumerate(res["launches_by_rank"]):
        for name in ("wkv7_chunk_fused", "wkv7_step_fused", "penalty_tail", "sample_exact_rows",
                     *mm8):
            require(counts[name] > 0, f"tp{n}: rank {r} never launched {name}")
    log(f"tp on {n} cards (NCCL, graphs, L{L} C{C} V{V}, batch {B}): engine loaded, warmed and "
        f"captured in {load_tp:.1f} s (meshless {load_0:.1f} s); {equal} of {len(requests)} "
        f"greedy requests token for token equal to meshless; first-step logits "
        f"{res['first_logits_err']:.3e} from meshless ({res['first_logits_err'] / res['scale']:.2e}"
        f" of scale); the ranks' carries bit-equal; launches by rank {res['launches_by_rank']}")
    out.update(res, load_s=load_tp, meshless_load_s=load_0, requests_equal=equal,
               requests=len(requests))
    tmp.cleanup()
    return out


# ------------------------------------------------- multi-host and multi-group


def check_launch_sum(what, launches, steps, chunks, L, core="auto"):
    """A worker's or host's launches of the path's kernels equal `steps`
    decode steps' and `chunks` compact chunks' of the meshless path
    (expected_launches: 32/129/129/1/1 a step, 32/128/128 a chunk at 7.2B
    under w8a8); the collectives are not counted."""
    step, chunk = expected_launches(L, core, "step"), expected_launches(L, core, "chunk")
    want = {n: steps * step[n] + chunks * chunk[n] for n in step}
    got = {n: launches.get(n, 0) for n in step}
    require(steps > 0 and got == want,
            f"{what}: launches {got} over {steps} steps and {chunks} chunks, "
            f"a meshless path's {want}")
    return {n: c for n, c in got.items() if c}


def run_lockstep(dev, model, L=32, C=4096, V=65536, n_tok=64, long_prompt=1024):
    """Lockstep serving as two host processes sharing the one card
    (parallel/dryrun_multihost.launch: MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK as torchrun sets them; the vote group over gloo on localhost), w8a8,
    bf16, graphs, each host its own replica of the seed-0 model over 64 rows
    of a global batch of 128, the engine model `model` (batch 64, seed 0)
    the reference: (1) each host's programs on its rows equal `model`
    driving the same rows; (2) each host's lockstep Worker serves greedy
    requests (5 and 12 tokens and one of `long_prompt`) with `model`'s
    tokens under a worker without lockstep, its launches equal its steps x
    a step's + chunks x a chunk's, and a shutdown voted on host 1 stops
    both after the same loop; (3) each host's engine and HTTP server
    (lockstep, a state pool) resumes a chat completion from its prefix
    snapshot equal to its cold run. Printed: the vote's host us a loop,
    the quorum's seconds (host 1's vote to the last host's stop), each
    host's ms a decode step while the two share the card (not a rate)."""
    from chirrup_tpu_torch.parallel import dryrun_multihost as dryrun

    tmp = tempfile.TemporaryDirectory()
    vocab = os.path.join(tmp.name, "vocab.txt")
    write_vocab(vocab, V)
    cfg = dryrun.Config(layers=L, width=C, vocab=V, batch=2 * model.batch_size,
                        device=str(dev), dtype="bfloat16", quantization="int8",
                        prefill_chunk=model.prefill_chunk, graphs=True, n_tok=n_tok,
                        long_prompt=long_prompt, voter=1, vocab_path=vocab,
                        vote_timeout=300.0, tp_timeout=300.0)
    t0 = time.perf_counter()
    results = dryrun.require(dryrun.launch(2, dryrun.host_main, (cfg,), timeout=900))
    wall = time.perf_counter() - t0
    problems = dryrun.check(cfg, 2, results, model)
    require(not problems, "lockstep: " + "; ".join(problems))
    out = dict(wall_s=wall, hosts=[])
    for h, r in enumerate(results):
        w = r["worker"]
        launches = check_launch_sum(f"lockstep host {h}", w["launches"], w["steps"], w["chunks"],
                                    L)
        out["hosts"].append(dict(rows=[r["programs"]["rows"][0], r["programs"]["rows"][-1]],
                                 stop_loop=w["stop_loop"], vote_us=w["vote_us"],
                                 vote_loops=w["vote_loops"], ms_step_sharing_card=w["ms_step"],
                                 steps=w["steps"], chunks=w["chunks"], launches=launches,
                                 tokens=w["tokens"], server=r["server"]))
    quorum_s = (max(r["worker"]["stopped_at"] for r in results)
                - results[1]["worker"]["vote_started"])
    out["quorum_shutdown_s"] = quorum_s
    for h, o in enumerate(out["hosts"]):
        log(f"lockstep host {h} of 2 (L{L} C{C} V{V}, w8a8, graphs, rows {o['rows'][0]}.."
            f"{o['rows'][1]} of {cfg.batch}): programs and {len(o['tokens'])} greedy requests (one of "
            f"{long_prompt} tokens) equal to the meshless engine model; stopped after loop "
            f"{o['stop_loop']}; vote {o['vote_us']:.1f} us of host time a loop over "
            f"{o['vote_loops']} loops; {o['ms_step_sharing_card']} ms a decode step with "
            f"two hosts sharing one card (not a rate); launches {o['launches']} over "
            f"{o['steps']} steps and {o['chunks']} chunks; server: cold == resumed, "
            f"{o['server']['cache_hits']} cache hit(s)")
    log(f"lockstep: quorum shutdown voted on host 1 stopped both hosts after loop "
        f"{out['hosts'][0]['stop_loop']} in {quorum_s:.3f} s; the phase took {wall:.1f} s "
        f"(two host processes, three phases each)")
    tmp.cleanup()
    torch.cuda.empty_cache()
    return out


async def _burst(port, bodies):
    t0 = time.perf_counter()
    rs = await asyncio.gather(*[http_call(port, "POST", "/v1/chat/completions", b)
                                for b in bodies], return_exceptions=True)
    return rs, time.perf_counter() - t0


def _served(port):
    """Requests a port server has completed (its /metrics TTFT samples)."""
    ttft = json.loads(http_sync(port, "GET", "/metrics")["body"])["ttft_breakdown"]
    return 0 if ttft is None else ttft["n"]


def run_router(dev, L=8, C=4096, V=65536, B=64, burst=64, burst_tokens=128):
    """Two port servers (`python -m chirrup_tpu_torch.server`, 7.2B width cut
    to L layers, --profile h100-7b2) as processes on the card behind `python
    -m chirrup_tpu_torch.server.router`: a burst of `burst` streams x
    `burst_tokens` tokens straight to server 0, then the same through the
    router (tok/s at the client both ways and their ratio, the split between
    the backends, time to the first data frame); then a burst through the
    router during which server 1 is killed: every request sent after the
    kill is served whole by server 0, and the router's /health shows one
    backend healthy and the other's error; SIGINT stops the router and
    server 0 with exit code 0."""
    tmp = tempfile.TemporaryDirectory()
    vocab = os.path.join(tmp.name, "vocab.txt")
    write_vocab(vocab, V)
    args = ["--synthetic-model", f"{L},{C}", "--vocab-path", vocab, "--vocab-size", str(V),
            "--profile", "h100-7b2", "--batch-size", str(B)]
    backends = [ServerProcess(args, log_name=f"chip_smoke_router_b{i}.log") for i in range(2)]
    router = None
    out = {}
    try:
        out["backend_healthy_s"] = [b.wait_healthy() for b in backends]
        router = ServerProcess(["--backends", ",".join(f"http://127.0.0.1:{b.port}"
                                                       for b in backends)],
                               module="chirrup_tpu_torch.server.router",
                               log_name="chip_smoke_router.log")
        router.wait_healthy()
        body = [dict(model="rwkv-latest:no-thinking", temperature=1.0, ignore_eos=True,
                     max_tokens=burst_tokens, stream=True, use_state_cache=False,
                     cache_prefill=False,
                     messages=[{"role": "user", "content": f"Request {i}: go on"}])
                for i in range(burst)]
        # a warm-up request each way, then the two bursts
        for port in (backends[0].port, router.port):
            require(http_sync(port, "POST", "/v1/chat/completions", body[0])["status"] == 200,
                    "router: warm-up request failed")
        runs = {}
        for name, port in (("direct", backends[0].port), ("router", router.port)):
            before = [_served(b.port) for b in backends]
            rs, wall = asyncio.run(_burst(port, body))
            n = 0
            for r in rs:
                require(not isinstance(r, BaseException) and r["status"] == 200,
                        f"router: {name} burst request failed: {r!r:.300}")
                _, k, reason = sse_result(r["body"])
                require(k == burst_tokens, f"router: {name} burst request gave {k} tokens")
                n += k
            ttfb = sorted(r["first_data_s"] for r in rs)
            split = [_served(b.port) - x for b, x in zip(backends, before)]
            runs[name] = dict(tok_s=n / wall, wall_s=wall, split=split,
                              first_data_p50_s=ttfb[len(ttfb) // 2], first_data_max_s=ttfb[-1])
        require(runs["router"]["split"] in ([burst // 2, burst - burst // 2],
                                            [burst - burst // 2, burst // 2]),
                f"router: split {runs['router']['split']} of {burst}")
        out.update(runs, ratio=runs["router"]["tok_s"] / runs["direct"]["tok_s"])
        log(f"router (L{L} C{C} V{V}, w8a8, batch {B} a server, two servers sharing one card): "
            f"{burst} streams x {burst_tokens} tokens straight to one server "
            f"{runs['direct']['tok_s']:.1f} tok/s at the client, through the router "
            f"{runs['router']['tok_s']:.1f} tok/s, ratio {out['ratio']:.3f}; split "
            f"{runs['router']['split']}; first data frame p50 "
            f"{runs['direct']['first_data_p50_s']:.3f} s direct, "
            f"{runs['router']['first_data_p50_s']:.3f} s through the router (max "
            f"{runs['direct']['first_data_max_s']:.3f}, {runs['router']['first_data_max_s']:.3f})")

        # failover: half the burst with long replies, server 1 killed while it
        # streams them, then the other half
        long_body = [dict(b, max_tokens=8 * burst_tokens) for b in body[:burst // 2]]

        async def failover():
            first = [asyncio.create_task(http_call(router.port, "POST", "/v1/chat/completions",
                                                   b)) for b in long_body]
            await asyncio.sleep(1.0)
            backends[1].proc.kill()
            backends[1].proc.wait()
            t_kill = time.perf_counter()
            second = await asyncio.gather(*[http_call(router.port, "POST",
                                                      "/v1/chat/completions", b)
                                            for b in body[burst // 2:]], return_exceptions=True)
            return await asyncio.gather(*first, return_exceptions=True), second, t_kill

        before = _served(backends[0].port)
        first, second, _ = asyncio.run(failover())
        for r in second:
            require(not isinstance(r, BaseException) and r["status"] == 200,
                    f"router: a request after the kill failed: {r!r:.300}")
            require(sse_result(r["body"])[1] == burst_tokens,
                    "router: a request after the kill was cut short")
        whole = sum(1 for r in first if not isinstance(r, BaseException)
                    and r["status"] == 200 and b"data: [DONE]" in r["body"])
        served0 = _served(backends[0].port) - before
        health = http_sync(router.port, "GET", "/health")
        hb = json.loads(health["body"])
        dead = hb["backends"][f"http://127.0.0.1:{backends[1].port}"]
        require(health["status"] == 200 and hb["healthy_count"] == 1
                and str(dead["status"]).startswith("error"),
                f"router: /health after the kill {hb}")
        require(served0 == whole + len(second),
                f"router: server 0 completed {served0}, expected {whole} + {len(second)}")
        out["failover"] = dict(before_kill=burst // 2, completed_before_kill=whole,
                               broken=burst // 2 - whole, after_kill=len(second),
                               after_kill_served_by_0=len(second), health=hb)
        log(f"router failover: server 1 killed 1.0 s into {burst // 2} streams of "
            f"{8 * burst_tokens} tokens: {whole} of them "
            f"completed (server 0's), {burst // 2 - whole} broke off; all {len(second)} requests "
            f"sent after the kill served whole by server 0; /health: {hb['healthy_count']} "
            f"healthy, server 1 {dead['status']}")
    finally:
        codes = [router.stop() if router is not None else None] + [b.stop() for b in backends]
    require(codes[0] == 0 and codes[1] == 0,
            f"router: exit codes router {codes[0]}, server 0 {codes[1]} after SIGINT")
    out["exit_codes"] = codes
    tmp.cleanup()
    return out


def run_workers_tp_shared_card(dev, L=8, C=4096, V=65536, B=8, n_req=16, n_tok=8):
    """worker_num 2 x tensor_parallel 2 on the one card over gloo (NCCL
    refuses two ranks on one device), eager (gloo on CUDA cannot be
    captured), float32, w8a8, 7.2B width cut to L layers, batch B a worker,
    from a native checkpoint of the seed-0 INT8 tree (every worker the same
    weights): `n_req` greedy requests at once (more than one worker's slots)
    give a meshless engine's tokens on the same checkpoint, both workers
    serve, each worker's launches (its thread's, rank 0's) equal its steps x
    a step's + chunks x a chunk's, and both groups' followers exit 0."""
    from chirrup_tpu_torch.engine.engine import AsyncEngineCore
    from chirrup_tpu_torch.models import checkpoint, loader
    from chirrup_tpu_torch.models.config import RWKV7Config
    from chirrup_tpu_torch.ops import _kernels
    from chirrup_tpu_torch.engine.structures import ModelLoadConfig

    tmp = tempfile.TemporaryDirectory()
    vocab = os.path.join(tmp.name, "vocab.txt")
    write_vocab(vocab, V)
    path = os.path.join(tmp.name, "native")
    checkpoint.save_native(path, RWKV7Config(n_layer=L, n_embd=C, vocab_size=V),
                           loader.synthetic_params_int8(RWKV7Config(n_layer=L, n_embd=C,
                                                                    vocab_size=V),
                                                        seed=0, device=dev))
    torch.cuda.empty_cache()
    prompts = [f"Request {i}: tell me more" for i in range(n_req)]
    greedy = dict(temperature=0.0, max_tokens=n_tok, stop_tokens=[], presence_penalty=0.0,
                  frequency_penalty=0.0)

    def mc(tp):
        return ModelLoadConfig(model_path=path, vocab_path=vocab, vocab_size=V,
                               quantization="int8", activation_dtype="float32",
                               wkv_state_dtype="float32", tensor_parallel=tp)

    async def serve(worker_num, tp):
        eng = AsyncEngineCore()
        t0 = time.perf_counter()
        kw = dict(tp_devices=[dev] * (worker_num * tp), tp_backend="gloo") if tp > 1 else {}
        await eng.init(worker_num=worker_num, model_config=mc(tp), batch_size=B, device=dev,
                       graphs=False, load_timeout=600, **kw)
        load_s = time.perf_counter() - t0
        try:
            _kernels.reset_launches()
            steps0 = [(w.steps_run, w.chunks_run) for w in eng.workers]
            t0 = time.perf_counter()
            comps = [eng.completion(p, **greedy) for p in prompts]
            toks = await asyncio.gather(*[_tokens_of(c) for c in comps])
            wall = time.perf_counter() - t0
            per = [dict(steps=w.steps_run - s, chunks=w.chunks_run - c,
                        launches=_kernels.thread_launches(f"chirrup_tpu_torch:{w.worker_id}"))
                   for w, (s, c) in zip(eng.workers, steps0)]
        finally:
            eng.shutdown()
            eng.join(timeout=60)
        followers = [(p.name, p.exitcode) for p in eng._tp_processes]
        return toks, per, followers, load_s, wall

    toks, per, followers, load_s, wall = asyncio.run(serve(2, 2))
    ref, _, _, _, _ = asyncio.run(serve(1, 1))
    require(all(len(t) == n_tok for t in toks) and toks == ref,
            f"workers x tp: tokens {toks} against meshless {ref}")
    require(len(followers) == 2 and all(code == 0 for _, code in followers),
            f"workers x tp: followers {followers}")
    out = dict(load_s=load_s, wall_s=wall, followers=followers, workers=[])
    for k, w in enumerate(per):
        launches = check_launch_sum(f"workers x tp: worker {k}", w["launches"], w["steps"],
                                    w["chunks"], L)
        out["workers"].append(dict(steps=w["steps"], chunks=w["chunks"], launches=launches))
    log(f"worker_num 2 x tp 2 on one card over gloo (L{L} C{C} V{V}, w8a8, float32, eager, "
        f"batch {B} a worker): both groups up and loaded in {load_s:.1f} s; {n_req} greedy "
        f"requests x {n_tok} tokens in {wall:.2f} s, tokens equal to a meshless engine's; "
        f"worker steps/chunks {[(w['steps'], w['chunks']) for w in out['workers']]}, each "
        f"worker's launches equal to its steps' and chunks' on the meshless path; followers "
        f"{followers} (a correctness check over host-staged collectives, not a rate)")
    tmp.cleanup()
    torch.cuda.empty_cache()
    return out


async def _tokens_of(comp):
    return [e[1] async for e in comp if e[0] == "token"]


def _decode_ms(samples, lo, hi):
    """ms a step from (time, steps, tokens) samples: from the first sample
    whose fewest tokens a slot has reached `lo` to the first at `hi`."""
    a = next(((t, s) for t, s, n in samples if n >= lo), None)
    b = next(((t, s) for t, s, n in samples if n >= hi), None)
    if a is None or b is None or b[1] <= a[1]:
        return None
    return 1e3 * (b[0] - a[0]) / (b[1] - a[1])


def run_multi(workers=2, tp=2, L=32, C=4096, V=65536, B=64, n_tok=64, devices=None,
              backend=None):
    """`--multi 2x2` on four cards, over NCCL with graphs at full depth,
    w8a8, bf16, from a native checkpoint of the seed-0 INT8 tree, against the
    meshless model on card 0: (a) worker_num `workers` x tp `tp` (worker k
    on cards k*tp..), `workers` x B short greedy requests at once: each
    worker's ms a step while all decode, and the tokens against meshless;
    (b) two lockstep hosts x tp `tp` (host h sees cards h*tp.. through
    CUDA_VISIBLE_DEVICES; dryrun_multihost's programs and worker phases):
    each host's ms a step, its tokens against meshless, both stopping after
    the same loop. Token mismatches are counted and printed (per-rank
    activation scales under w8a8 tp), not failed. devices (workers * tp of
    them, the meshless model and the hosts on the first) and backend are
    given only to rehearse on the CPU."""
    import dataclasses

    from chirrup_tpu_torch.engine.engine import AsyncEngineCore, build_model_factory
    from chirrup_tpu_torch.engine.structures import ModelLoadConfig
    from chirrup_tpu_torch.models import checkpoint, loader
    from chirrup_tpu_torch.models.config import RWKV7Config
    from chirrup_tpu_torch.parallel import dryrun_multihost as dryrun

    if devices is None:
        require(torch.cuda.device_count() >= workers * tp,
                f"--multi needs {workers * tp} CUDA devices, {torch.cuda.device_count()} seen")
        devices = [torch.device("cuda", i) for i in range(workers * tp)]
    dev = torch.device(devices[0])
    cuda = dev.type == "cuda"
    tmp = tempfile.TemporaryDirectory()
    vocab = os.path.join(tmp.name, "vocab.txt")
    write_vocab(vocab, V)
    path = os.path.join(tmp.name, "native")
    rc = RWKV7Config(n_layer=L, n_embd=C, vocab_size=V)
    checkpoint.save_native(path, rc, loader.synthetic_params_int8(rc, seed=0, device=dev))
    torch.cuda.empty_cache()
    mc = ModelLoadConfig(model_path=path, vocab_path=vocab, vocab_size=V, tensor_parallel=tp)
    prompts = [f"Request {i}: tell me more" for i in range(workers * B)]
    greedy = dict(temperature=0.0, max_tokens=n_tok, stop_tokens=[], presence_penalty=0.0,
                  frequency_penalty=0.0)

    async def serve(engine_kw, n_workers):
        eng = AsyncEngineCore()
        t0 = time.perf_counter()
        await eng.init(worker_num=n_workers, batch_size=B, load_timeout=900,
                       warmup_programs=True, **engine_kw)
        load_s = time.perf_counter() - t0
        samples = [[] for _ in eng.workers]
        try:
            comps = [eng.completion(p, **greedy) for p in prompts]
            task = asyncio.gather(*[_tokens_of(c) for c in comps])
            while not task.done():
                now = time.perf_counter()
                for k, w in enumerate(eng.workers):
                    slots = [s.task for s in w.slots if s.task is not None]
                    n = min((len(t.generated_tokens) for t in slots), default=0)
                    samples[k].append((now, w.steps_run, n))
                await asyncio.sleep(0.002)
            toks = task.result()
        finally:
            eng.shutdown()
            eng.join(timeout=60)
        ms = [_decode_ms(s, 2, n_tok - 16) for s in samples]
        return toks, ms, load_s

    out = {}
    toks, ms, load_s = asyncio.run(serve(dict(model_config=mc, tp_devices=devices,
                                              tp_backend=backend, graphs=cuda), workers))
    meshless = dataclasses.replace(mc, tensor_parallel=1)
    ref, _, _ = asyncio.run(serve(dict(model_config=meshless, model_factory=build_model_factory(
        meshless, B, device=dev, graphs=cuda), device=dev), 1))
    equal = sum(a == b for a, b in zip(toks, ref))
    out["workers_tp"] = dict(workers=workers, tp=tp, ms_step=ms, load_s=load_s,
                             requests=len(prompts), equal_to_meshless=equal)
    log(f"--multi: worker_num {workers} x tp {tp} over NCCL (cards 0..{workers * tp - 1}, L{L} "
        f"C{C} V{V}, w8a8, bf16, graphs, batch {B} a worker): ms a step by worker "
        f"{[round(m, 3) if m else m for m in ms]} while both decode; {equal} of {len(prompts)} "
        f"greedy requests equal to meshless; loaded and captured in {load_s:.1f} s")

    cfg = dryrun.Config(layers=L, width=C, vocab=V, batch=2 * B, tp=tp, device=str(dev),
                        tp_devices=None if cuda else [str(d) for d in devices[:tp]],
                        dtype="bfloat16", quantization="int8", prefill_chunk=64, graphs=cuda,
                        n_tok=n_tok, long_prompt=1024, voter=1, vocab_path=vocab,
                        vote_timeout=300.0, tp_timeout=300.0)
    t0 = time.perf_counter()
    results = dryrun.require(dryrun.launch(
        2, dryrun.host_main, (cfg, ("programs", "worker")), timeout=900,
        host_env=(lambda h: {"CUDA_VISIBLE_DEVICES": ",".join(str(h * tp + r)
                                                              for r in range(tp))})
        if cuda else None))
    wall = time.perf_counter() - t0
    reference = build_model_factory(dataclasses.replace(dryrun.model_config(cfg),
                                                        tensor_parallel=1, lockstep=False),
                                    B, device=dev, graphs=cuda)()[0]
    problems = dryrun.check(cfg, 2, results, reference)
    loops = {r["worker"]["stop_loop"] for r in results}
    require(len(loops) == 1, f"--multi lockstep: hosts stopped after loops {loops}")
    out["lockstep_tp"] = dict(tp=tp, wall_s=wall, problems=problems,
                              hosts=[dict(ms_step=r["worker"]["ms_step"],
                                          vote_us=r["worker"]["vote_us"],
                                          stop_loop=r["worker"]["stop_loop"])
                                     for r in results])
    log(f"--multi: two lockstep hosts x tp {tp} over NCCL (cards {{0,1}} and {{2,3}}), ms a "
        f"step by host {[h['ms_step'] for h in out['lockstep_tp']['hosts']]}, vote "
        f"us a loop {[round(h['vote_us'], 1) for h in out['lockstep_tp']['hosts']]}, both "
        f"stopped after loop {loops.pop()}; against meshless: "
        f"{'; '.join(problems) if problems else 'programs and tokens equal'}")
    tmp.cleanup()
    return out



def compare_step_tail(dev, L=32, V=65536):
    """The step kernel at batch 64 (cold and warm, step_ms) in each dtype
    pair of STEP_PAIRS and the penalty tail at each batch of TAIL_BATCHES,
    through the public wrappers of whichever chirrup_tpu_torch is imported,
    on inputs drawn here from seed 2: the same inputs in any tree whose
    wrappers take these arguments."""
    from chirrup_tpu_torch.ops.sampling_cuda import penalty_tail

    gen = torch.Generator(device=dev).manual_seed(2)
    step = {}
    for act, sdt in STEP_PAIRS:
        state, args = step_inputs(dev, gen, L=L, act=act, state_dtype=sdt)
        cold, warm = step_ms(state, args, L // 2 + 1)
        step[f"{str(act)[6:]}/{str(sdt)[6:]}"] = dict(cold_ms=cold, warm_ms=warm)
        del state, args
        torch.cuda.empty_cache()
    tail = {}
    for B in TAIL_BATCHES:
        logits, occ, pres, rest = tail_inputs(dev, gen, B, V)
        tail[B] = device_ms(lambda: penalty_tail(logits, occ, pres, *rest))
    torch.cuda.empty_cache()
    return dict(step_ms=step, tail_ms=tail)


# the bare kernel's variants timed by compare_batch: (requests, tokens)
BATCH_VARIANTS = ((64, 1), (8, 64), (8, 256), (32, 64), (2, 1024))


def compare_batch(dev, C=4096, L=32):
    """The bare WKV kernel through the public wkv7_batch wrapper of
    whichever chirrup_tpu_torch is imported, at each of BATCH_VARIANTS in
    each arithmetic ("default" and "bf16"; "highest" takes "default"'s
    launch, which the smoke run holds bit-equal), on bf16 rows and state
    drawn here from seed 3 (the same inputs in any tree whose wrapper takes
    these arguments): T = 1 cold (the launches rotating over the L layers)
    and warm, T > 1 with every row full and on lengths drawn alike (ragged)."""
    from chirrup_tpu_torch.ops.wkv7_cuda import wkv7_batch

    gen = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    bf = torch.bfloat16
    out = {}
    for P, T in BATCH_VARIANTS:
        rkv = rnd(P, T, 3 * C).to(bf)
        r, k, v = rkv.split(C, dim=-1)
        w = rnd(P, T, C).to(bf)
        kk = torch.nn.functional.normalize(rnd(P, T, C // 64, 64), dim=-1).reshape(P, T, C)
        a, b = (-kk).to(bf), (kk * torch.sigmoid(rnd(P, T, C))).to(bf)
        state = (rnd(L if T == 1 else 2, P, 64, C) * 0.3).to(bf)
        elapsed = torch.randint(0, 2 ** 31 - 1, (P,), generator=gen, device=dev,
                                dtype=torch.int64).to(torch.int32)
        ragged = torch.randint(0, T + 1, (P,), generator=gen, device=dev,
                               dtype=torch.int64).to(torch.int32)
        full = torch.full_like(ragged, T)
        args = (r, w, k, v, a, b, elapsed)
        for prec in ("default", "bf16"):
            kw = dict(precision=prec)
            if T == 1:
                layers = itertools.cycle(range(L))
                times = dict(cold_ms=device_ms(lambda: wkv7_batch(state, *args, full,
                                                                  next(layers), **kw)),
                             warm_ms=device_ms(lambda: wkv7_batch(state, *args, full, 1, **kw)))
            else:
                times = dict(full_ms=device_ms(lambda: wkv7_batch(state, *args, full, 1, **kw)),
                             ragged_ms=device_ms(lambda: wkv7_batch(state, *args, ragged, 1,
                                                                    **kw)),
                             ragged_tokens=int(ragged.sum()))
            out[f"{P}x{T} {prec}"] = times
        del rkv, r, k, v, w, a, b, kk, state
        torch.cuda.empty_cache()
    return out


def compare_engine(dev, tag, B=64, L=32, C=4096, V=65536, K=16, blocks=2):
    """The w8a8 decode step at the engine's width on whichever
    chirrup_tpu_torch is imported (through engine.build_model_factory and
    ServingModel.decode_block, which every tree of the port has): every
    slot sampling with penalties, one block to warm up, `blocks` steady
    blocks and one profiled. Returns the step's device busy time, its
    kernels by group, the steady step time and the decode rate."""
    import numpy as np
    from chirrup_tpu_torch.engine.engine import build_model_factory
    from chirrup_tpu_torch.engine.structures import ModelLoadConfig

    tmp = tempfile.TemporaryDirectory()
    vocab = os.path.join(tmp.name, "vocab.txt")
    write_vocab(vocab, V)
    cfg = ModelLoadConfig(model_path="<synthetic>", vocab_path=vocab, vocab_size=V,
                          quantization="int8",
                          synthetic_config=dict(n_layer=L, n_embd=C, vocab_size=V))
    model, _ = build_model_factory(cfg, B, device=dev)()
    carry = model.init_carry()
    for s in range(B):
        model.insert_slot(carry, s, None, Sampled)
    ones = np.ones((K, B), bool)
    first = ones.copy()
    first[0] = False
    model.decode_block(carry, np.full((K, B), 300, np.int32), first, ones, ones)
    steady = steady_decode(model, carry, K, blocks)
    busy, by_kernel, groups, averages = profile_block(model, carry, K)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"chip_smoke{tag}_profile.txt"), "w") as f:
        f.write(averages.table(sort_by="self_cuda_time_total", row_limit=40))
    decode_report(f"compare{tag}", B, K, steady, busy, by_kernel, groups)
    del model, carry
    torch.cuda.empty_cache()
    return dict(device_busy_step_ms=busy, device_ms_by_group_step=groups,
                step_ms=steady["step_ms"], decode_tok_s=steady["decode_tok_s"])


# one tree's run of the comparison, in a process of its own started in that
# tree's root: the chunk kernel after check_wkv from seed 0 (so its inputs are
# a full run's), the quantizer (with its GEMM) at batch 64 and at 2,048 rows
# from seed 1, each from that tree's chip_smoke.py; then the step kernel and
# the penalty tail timed by this script's compare_step_tail (argv[2]) on
# that tree's kernels, the bare WKV kernel by its compare_batch, and this
# script's engine phase (compare_engine, its profile file tagged argv[3]);
# the numbers go to the JSON file named by argv[1]
_COMPARE_RUN = """
import importlib.util, json, sys, torch
import chip_smoke as cs
from chirrup_tpu_torch.ops import _kernels
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
_kernels.build()
gen = torch.Generator(device=dev).manual_seed(0)
cs.check_wkv(dev, gen)
out = {"chunk": cs.check_chunk(dev, gen)["sites"]}
for rows, shapes in ((64, cs.MM8_SHAPES), (2048, cs.MM8_SHAPES[:4])):
    gen = torch.Generator(device=dev).manual_seed(1)
    out[f"quant_{rows}"] = cs.check_mm8(dev, gen, B=rows, shapes=shapes)[0]["sites"]
spec = importlib.util.spec_from_file_location("compare_here", sys.argv[2])
here = importlib.util.module_from_spec(spec)
spec.loader.exec_module(here)
out["step_tail"] = here.compare_step_tail(dev)
out["batch"] = here.compare_batch(dev)
out["engine"] = here.compare_engine(dev, sys.argv[3])
json.dump(out, open(sys.argv[1], "w"))
"""


def compare_trees(parent: str) -> int:
    """The WKV step, chunk and bare kernels, the activation quantizer, the
    penalty tail and the w8a8 engine's decode step of this tree against
    those of another checkout `parent` (a `git archive` of another commit
    unpacked into a gitignored directory), each tree in a process of its
    own, in turns parent, change, change, parent, on the same inputs
    (_COMPARE_RUN). Prints each run's step kernel times (cold and warm, each
    dtype pair), chunk times (with its valid tokens: the same in every run),
    the quantizer's time over a decode step and at 2,048 rows, the tail's
    times at each batch, the bare kernel's at each variant and arithmetic
    (compare_batch), and the engine's device busy time a decode step
    with its step kernel's and tail's shares; writes every site's numbers to
    chiprun_out/compare.json."""
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(parent), "change": here}
    os.makedirs(OUT_DIR, exist_ok=True)
    runs = []
    for i, label in enumerate(("parent", "change", "change", "parent"), 1):
        path = os.path.join(OUT_DIR, f"compare_{i}_{label}.json")
        with open(os.path.join(OUT_DIR, f"compare_{i}_{label}.log"), "w") as out:
            rc = subprocess.run([sys.executable, "-c", _COMPARE_RUN, path,
                                 os.path.abspath(__file__), f"_compare_{i}_{label}"],
                                cwd=trees[label],
                                stdout=out, stderr=subprocess.STDOUT).returncode
        require(rc == 0, f"compare run {i} ({label}) exited {rc}: see "
                         f"chiprun_out/compare_{i}_{label}.log")
        with open(path) as f:
            res = json.load(f)
        quant = {q["site"]: q["ms"] for q in res["quant_64"]}
        step = 32 * sum(quant[s] for s in ("att R/K/V", "att Wo", "ffn Wk", "ffn Wv")) \
            + quant["head"]
        st, eng = res["step_tail"], res["engine"]
        groups = {g: (ms, n) for g, ms, n in eng["device_ms_by_group_step"]}
        runs.append(dict(run=i, tree=label, engine=eng, batch=res["batch"], chunk=[
            dict(variant=x["variant"], valid_tokens=x["valid_tokens"], ms=x["ms"],
                 bound_ms=x["bound_ms"]) for x in res["chunk"]],
            quant_decode_step_ms=step, quant_64_ms=quant,
            quant_2048=[dict(site=q["site"], ms=q["ms"], bound_ms=q["bound_ms"])
                        for q in res["quant_2048"]], **st))
        log(f"run {i} ({label}): wkv7_step_fused B64 (rows/state) " + ", ".join(
            f"{pair} {t['cold_ms']:.4f} ms cold, {t['warm_ms']:.4f} warm"
            for pair, t in st["step_ms"].items()) + "; penalty_tail "
            + ", ".join(f"B{b} {ms:.4f} ms" for b, ms in st["tail_ms"].items())
            + f"; w8a8 engine decode step: device busy {eng['device_busy_step_ms']:.4f} ms, "
            + ", ".join(f"{g} {groups[g][0]:.4f} ms ({groups[g][1]:g} launches)"
                        for g in ("wkv7_step_fused", "penalty_tail"))
            + "; wkv7_chunk_fused " + "; ".join(
            f"{tuple(x['variant'])} {x['ms']:.4f} ms ({x['valid_tokens']} valid tokens)"
            for x in runs[-1]["chunk"])
            + f"; mm8_a8_quant_rows over a decode step {step:.4f} ms (batch 64, per site "
            + ", ".join(f"{k} {1e3 * v:.2f} us" for k, v in quant.items())
            + "); at 2,048 rows " + ", ".join(
                f"{q['site']} {1e3 * q['ms']:.2f} us ({100 * q['bound_ms'] / q['ms']:.1f}% of "
                f"its bound)" for q in runs[-1]["quant_2048"])
            + "; wkv7_batch " + "; ".join(
                f"{v} " + ", ".join(f"{k} {t:.4f}" for k, t in times.items()
                                    if k != "ragged_tokens")
                for v, times in res["batch"].items()))
    tokens = {tuple(tuple([x["variant"][0], x["variant"][1], x["valid_tokens"]])
                    for x in r["chunk"]) for r in runs}
    require(len(tokens) == 1, f"the trees timed the chunk kernel on different lengths: {tokens}")
    with open(os.path.join(OUT_DIR, "compare.json"), "w") as f:
        json.dump(runs, f, indent=1)
    return 0


# ------------------------------------------------------------------- main

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler table of one decode block")
    parser.add_argument("--compare", metavar="DIR",
                        help="instead of the smoke run, time the WKV step, chunk and "
                             "bare kernels, the quantizer and the penalty tail of the "
                             "checkout in DIR against this tree's (compare_trees)")
    parser.add_argument("--multi", metavar="WxT",
                        help="instead of the smoke run, worker_num W x tensor_parallel T and "
                             "two lockstep hosts x T over W*T cards (run_multi)")
    parser.add_argument("--tp", metavar="N[,N...]",
                        help="instead of the smoke run, serve one model over CUDA devices "
                             "0..N-1 by tensor parallelism against the meshless model on "
                             "device 0, for each N (run_tp_cards; needs N cards)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    from chirrup_tpu_torch.ops import _kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    log(smi[0])
    if args.compare:
        return compare_trees(args.compare)
    if args.multi:
        workers, tp = (int(n) for n in args.multi.split("x"))
        _kernels.build()
        torch.backends.cuda.matmul.allow_tf32 = False
        multi = run_multi(workers, tp)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_multi.json"), "w") as f:
            json.dump(dict(card=smi, multi=multi), f, indent=1)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
        return 0
    if args.tp:
        worlds = [int(n) for n in args.tp.split(",")]
        require(torch.cuda.device_count() >= max(worlds),
                f"--tp {args.tp} needs {max(worlds)} CUDA devices, "
                f"{torch.cuda.device_count()} seen")
        _kernels.build()
        torch.backends.cuda.matmul.allow_tf32 = False
        tp_cards = {n: run_tp_cards(n) for n in worlds}
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_tp_cards.json"), "w") as f:
            json.dump(dict(card=smi, tp_cards=tp_cards), f, indent=1)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
        return 0
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    ptxas_dir = tempfile.TemporaryDirectory()
    ptxas = {src: start_ptxas(src, ptxas_dir.name) for src in PTXAS_SOURCES}
    libs = _kernels.build()
    log(f"built {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.1f} s")
    sass = {src: sass_report(src, libs[src], proc) for src, proc in ptxas.items()}
    ptxas_dir.cleanup()

    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = [check_wkv(dev, gen), check_chunk(dev, gen), check_wkv_batch(dev, gen),
               *check_mm8(dev, gen), check_w16(dev, gen), check_penalty_tail(dev, gen)]
    torch.cuda.empty_cache()
    # the exact-row sampler, from a generator of its own (the draws above stay
    # those of earlier trees)
    kernels.append(check_sample_exact(dev, torch.Generator(device=dev).manual_seed(11)))
    torch.cuda.empty_cache()
    # the WKV kernels' precision="bf16" instances, from a generator of their
    # own (the draws above stay those of earlier trees)
    gen_bf16 = torch.Generator(device=dev).manual_seed(9)
    kernels += [check_wkv(dev, gen_bf16, precision="bf16"),
                check_chunk(dev, gen_bf16, precision="bf16"),
                check_wkv_batch(dev, gen_bf16, precision="bf16")]
    torch.cuda.empty_cache()
    # the bare kernel in both arithmetics at the WY form's stress variants
    # and unaligned rows ("highest" runs "default"'s launch, held bit-equal
    # above), and the WY form with float32 rows and state, filed under the
    # kernel's entries
    batch = {k["name"]: k for k in kernels if k["name"].startswith("wkv7_batch")}
    batch["wkv7_batch"]["stress_default"] = check_wkv_batch_stress(dev, "default")
    batch["wkv7_batch_bf16"]["stress_bf16"] = check_wkv_batch_stress(dev, "bf16")
    batch["wkv7_batch"]["float32"] = check_wkv_batch_float32(dev)
    torch.cuda.empty_cache()
    # the mm8 kernels at the other decode row counts: one row, and a count
    # that is not a multiple of 8
    mm8_decode = {rows: [*check_mm8(dev, gen, B=rows), check_w16(dev, gen, B=rows)]
                  for rows in (1, 37)}
    torch.cuda.empty_cache()
    # the mm8 kernels at prefill row counts: 8 x 64 and 8 x 256 or 32 x 64
    # rows, and a count that is not a multiple of the GEMM's 64-row tile
    mm8_prefill = {rows: [*check_mm8(dev, gen, B=rows, shapes=MM8_SHAPES[:4]),
                          check_w16(dev, gen, B=rows, sites=W16_PREFILL_SITES)]
                   for rows in (512, 2048, 1000)}
    torch.cuda.empty_cache()
    quant_summary = summarize_quant(kernels, mm8_prefill)
    check_small_model(dev)
    check_small_prefill(dev)
    check_small_prefill(dev, mm8_core="pallas")
    check_small_unfused(dev)
    check_small_model(dev, wkv_precision="bf16")
    check_small_prefill(dev, wkv_precision="bf16")
    torch.cuda.empty_cache()
    # the w8a8 serving path, then path A (w8a16) once the first model is
    # freed, then path B (unfused TMix) on path A's weights
    model, launches, per_step, path = run_engine(dev, args.profile, eager_engine=True)
    prefill = run_prefill(dev, model, args.profile)
    path["prefill_eager"] = run_prefill(dev, model, False, chunks=2, tag="_eager",
                                        graphs=False)
    bf16_path = run_bf16_mode(dev, model, path["block_steps"])
    path["prefix_cache"] = run_prefix_cache(dev, model)
    path["server"] = run_server(dev, model, path["decode_tok_s"])
    # the tensor-parallel path at tp = 1 over a one-rank NCCL group, against
    # this meshless model
    path["tp1"] = run_tp1(dev, model)
    # lockstep: two host processes sharing the card, against this model
    path["lockstep"] = run_lockstep(dev, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # path A (and path B on its model) at 16 layers: the script keeps to its time with
    # the tensor-parallel phases
    model, w16_launches, w16_step, path_a = run_engine(dev, args.profile, L=16, blocks=4,
                                                       mm8_core="pallas", tag="_w16",
                                                       eager_blocks=2)
    path_a["prefill"] = run_prefill(dev, model, args.profile, B=64, chunks=4, tag="_w16")
    path_a["prefill_eager"] = run_prefill(dev, model, False, B=64, chunks=2,
                                          tag="_w16_eager", graphs=False)
    path_b = run_unfused(dev, model)
    path_b_bf16 = run_unfused(dev, model, precision="bf16")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # tensor parallelism: the kernels at the shard shapes of tp 2 and 4, then
    # tp 2 as two processes sharing the card over gloo
    tp_rows, path["tp_shards"] = check_tp_shards(dev, torch.Generator(device=dev).manual_seed(13))
    path["tp2_shared_card"] = run_tp2_shared_card(dev)
    # the router over two port servers, then two tp groups in one engine
    path["router"] = run_router(dev)
    path["workers_tp_shared_card"] = run_workers_tp_shared_card(dev)
    for k in kernels:
        name = k["name"]
        if name in ("wkv7_batch", "wkv7_batch_bf16"):
            pb = path_b_bf16 if name.endswith("_bf16") else path_b
            k["launches"] = sum(pb[kind]["launches"][name] for kind in ("chunk", "step"))
            k["launches_per_step"] = pb["step"]["launches"][name]
            k["launches_per_chunk"] = pb["chunk"]["launches"][name]
            continue
        if name in ("wkv7_step_fused_bf16", "wkv7_chunk_fused_bf16"):
            k["launches"] = bf16_path["launches"][name]
            k["launches_per_step"] = bf16_path["launches_per_step"][name]
            k["launches_per_chunk"] = next(iter(bf16_path["launches_per_chunk"].values()))[name]
            continue
        run, step, chunk = ((w16_launches, w16_step, path_a["prefill"]) if name == "mm8_w16_gemm"
                            else (launches, per_step, prefill))
        k["launches"] = run[name]
        k["launches_server"] = path["server"]["launches"][name]
        k["launches_per_step"] = step[name]
        k["launches_per_chunk"] = chunk[0]["launches_per_chunk"][name]
        k["launches_tp1"] = path["tp1"]["launches"][name]
        k["launches_lockstep"] = [h["launches"].get(name, 0)
                                  for h in path["lockstep"]["hosts"]]
        k["launches_workers_tp"] = [w["launches"].get(name, 0)
                                    for w in path["workers_tp_shared_card"]["workers"]]
    for k in kernels:
        # the same kernel at the tp shard shapes (check_tp_shards)
        shard = {str(tp): rows[k["name"]] for tp, rows in tp_rows.items() if k["name"] in rows}
        if shard:
            k["tp_shards"] = {tp: {f: r[f] for f in ("ms", "bound_ms", "plain_ms", "library_ms")}
                              for tp, r in shard.items()}
    path["prefill"] = prefill
    path["mm8_prefill_rows"] = {rows: {k["name"]: k["sites"] for k in ks}
                                for rows, ks in mm8_prefill.items()}
    path["mm8_decode_rows"] = {rows: {k["name"]: k["sites"] for k in ks}
                               for rows, ks in mm8_decode.items()}
    path["builds"] = sass
    path["quant_summary"] = quant_summary
    path["w16"] = path_a
    path["unfused"] = path_b
    path["wkv_bf16"] = bf16_path
    path["unfused_bf16"] = path_b_bf16

    summary = {"kernels": kernels}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi[0], path=path, **summary), f, indent=1)
    per_site = ("sites", "splits_ms", "stress_default", "stress_bf16",
                "float32")  # in chiprun_out/chip_smoke.json
    log(json.dumps({"kernels": [{k: v for k, v in kern.items() if k not in per_site}
                                for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""ServingModel — the device-side half of the continuous-batching engine.

The whole batch lives in one `BatchCarry` of device tensors that the step
functions update IN PLACE (the JAX package threads a functional carry through
jitted programs with donated buffers; here the buffers are simply written):

  decode_step:  one token for every active slot (decode + token-by-token
                prefill), penalties, rwkv-pip-compatible sampling;
  decode_block: K decode steps with the sampled tokens fed back on the device
                (carry.last_sampled) and one host read of the result per block;
  prefill_step / prefill_step_compact: one chunk of up to `prefill_chunk`
                prompt tokens per prefilling slot, over the whole batch or over
                the P gathered slots only;
  insert_slots_batched: the admission of any number of slots in one
                program (zero state, sampling parameters, a forbidden set
                of up to LOCKSTEP_MAX_FORBIDDEN ids);
  insert_slot / reset_slot / extract_slot / extract_slot_async: per-request
                state entry and exit (a host snapshot, the async one copied
                on a side stream while the next block runs);
  init_state_pool / pool_store_many / pool_load: the device state pool,
                rows of prefix snapshots that a request resumes from by a
                device-to-device copy.

Shapes never depend on occupancy: slots are masked, never moved (the compact
prefill gathers its rows and writes them back).

On a CUDA device, decode_block (at each K), decode_step and
prefill_step_compact (at each of its `prefill_variants`) each run as one
CUDA graph per carry and shape, the counterpart of the JAX package's jitted
programs: the first call on a carry, or Worker's warm-up, runs the body
twice on all-inactive inputs (which leave the carry as it is) on a side
stream and captures it; every call then stages its host arrays into the
program's static device buffers (one copy from a pinned buffer, two used in
turn), draws the program's noise from carry.rng into static buffers, and
replays the graph. The graphs hold the addresses of the weights, the
carry's tensors and their own intermediates, so no carry tensor is ever
rebound: every write into the carry outside a replay (inserts, pool loads)
is in place and on the current stream, so stream order alone puts it
between the replays that surround it. `ServingModel(..., graphs=False)`
runs the same bodies eagerly on
the same staged inputs and noise (the reference the graphs are held to);
the CPU always runs them eagerly.

Under tensor parallelism (`ServingModel(..., tp=TPContext)`, parallel/tp.py)
each rank's model holds its shard (sharded at construction), runs the local
forward with the all-reduce as its reduce_fn, and gathers the column-parallel
head's (B, V/tp) logits into (B, V) before the fused penalty tail, so the
tail and the sampler run unchanged on every rank. Rank 0 sends each public
call below to the other ranks before it runs it (`_mirrored`); their
collectives are captured in the same graphs. A host snapshot gathers the
ranks' wkv heads; a resume takes each rank's heads from the whole row.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from chirrup_tpu_torch import resolve_device
from chirrup_tpu_torch.engine.structures import NO_PENALTY_TOKEN_IDS, RequestState
from chirrup_tpu_torch.models import rwkv7 as model
from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
from chirrup_tpu_torch.models.rwkv7 import RWKVState
from chirrup_tpu_torch.ops import _kernels, mm8
from chirrup_tpu_torch.ops.sampling_cuda import CHUNK, penalty_tail, sample_from_chunks
from chirrup_tpu_torch.parallel import tp as tp_mod


@dataclasses.dataclass
class BatchCarry:
    """All per-slot device state of one worker batch."""

    state: RWKVState               # shift (L,2,B,C), wkv (L,B,N,HN), elapsed (B,)
    occurrence: torch.Tensor       # (B, V) f32
    presence_vec: torch.Tensor     # (B, V) f32 — presence-penalty bias PLUS 1e10 at
                                   # forbidden ids (folded in at slot insert, so a
                                   # step reads one bias buffer; forbidden ids are
                                   # never sampled, so no record overwrites them)
    temperature: torch.Tensor      # (B,) f32
    top_p: torch.Tensor            # (B,) f32
    top_k: torch.Tensor            # (B,) i32
    frequency_penalty: torch.Tensor  # (B,) f32
    presence_penalty: torch.Tensor   # (B,) f32
    penalty_decay: torch.Tensor      # (B,) f32
    last_sampled: torch.Tensor     # (B,) i32 — device-resident decode feedback
    rng: torch.Generator
    # the serving programs of this carry by (kind, shape); a captured graph
    # holds the addresses of the carry's tensors
    programs: Dict[Tuple, "_Program"] = dataclasses.field(default_factory=dict, repr=False)


def forbidden_bias_row(forbidden_ids, V) -> np.ndarray:
    """Forbidden set -> (V,) f32 host bias with 1e10 at the forbidden ids;
    out-of-range ids are ignored."""
    bias = np.zeros((V,), np.float32)
    ids = np.asarray(list(forbidden_ids), np.int64)
    if ids.size:
        bias[ids[(ids >= 0) & (ids < V)]] = 1e10
    return bias


def slot_params(task) -> Tuple[Tuple[float, float, int, float, float, float],
                               Tuple[int, ...]]:
    """A task's per-slot parameters as host values: (temperature, top_p,
    top_k, frequency, presence, decay) and its forbidden ids. Raises
    ValueError or TypeError for a malformed task, before anything reaches
    the device."""
    return ((float(task.temperature), float(task.top_p), int(task.top_k),
             float(task.frequency_penalty), float(task.presence_penalty),
             float(task.penalty_decay)),
            tuple(int(t) for t in task.forbidden_tokens))


@dataclasses.dataclass(frozen=True)
class TaskParams:
    """A task's per-slot parameters alone: what a tensor-parallel call
    carries to the other ranks in place of the Task."""

    temperature: float
    top_p: float
    top_k: int
    frequency_penalty: float
    presence_penalty: float
    penalty_decay: float
    forbidden_tokens: Tuple[int, ...]

    @classmethod
    def of(cls, task) -> "TaskParams":
        (temp, top_p, top_k, freq, pres, decay), ids = slot_params(task)
        return cls(temp, top_p, top_k, freq, pres, decay, ids)


def _host_tensor(a) -> torch.Tensor:
    """A snapshot array as a tensor: a port snapshot's tensor as it is, a
    numpy array as it is, and an ml_dtypes bfloat16 array (a JAX package
    snapshot; numpy has no bf16 of its own, so it is recognised by its dtype's
    name) through float32, which holds every bf16 value exactly."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _as_words(t: torch.Tensor) -> torch.Tensor:
    """A state tensor's bits as 8-byte words (its last dimension is a
    multiple of the head size): PyTorch copies and fills a strided or
    broadcast operand element by element, so a bf16 state moves 4x fewer
    elements this way, bit for bit."""
    return t.view(torch.int64)


def _is_quantized(tree) -> bool:
    if isinstance(tree, dict):
        return any(_is_quantized(v) for v in tree.values())
    return isinstance(tree, (mm8.Mm8Weight, mm8.Mm8MultiWeight))


def _quantize_params(params):
    """INT8-quantize the big matmul weights (att R/K/V/O, ffn K/V, head); the
    embedding, norms and LoRA projections stay dense."""
    blocks = dict(params["blocks"])
    att = dict(blocks["att"])
    ffn = dict(blocks["ffn"])
    for k in ("Wr", "Wk", "Wv", "Wo"):
        att[k] = mm8.quantize_stacked(att[k])
    for k in ("Wk", "Wv"):
        ffn[k] = mm8.quantize_stacked(ffn[k])
    blocks["att"], blocks["ffn"] = att, ffn
    return {**params, "blocks": blocks, "head": mm8.quantize(params["head"])}


def _merge_att_rkv(params):
    """Merge the stacked att R/K/V Mm8Weights into one Mm8MultiWeight (with the
    (L, 3, C) stack of their token-shift mixes), so a layer computes all three
    in one quantize + one GEMM launch. No-op unless all three are quantized.
    Only the w8a8 core (mm8_core "pallas_a8") has the merged kernel, so
    ServingModel merges under it alone, as the JAX package does."""
    att = params["blocks"]["att"]
    ws = [att.get(k) for k in ("Wr", "Wk", "Wv")]
    if not all(isinstance(w, mm8.Mm8Weight) for w in ws):
        return params
    att = {k: v for k, v in att.items() if k not in ("Wr", "Wk", "Wv")}
    att["Wrkv"] = mm8.merge_stacked(ws)
    att["mu_rkv"] = torch.stack([att["x_r"], att["x_k"], att["x_v"]], dim=1)
    return {**params, "blocks": {**params["blocks"], "att": att}}


def _codes_to_k_major(params) -> None:
    """Store the int8 codes K-major (mm8.to_k_major), as the GEMM kernels of
    both cores (w8a8 and w8a16) read them: Wrkv (or Wr, Wk, Wv), Wo, FFN Wk
    and Wv, head. In place in params' dicts (ServingModel's own: cast_dense
    builds new ones), one tensor at a time, so each old tensor is freed
    before the next is copied when nothing else holds it."""
    att, ffn = params["blocks"]["att"], params["blocks"]["ffn"]
    for tree, keys in ((att, ("Wrkv", "Wr", "Wk", "Wv", "Wo")), (ffn, ("Wk", "Wv")),
                       (params, ("head",))):
        for k in keys:
            if isinstance(tree.get(k), (mm8.Mm8Weight, mm8.Mm8MultiWeight)):
                tree[k] = mm8.to_k_major(tree[k])


def _pack_att_lora(params):
    """Pack the four TMix LoRA chains (decay w, iclr a, v-gate v, gate g) into
    (L, 4, C, D) / (L, 4, D, C) tensors plus the (L, 4, C) stack of their
    token-shift mixes: two batched matmuls per layer instead of eight narrow
    ones. Zero-padding to the common D is exact (padded stage-1 columns meet
    zero stage-2 rows)."""
    att = dict(params["blocks"]["att"])
    names1, names2 = ("w1", "a1", "v1", "g1"), ("w2", "a2", "v2", "g2")
    if not all(n in att for n in names1 + names2):
        return params
    D = max(att[n].shape[2] for n in names1)
    att["lora1"] = torch.stack(
        [torch.nn.functional.pad(att[n], (0, D - att[n].shape[2])) for n in names1], dim=1)
    att["lora2"] = torch.stack(
        [torch.nn.functional.pad(att[n], (0, 0, 0, D - att[n].shape[1])) for n in names2],
        dim=1)
    att["mu_lora"] = torch.stack([att["x_w"], att["x_a"], att["x_v"], att["x_g"]], dim=1)
    for n in names1 + names2:
        del att[n]
    return {**params, "blocks": {**params["blocks"], "att": att}}


_ALIGN = 16  # int32 elements: each staged input starts on a 64-byte boundary


class _Staging:
    """A program's host inputs in one static int32 device buffer. On CUDA
    the host writes a pinned buffer and copies it asynchronously; two
    pinned buffers are used in turn, each with an event, so the host never
    rewrites one whose copy is still queued."""

    def __init__(self, shapes: Sequence[Tuple[int, ...]], device: torch.device):
        self.shapes = [tuple(sh) for sh in shapes]
        self.offsets = []
        n = 0
        for sh in self.shapes:
            self.offsets.append(n)
            n += -(-int(np.prod(sh, dtype=np.int64)) // _ALIGN) * _ALIGN
        self.host = np.zeros((n,), np.int32)
        self.buffer = torch.zeros((n,), dtype=torch.int32, device=device)
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.pinned = [torch.zeros((n,), dtype=torch.int32).pin_memory() for _ in range(2)]
            self.events = [torch.cuda.Event(), torch.cuda.Event()]
            self.used = [False, False]
            self.turn = 0

    def views(self) -> Tuple[torch.Tensor, ...]:
        """The device buffer's view of each input."""
        return tuple(self.buffer[o:o + int(np.prod(sh, dtype=np.int64))].view(sh)
                     for o, sh in zip(self.offsets, self.shapes))

    def put(self, arrays: Sequence[np.ndarray]) -> None:
        """Stage the host arrays (one for each shape) on the current stream."""
        for o, sh, a in zip(self.offsets, self.shapes, arrays):
            self.host[o:o + int(np.prod(sh, dtype=np.int64))] = np.asarray(a).reshape(-1)
        if not self.cuda:
            self.buffer.copy_(torch.from_numpy(self.host))
            return
        i, self.turn = self.turn, self.turn ^ 1
        if self.used[i] and not self.events[i].query():
            self.events[i].synchronize()
        self.pinned[i].numpy()[:] = self.host
        self.buffer.copy_(self.pinned[i], non_blocking=True)
        self.events[i].record(torch.cuda.current_stream(self.buffer.device))
        self.used[i] = True


class _Program:
    """One serving program on one carry: its staged inputs, its noise
    buffers (gumbel (K, B, k) and seeds (K, B), drawn before every run) and
    its body, a function of the carry (the program holds no reference to
    the carry, which holds it); with `graph`, the CUDA graph of the body on
    that carry, its static outputs and the kernel launches one replay
    makes."""

    def __init__(self, staging: _Staging,
                 body: Callable[["BatchCarry"], Tuple[torch.Tensor, ...]],
                 noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        self.staging = staging
        self.body = body
        self.noise = noise
        self.graph = None
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.launches: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}  # host wall of the warm-up and of the capture

    def capture(self, carry: "BatchCarry", pool, stream: torch.cuda.Stream,
                warmup: int = 2) -> None:
        """Warm up on `stream` (every library built, every first-use step
        run outside the capture), then capture the body into a graph whose
        memory comes from `pool`. The staged inputs must be all-inactive:
        the warm-up runs the body for real. Raises if the capture fails."""
        dev = self.staging.buffer.device
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(warmup):
                self.body(carry)
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()

        def capture():
            # thread_local: other workers' threads may allocate or launch
            # on their own devices while this one captures
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                return self.body(carry)

        self.outputs, self.launches = _kernels.record_launches(capture)
        self.graph = graph
        # capture includes the instantiation (CUDAGraph.capture_end)
        self.seconds = dict(warmup=t1 - t0, capture=time.perf_counter() - t1)

    def run(self, carry: "BatchCarry") -> Tuple[torch.Tensor, ...]:
        """The body's outputs for the staged inputs: by a replay of the
        graph captured on `carry`, returned as copies made on the stream
        right after it (the next replay rewrites the static outputs), or
        eagerly."""
        if self.graph is None:
            return self.body(carry)
        self.graph.replay()
        _kernels.add_launches(self.launches)
        return tuple(t.clone() for t in self.outputs)


def draw_noise(rng: torch.Generator, gumbel: torch.Tensor, seeds: torch.Tensor) -> None:
    """Fill a program's noise buffers, gumbel (K, B, k) and seeds (K, B),
    from the carry's generator: standard Gumbel noise for the candidate draw
    (-log(E), E ~ Exp(1), as ops.sampling.gumbel_like) and int64 seeds for
    the exact draw's generator. Step by step, in the order K single steps
    draw them, so a K-step block samples what K decode_step calls do."""
    for k in range(gumbel.shape[0]):
        gumbel[k].exponential_(generator=rng)
        seeds[k].random_(0, 2 ** 62, generator=rng)
    gumbel.log_().neg_()


def _mirrored(fn=None, *, returns=False):
    """A public ServingModel call that touches the device. Under tensor
    parallelism rank 0 sends it to every other rank (tp.follow) before it
    runs it, with its carries and pools as references and its tasks as
    TaskParams; a call made inside another (reset_slot's insert_slot) is
    not sent again. `returns`: the result (a carry or a pool) is named for
    later calls."""
    if fn is None:
        return functools.partial(_mirrored, returns=returns)

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        tp = self.tp
        if tp is None or tp.rank != 0 or self._mirroring:
            return fn(self, *args, **kwargs)
        self._mirroring = True
        try:
            oid = tp.send_call(fn.__name__, self._export(args),
                               {k: self._export(v) for k, v in kwargs.items()}, returns)
            result = fn(self, *args, **kwargs)
            if returns:
                tp.register(result, oid)
            return result
        finally:
            self._mirroring = False

    return call


class ServingModel:
    """Owns prepared parameters and the step functions for one worker.

    `params` is the parameter tree, or a function of no arguments that makes
    it: then the model holds the only reference to the tree while it prepares
    it, so each code tensor it replaces (merged R/K/V, K-major codes) is freed
    at once and loading costs at most one code tensor more than the result.

    `graphs`: on a CUDA device, run the serving programs as captured CUDA
    graphs (True) or eagerly (False: the reference the graphs are held to).
    The CPU never captures.

    `tp`: this rank's TPContext (parallel/tp.py). The model runs on
    tp.device; a whole tree is quantized first (under "int8", as a whole, as
    the JAX package does before it shards) and then sharded, and a tree
    that is already this rank's shard is taken as it is (it must come
    quantized under "int8"). gloo collectives stage through the host, which
    a CUDA graph cannot capture: on CUDA, gloo needs graphs=False."""

    # forbidden ids a slot may bring into insert_slots_batched (a (B, V) bias
    # staged from the host every admission would dwarf the program); a task
    # with more is admitted through insert_slot
    LOCKSTEP_MAX_FORBIDDEN = 8

    def __init__(self, config: RWKV7Config,
                 params: Union[Dict[str, Any], Callable[[], Dict[str, Any]]],
                 runtime: RuntimeConfig, batch_size: int, prefill_chunk: int = 64, *,
                 device=None, seed: int = 0, graphs: bool = True, tp=None):
        self.config = config
        self.tp = tp
        self._mirroring = False
        self.runtime = runtime
        self.batch_size = batch_size
        self.prefill_chunk = prefill_chunk
        # compact prefill: the worker admits at most ~B/8 bulk prefills, so a
        # chunk runs on P = roundup8(B/8) gathered rows (at most 32) instead of
        # all B. Two (P, T) variants carry about P*T rows each: (P, T) for a
        # full prefill set, and a tall one (8, T*P/8) that advances up to 8
        # prompts P/8 times as far per chunk.
        cap = -(-batch_size // 8)
        P = min(batch_size, max(8, -(-cap // 8) * 8), 32)
        small = min(8, P)
        self.prefill_slots = P
        self.prefill_variants = sorted({(small, prefill_chunk * (P // small)),
                                        (P, prefill_chunk)})
        self.device = resolve_device(tp.device if tp is not None and device is None else device)
        if tp is not None and self.device != tp.device:
            raise ValueError(f"tp rank {tp.rank} owns {tp.device}, not {self.device}")
        if tp is not None and config.n_embd % (config.head_size * tp.world):
            raise ValueError(f"tp {tp.world}: {config.n_embd // config.head_size} heads do "
                             f"not split evenly over the ranks")
        if tp is not None and graphs and tp.backend == "gloo" and self.device.type == "cuda":
            raise ValueError("tp over gloo on CUDA cannot be captured in CUDA graphs "
                             "(its collectives stage through the host): pass graphs=False")
        # the wkv state's width on this rank (its heads)
        self.wkv_width = config.n_embd // (tp.world if tp is not None else 1)
        if callable(params):
            params = params()
        int8 = runtime.quantization == "int8"
        if tp is not None and tp_mod.is_full(params, config.n_embd):
            if int8 and not _is_quantized(params):
                params = _quantize_params(params)   # as a whole, where the tree lies
            params = tp_mod.shard_params(params, tp.rank, tp.world)
        elif tp is not None and int8 and not _is_quantized(params):
            raise ValueError("a tree already sharded must come quantized: a shard's "
                             "quantization differs from the whole matrix's")
        params = model.cast_dense(params, device=self.device)
        if int8 and not _is_quantized(params):
            params = _quantize_params(params)
        self.mm8_core = mm8.resolve_mm8_core(runtime.mm8_core)
        if self.mm8_core == "pallas_a8":
            params = _merge_att_rkv(params)
        _codes_to_k_major(params)
        params = _pack_att_lora(params)
        self.params = model.cast_dense(params, runtime.activation_dtype)
        self._no_penalty_ids = torch.tensor(sorted(NO_PENALTY_TOKEN_IDS),
                                            dtype=torch.int32, device=self.device)
        self._seed = seed
        # the candidate draw's noise width (sample_from_chunks' k_max)
        self._noise_k = min(runtime.sampler_k_max, -(-config.vocab_size // CHUNK))
        self.graphs = bool(graphs) and self.device.type == "cuda"
        if self.graphs:
            # one memory pool for every graph of this model, captured on one stream
            self._pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        # the side stream of extract_slot_async's device-to-host copies
        self._snapshot_stream = (torch.cuda.Stream(self.device)
                                 if self.device.type == "cuda" else None)
        # the sum over the ranks after the row-parallel Wo and FFN Wv
        self._reduce_fn = tp.all_reduce if tp is not None else None

    # ------------------------------------------------------ tensor parallel

    def _export(self, a):
        """An argument of a mirrored call as the followers get it: carries and
        pools as references, tasks as TaskParams, tensors on the host."""
        if isinstance(a, BatchCarry) or (isinstance(a, dict) and self.tp.knows(a)):
            return self.tp.ref(a)
        if isinstance(a, (list, tuple)):
            return type(a)(self._export(x) for x in a)
        if hasattr(a, "forbidden_tokens") and not isinstance(a, TaskParams):
            return TaskParams.of(a)
        if isinstance(a, torch.Tensor):
            return a.cpu()
        return a

    @_mirrored
    def replica_report(self, carry: BatchCarry) -> List[Dict[str, Any]]:
        """Every rank's view of the carry's replicated part, by rank (on rank 0;
        followers get None): last_sampled, a SHA-1 over last_sampled,
        elapsed, the shift state, occurrence and presence_vec (equal on every
        rank exactly when every rank sampled the same tokens), and the
        rank's kernel launch counts (_kernels.LAUNCHES). Meshless: this
        model's alone."""
        st = carry.state
        digest = hashlib.sha1()
        for t in (carry.last_sampled, st.elapsed, st.shift, carry.occurrence,
                  carry.presence_vec):
            digest.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        report = {"rank": self.tp.rank if self.tp is not None else 0,
                  "last_sampled": carry.last_sampled.tolist(), "digest": digest.hexdigest(),
                  "launches": dict(_kernels.LAUNCHES)}
        return [report] if self.tp is None else self.tp.gather_object(report)

    def close(self) -> None:
        """Under tp, on rank 0: stop the followers and leave the group
        (every rank leaves it). Meshless: nothing."""
        if self.tp is not None:
            self.tp.close()

    # ------------------------------------------------------------------ carry

    @_mirrored(returns=True)
    def init_carry(self) -> BatchCarry:
        cfg, rt, B, dev = self.config, self.runtime, self.batch_size, self.device
        V = cfg.vocab_size
        f32 = torch.float32
        return BatchCarry(
            state=model.init_state(cfg, B, shift_dtype=rt.activation_dtype,
                                   wkv_dtype=rt.wkv_state_dtype, device=dev,
                                   wkv_width=self.wkv_width),
            occurrence=torch.zeros((B, V), dtype=f32, device=dev),
            presence_vec=torch.zeros((B, V), dtype=f32, device=dev),
            temperature=torch.ones((B,), dtype=f32, device=dev),
            top_p=torch.full((B,), 0.3, dtype=f32, device=dev),
            top_k=torch.zeros((B,), dtype=torch.int32, device=dev),
            frequency_penalty=torch.zeros((B,), dtype=f32, device=dev),
            presence_penalty=torch.zeros((B,), dtype=f32, device=dev),
            penalty_decay=torch.ones((B,), dtype=f32, device=dev),
            last_sampled=torch.full((B,), -1, dtype=torch.int32, device=dev),
            rng=torch.Generator(device=dev).manual_seed(self._seed))

    def _noise_buffers(self, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
        B = self.batch_size
        return (torch.zeros((K, B, self._noise_k), dtype=torch.float32, device=self.device),
                torch.zeros((K, B), dtype=torch.int64, device=self.device))

    # ------------------------------------------------------------ step bodies

    def _decode_step_impl(self, carry: BatchCarry, host_tokens, feedback_mask,
                          active_mask, decode_mask, gumbel, seeds):
        """One token step over the whole batch (device tensors in, device out).

        host_tokens: (B,) int32 input token per slot (ignored where inactive).
        feedback_mask: slots whose input is the previous step's on-device sample.
        active_mask: slots whose state advances (decode + token-by-token prefill).
        decode_mask: the subset that gets penalties and sampling.
        gumbel (B, k), seeds (B,): the step's noise (draw_noise).

        Returns (sampled (B,) int32 [-1 where not decoding], raw logits
        (B, V) pre-penalty)."""
        last = carry.last_sampled
        tokens = torch.where(feedback_mask, last.clamp_min(0), host_tokens)
        logits, _ = model.forward_step(
            self.params, tokens, carry.state, active=active_mask,
            compute_dtype=self.runtime.activation_dtype,
            use_dither=self.runtime.use_dither, mm8_core=self.mm8_core,
            wkv_precision=self.runtime.wkv_precision, reduce_fn=self._reduce_fn)
        if self.tp is not None:
            logits = self.tp.gather_vocab(logits)
        # record the PREVIOUS sample (deferred through last_sampled), decay,
        # penalties, logsumexp and per-chunk candidates in one pass
        no_penalty = (last[:, None] == self._no_penalty_ids[None, :]).any(-1)
        upd = decode_mask & (last >= 0) & ~no_penalty
        _, _, cval, cidx, lse = penalty_tail(
            logits, carry.occurrence, carry.presence_vec, carry.penalty_decay,
            carry.frequency_penalty, carry.presence_penalty, last, upd, decode_mask)
        sampled = sample_from_chunks(
            cval, cidx, lse, carry.temperature, carry.top_p, carry.top_k, None,
            (logits, carry.presence_vec, carry.occurrence, carry.frequency_penalty),
            row_mask=decode_mask, k_max=self.runtime.sampler_k_max, gumbel=gumbel,
            seeds=seeds)
        sampled = torch.where(decode_mask, sampled, -1)
        last.copy_(torch.where(decode_mask, sampled, last))
        return sampled, logits

    def _block_body(self, carry: BatchCarry, K: int, inputs, noise, logit_rows=None):
        """K decode steps from the (K, B) int32 tokens and masks and (B, 2)
        votes: (sampled (K, B) int32, vote sums (2,)[, the raw logits of
        the slots `logit_rows` (M,) at each step (K, M, V)])."""
        toks, fb, act, dec, votes = inputs
        fb, act, dec = fb != 0, act != 0, dec != 0
        gumbel, seeds = noise
        sampled = torch.empty((K, self.batch_size), dtype=torch.int32, device=self.device)
        marked = None
        for k in range(K):
            s, raw = self._decode_step_impl(carry, toks[k], fb[k], act[k], dec[k], gumbel[k],
                                            seeds[k])
            sampled[k].copy_(s)
            if logit_rows is not None:
                if marked is None:
                    marked = torch.empty((K, logit_rows.shape[0], raw.shape[1]),
                                         dtype=torch.float32, device=self.device)
                marked[k].copy_(raw.index_select(0, logit_rows))
        if logit_rows is None:
            return sampled, votes.sum(0)
        return sampled, votes.sum(0), marked

    def _step_body(self, carry: BatchCarry, inputs, noise):
        """One decode step from the staged (B,) arrays: (sampled, raw logits)."""
        toks, fb, act, dec = inputs
        gumbel, seeds = noise
        return self._decode_step_impl(carry, toks, fb != 0, act != 0, dec != 0, gumbel[0],
                                      seeds[0])

    def _compact_body(self, carry: BatchCarry, inputs):
        """One chunk over the staged (P, T) tokens, (P,) lengths and (P,)
        slot indices: the rows' shift, wkv and elapsed gathered, advanced by
        forward_chunk and written back."""
        tokens, lengths, slot_idx = inputs
        st = carry.state
        idx = slot_idx.long()
        rows = RWKVState(shift=st.shift.index_select(2, idx),
                         wkv=st.wkv.index_select(1, idx),
                         elapsed=st.elapsed.index_select(0, idx))
        self._forward_chunk(rows, tokens, lengths)
        st.shift.index_copy_(2, idx, rows.shift)
        st.wkv.index_copy_(1, idx, rows.wkv)
        st.elapsed.index_copy_(0, idx, rows.elapsed)
        return ()

    def _insert_body(self, carry: BatchCarry, inputs):
        """Admit the staged mask's slots: zero state and occurrence, the
        presence bias rebuilt as 1e10 at each row's forbidden ids (-1
        padded), the sampling parameters (floats staged by their bits) and
        last_sampled = -1. Rows outside the mask keep every bit; an
        all-False mask changes nothing."""
        mask, temp, top_p, top_k, freq, pres, decay, forbidden = inputs
        m = mask != 0
        st = carry.state
        _as_words(st.shift).masked_fill_(m[None, None, :, None], 0)
        _as_words(st.wkv).masked_fill_(m[None, :, None, None], 0)
        st.elapsed.masked_fill_(m, 0)
        carry.occurrence.masked_fill_(m[:, None], 0)
        V = carry.presence_vec.shape[1]
        # the -1 pads scatter into a spare column V
        bias = torch.zeros((self.batch_size, V + 1), dtype=torch.float32, device=self.device)
        bias.scatter_(1, torch.where(forbidden >= 0, forbidden, V).long(), 1e10)
        carry.presence_vec.copy_(torch.where(m[:, None], bias[:, :V], carry.presence_vec))
        for dst, src in ((carry.temperature, temp), (carry.top_p, top_p),
                         (carry.frequency_penalty, freq), (carry.presence_penalty, pres),
                         (carry.penalty_decay, decay)):
            dst.copy_(torch.where(m, src.view(torch.float32), dst))
        carry.top_k.copy_(torch.where(m, top_k, carry.top_k))
        carry.last_sampled.masked_fill_(m, -1)
        return ()

    def _forward_chunk(self, state: RWKVState, tokens, lengths) -> None:
        model.forward_chunk(self.params, tokens, state, lengths,
                            compute_dtype=self.runtime.activation_dtype,
                            use_dither=self.runtime.use_dither, mm8_core=self.mm8_core,
                            wkv_precision=self.runtime.wkv_precision,
                            reduce_fn=self._reduce_fn)

    # --------------------------------------------------------------- programs

    def _program(self, carry: BatchCarry, key: Tuple) -> _Program:
        """The program `key` of this carry: ("block", K), ("step",),
        ("compact", P, T) or ("insert",), built and, with graphs, captured
        at first use (on all-zero staged inputs: every row inactive);
        or one that always runs eagerly: ("marked", K, M), a block that also
        gathers M rows' raw logits, and ("full", T), a chunk over the whole
        batch."""
        prog = carry.programs.get(key)
        if prog is not None:
            return prog
        B = self.batch_size
        kind = key[0]
        if kind == "block":
            K = key[1]
            staging = _Staging([(K, B)] * 4 + [(B, 2)], self.device)
            noise = self._noise_buffers(K)
            inputs = staging.views()
            prog = _Program(staging, lambda c: self._block_body(c, K, inputs, noise), noise)
        elif kind == "step":
            staging = _Staging([(B,)] * 4, self.device)
            noise = self._noise_buffers(1)
            inputs = staging.views()
            prog = _Program(staging, lambda c: self._step_body(c, inputs, noise), noise)
        elif kind == "compact":
            P, T = key[1:]
            staging = _Staging([(P, T), (P,), (P,)], self.device)
            inputs = staging.views()
            prog = _Program(staging, lambda c: self._compact_body(c, inputs))
            # all-inactive: length 0 on distinct slots
            staging.put([np.zeros((P, T)), np.zeros(P), np.arange(P)])
        elif kind == "insert":
            staging = _Staging([(B,)] * 7 + [(B, self.LOCKSTEP_MAX_FORBIDDEN)], self.device)
            inputs = staging.views()
            prog = _Program(staging, lambda c: self._insert_body(c, inputs))
        elif kind == "marked":
            K, M = key[1:]
            staging = _Staging([(K, B)] * 4 + [(B, 2), (M,)], self.device)
            noise = self._noise_buffers(K)
            *inputs, rows = staging.views()
            prog = _Program(staging, lambda c: self._block_body(c, K, inputs, noise, rows.long()),
                            noise)
        elif kind == "full":
            staging = _Staging([(B, key[1]), (B,)], self.device)
            inputs = staging.views()
            prog = _Program(staging, lambda c: self._forward_chunk(c.state, *inputs))
        else:
            raise ValueError(f"unknown serving program {key!r}")
        if self.graphs and kind in ("block", "step", "compact", "insert"):
            prog.capture(carry, self._pool, self._capture_stream)
        carry.programs[key] = prog
        return prog

    def _run(self, carry: BatchCarry, key: Tuple, host: Sequence[np.ndarray]):
        prog = self._program(carry, key)
        prog.staging.put(host)
        if prog.noise is not None:
            draw_noise(carry.rng, *prog.noise)
        return prog.run(carry)

    # ------------------------------------------------------------- public API

    @_mirrored
    def decode_step(self, carry, tokens, active_mask, decode_mask, feedback_mask=None):
        """One step; host (B,) arrays in. Returns (carry, sampled (B,) int32,
        raw logits (B, V)) as device tensors."""
        B = self.batch_size
        if feedback_mask is None:
            feedback_mask = np.zeros((B,), bool)
        sampled, logits = self._run(carry, ("step",),
                                    (tokens, feedback_mask, active_mask, decode_mask))
        return carry, sampled, logits

    @_mirrored
    def decode_block(self, carry, tokens, feedback_mask, active_mask, decode_mask,
                     stop_votes=None, logit_rows=None):
        """K steps in one call; (K, B) host arrays in. DECODE slots chain through
        the on-device last_sampled, so the block needs no host read: the caller
        reads the returned (K, B) tokens once.

        stop_votes: optional (B,) or (B, 2) int votes, summed per column;
        logit_rows: optional (M,) slot rows whose per-step raw logits are
        gathered. Returns (carry, sampled (K, B) int32, vote sums (2,)
        [, marked logits (K, M, V)]), all device tensors. With logit_rows
        the block runs eagerly even where graphs are on: the port's worker
        never asks for it (it runs single steps while a slot wants logits)."""
        B = self.batch_size
        if stop_votes is None:
            stop_votes = np.zeros((B, 2), np.int32)
        stop_votes = np.asarray(stop_votes, np.int32)
        if stop_votes.ndim == 1:
            stop_votes = np.stack([stop_votes, np.zeros_like(stop_votes)], axis=1)
        tokens = np.asarray(tokens, np.int32)
        K = tokens.shape[0]
        host = (tokens, feedback_mask, active_mask, decode_mask, stop_votes)
        if logit_rows is None:
            return (carry,) + self._run(carry, ("block", K), host)
        logit_rows = np.asarray(logit_rows, np.int32).reshape(-1)
        return (carry,) + self._run(carry, ("marked", K, logit_rows.size),
                                    host + (logit_rows,))

    @_mirrored
    def prefill_step(self, carry: BatchCarry, tokens, lengths) -> BatchCarry:
        """One chunk over the whole batch: tokens (B, T) and lengths (B,) host
        arrays, length 0 for slots that are not prefilling (their state is
        left bit-unchanged). No logits: the last prompt token always goes
        through the decode step. Eager (the worker prefills through the
        compact form, which is captured)."""
        tokens = np.asarray(tokens)
        self._run(carry, ("full", tokens.shape[1]), (tokens, lengths))
        return carry

    @_mirrored
    def prefill_step_compact(self, carry: BatchCarry, tokens, lengths,
                             slot_idx) -> BatchCarry:
        """One chunk over P gathered slots: tokens (P, T), lengths (P,) and
        slot_idx (P,) host arrays. slot_idx must be unique; rows of length 0
        point at idle slots, which come back bit-unchanged. The rows' shift,
        wkv and elapsed are gathered, advanced by forward_chunk and written
        back, all on the device."""
        tokens = np.asarray(tokens)
        self._run(carry, ("compact",) + tokens.shape, (tokens, lengths, slot_idx))
        return carry

    @_mirrored
    def insert_slot(self, carry: BatchCarry, slot: int,
                    request_state: Optional[RequestState], task) -> BatchCarry:
        """Load one request into a slot: its recurrent state (zeros when
        request_state is None; under tp each rank takes its heads of the
        whole wkv row), sampling parameters and forbidden-token bias."""
        st = carry.state
        if request_state is None:
            st.shift[:, :, slot].zero_()
            st.wkv[:, slot].zero_()
            st.elapsed[slot] = 0
        else:
            wkv = _host_tensor(request_state.wkv)
            if self.tp is not None:
                wkv = self.tp.local_heads(wkv)
            st.shift[:, :, slot].copy_(_host_tensor(request_state.shift))
            st.wkv[:, slot].copy_(wkv)
            st.elapsed[slot] = int(request_state.elapsed)
        carry.occurrence[slot].zero_()
        carry.presence_vec[slot].copy_(torch.from_numpy(
            forbidden_bias_row(task.forbidden_tokens, self.config.vocab_size)))
        self._set_params(carry, slot, task)
        return carry

    def _set_params(self, carry: BatchCarry, slot: int, task) -> None:
        (temp, top_p, top_k, freq, pres, decay), _ = slot_params(task)
        carry.temperature[slot] = temp
        carry.top_p[slot] = top_p
        carry.top_k[slot] = top_k
        carry.frequency_penalty[slot] = freq
        carry.presence_penalty[slot] = pres
        carry.penalty_decay[slot] = decay
        carry.last_sampled[slot] = -1

    @_mirrored
    def insert_slots_batched(self, carry: BatchCarry, mask, tasks) -> BatchCarry:
        """Admit the slots of `mask` (B,) in one program: tasks[i] is the
        Task of each masked slot (None elsewhere). Each gets the zero state
        (a pool resume loads its row afterwards, pool_load), its sampling
        parameters, zero occurrence and the bias of its forbidden ids, at
        most LOCKSTEP_MAX_FORBIDDEN of them in range; the carry ends
        bit-equal to insert_slot(carry, i, None, tasks[i]) for each masked
        slot. One staged upload (no pageable copy, no host sync), then the
        program (on CUDA a captured graph)."""
        B, V, F = self.batch_size, self.config.vocab_size, self.LOCKSTEP_MAX_FORBIDDEN
        floats = np.zeros((5, B), np.float32)  # temperature, top_p, freq, pres, decay
        top_k = np.zeros((B,), np.int32)
        forb = np.full((B, F), -1, np.int32)
        for i, task in enumerate(tasks):
            if task is None:
                continue
            (temp, top_p, top_k[i], freq, pres, decay), ids = slot_params(task)
            floats[:, i] = temp, top_p, freq, pres, decay
            ids = [t for t in ids if 0 <= t < V][:F]
            forb[i, :len(ids)] = ids
        bits = floats.view(np.int32)
        self._run(carry, ("insert",), (np.asarray(mask, bool), bits[0], bits[1], top_k,
                                       bits[2], bits[3], bits[4], forb))
        return carry

    @_mirrored
    def reset_slot(self, carry: BatchCarry, slot: int) -> BatchCarry:
        """Zero a slot's state and restore default sampling parameters."""

        class _Defaults:
            temperature, top_p, top_k = 1.0, 1.0, 0
            frequency_penalty, presence_penalty, penalty_decay = 0.0, 0.0, 1.0
            forbidden_tokens = ()

        return self.insert_slot(carry, slot, None, _Defaults)

    @_mirrored
    def extract_slot(self, carry: BatchCarry, slot: int) -> RequestState:
        """Snapshot a slot's recurrent state to host at its DEVICE dtypes, as
        the JAX package does (bf16 in serving: half the host bytes of
        float32): contiguous CPU tensors that share nothing with the carry.
        insert_slot copies them back unconverted, so resuming from a snapshot
        is bit-identical to an uninterrupted run. Under tp the ranks' wkv
        heads are gathered (a collective every rank makes at this call) and
        the snapshot is rank 0's; the other ranks return None."""
        st = carry.state
        host = lambda t: t.to("cpu", copy=True, memory_format=torch.contiguous_format)
        wkv = st.wkv[:, slot]
        if self.tp is not None:
            wkv = self.tp.gather_heads(wkv)
            if self.tp.rank != 0:
                return None
        return RequestState(shift=host(st.shift[:, :, slot]), wkv=host(wkv),
                            elapsed=int(st.elapsed[slot]))

    @_mirrored
    def extract_slot_async(self, carry: BatchCarry, slot: int) -> Callable[[], RequestState]:
        """Start a snapshot of a slot and return the function that gives it,
        a RequestState equal to extract_slot's at this point of the stream.
        The slot's rows are copied into fresh device buffers on the current
        stream, so the next replay may advance the slot at once; on CUDA a
        side stream waits for that copy and moves the buffers into pinned
        host memory while the next block runs, and the resolver waits only
        for that move (the worker resolves a loop later). Under tp the
        ranks' wkv heads are gathered into the fresh buffer on the current
        stream first (a collective every rank makes at this call)."""
        st = carry.state
        rows = [torch.empty_like(st.shift[:, :, slot], memory_format=torch.contiguous_format),
                None, st.elapsed[slot:slot + 1].clone()]
        _as_words(rows[0]).copy_(_as_words(st.shift[:, :, slot]))
        if self.tp is not None:
            rows[1] = self.tp.gather_heads(st.wkv[:, slot])
            if self.tp.rank != 0:
                return lambda: None
        else:
            rows[1] = torch.empty_like(st.wkv[:, slot], memory_format=torch.contiguous_format)
            _as_words(rows[1]).copy_(_as_words(st.wkv[:, slot]))
        if self._snapshot_stream is None:
            return lambda: RequestState(shift=rows[0], wkv=rows[1], elapsed=int(rows[2]))
        side = self._snapshot_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in rows]
            for h, t in zip(host, rows):
                h.copy_(t, non_blocking=True)
                t.record_stream(side)  # not reused before the move is done
            done = torch.cuda.Event()
            done.record(side)

        def resolve() -> RequestState:
            done.synchronize()
            return RequestState(shift=host[0], wkv=host[1], elapsed=int(host[2]))

        return resolve

    # ------------------------------------------------------- device state pool

    @_mirrored(returns=True)
    def init_state_pool(self, size: int) -> Dict[str, torch.Tensor]:
        """`size` rows of prefix snapshots on the device, in the JAX
        package's layout: shift (S, L, 2, C) at the activation dtype, wkv
        (S, L, N, H*N) at the state's dtype (under tp: this rank's heads,
        H*N/tp), elapsed (S,) int32. Ordinary allocations, outside any
        graph's memory pool; pool_row_bytes() a row (17,301,508 at g1 7.2B
        width in bf16)."""
        cfg, rt, dev = self.config, self.runtime, self.device
        L, C, N = cfg.n_layer, cfg.n_embd, cfg.head_size
        return {"shift": torch.zeros((size, L, 2, C), dtype=rt.activation_dtype, device=dev),
                "wkv": torch.zeros((size, L, N, self.wkv_width), dtype=rt.wkv_state_dtype,
                                   device=dev),
                "elapsed": torch.zeros((size,), dtype=torch.int32, device=dev)}

    def pool_row_bytes(self) -> int:
        """A pool row's bytes, the whole row's (under tp each rank holds the
        shift and its heads' share of the wkv)."""
        cfg, rt = self.config, self.runtime
        itemsize = lambda dtype: torch.empty((), dtype=dtype).element_size()
        return (cfg.n_layer * 2 * cfg.n_embd * itemsize(rt.activation_dtype)
                + cfg.n_layer * cfg.head_size * cfg.n_embd * itemsize(rt.wkv_state_dtype) + 4)

    @_mirrored
    def pool_store(self, carry: BatchCarry, pool, slot: int, row: int):
        """Snapshot slot -> pool row on the device; returns the pool."""
        return self.pool_store_many(carry, pool, [(slot, row)])

    @_mirrored
    def pool_store_many(self, carry: BatchCarry, pool, pairs: Sequence[Tuple[int, int]]):
        """Snapshots [(slot, row), ...], any number: device-to-device copies
        into the pool, in place, on the current stream (so after the
        dispatches before them and before the next replay), with no host
        synchronisation. Returns the pool."""
        st = carry.state
        for slot, row in pairs:
            _as_words(pool["shift"][row]).copy_(_as_words(st.shift[:, :, slot]))
            _as_words(pool["wkv"][row]).copy_(_as_words(st.wkv[:, slot]))
            pool["elapsed"][row:row + 1].copy_(st.elapsed[slot:slot + 1])
        return pool

    @_mirrored
    def pool_load(self, carry: BatchCarry, pool, row: int, slot: int) -> BatchCarry:
        """Resume pool row -> slot on the device: copies into the carry's own
        tensors (a captured graph holds their addresses), on the current
        stream, with no host synchronisation. The slot's sampling
        parameters come from an insert before it."""
        st = carry.state
        _as_words(st.shift[:, :, slot]).copy_(_as_words(pool["shift"][row]))
        _as_words(st.wkv[:, slot]).copy_(_as_words(pool["wkv"][row]))
        st.elapsed[slot:slot + 1].copy_(pool["elapsed"][row:row + 1])
        return carry


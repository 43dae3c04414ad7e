"""Multi-host lockstep dry run: N host processes on one machine.

The counterpart of scripts/dryrun_multihost.py. It forks N processes, each
with torch.distributed's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
RANK) as `torchrun --nnodes N --nproc-per-node 1` sets it for a host, and
runs three phases on every host:

1. programs: the model's programs (insert_slot, a whole-batch prefill chunk,
   greedy decode steps) on the host's rows of the global batch; the parent
   runs the same on one model over every host's rows in turn and requires
   equal tokens;
2. worker: the lockstep Worker over the host's rows serving greedy requests
   (a long prompt among them) until no host has one, then a shutdown voted
   on one host: every host stops after the same loop; the parent requires
   the tokens of a worker without lockstep on one model;
3. server: the engine and HTTP server on each host (lockstep, a state pool):
   a chat completion, then the same one resumed from its prefix snapshot,
   which must equal the cold run; closing the servers votes them down.

    python -m chirrup_tpu_torch.parallel.dryrun_multihost [--hosts 2] [--tp 1]
        [--device cpu | cuda] [--layers 2 --width 128 --vocab 300] [--batch 8]

On the CPU it runs a tiny model; on the card (`--device cuda`, every host on
the current device) at any width, e.g. 7.2B's (`--width 4096 --vocab 65536`).
`launch` and the host functions are what chip_smoke.py's lockstep phase
drives.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import http.client
import json
import multiprocessing
import multiprocessing.connection
import os
import queue
import socket
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# the host processes' rendezvous (the same variables torchrun sets)
HOST_ADDR = "127.0.0.1"


def free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST_ADDR, 0))
        return s.getsockname()[1]


def _host_entry(host: int, hosts: int, port: int, target: Callable, args, env, conn) -> None:
    os.environ.update(env, MASTER_ADDR=HOST_ADDR, MASTER_PORT=str(port), WORLD_SIZE=str(hosts),
                      RANK=str(host))
    try:
        conn.send(("ok", target(host, *args)))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


def launch(hosts: int, target: Callable, args: Sequence[Any] = (), timeout: float = 600.0,
           host_env: Optional[Callable[[int], Dict[str, str]]] = None) -> List[Dict[str, Any]]:
    """Run target(host, *args) in `hosts` spawned processes, host i with RANK
    i of WORLD_SIZE hosts on a free MASTER_PORT and the variables
    host_env(i) (e.g. its CUDA_VISIBLE_DEVICES); returns each host's
    {"exitcode", "result"} or {"exitcode", "error"} (a traceback), by host.
    A host still running at the time limit is killed (exitcode < 0, error
    "timed out"); every process is reaped before it returns."""
    spawn = multiprocessing.get_context("spawn")
    port = free_port()
    procs, conns = [], []
    try:
        for h in range(hosts):
            recv, send = spawn.Pipe(duplex=False)
            p = spawn.Process(target=_host_entry, name=f"chirrup_tpu_torch:host{h}",
                              args=(h, hosts, port, target, tuple(args),
                                    host_env(h) if host_env else {}, send))
            p.start()
            send.close()
            procs.append(p)
            conns.append(recv)
        deadline = time.monotonic() + timeout
        out: List[Dict[str, Any]] = [{} for _ in range(hosts)]
        pending = set(range(hosts))
        while pending and time.monotonic() < deadline:
            ready = multiprocessing.connection.wait([conns[h] for h in pending], timeout=1.0)
            for h in list(pending):
                if conns[h] in ready:
                    try:
                        kind, value = conns[h].recv()
                        out[h]["result" if kind == "ok" else "error"] = value
                    except EOFError:
                        out[h]["error"] = "exited without a result"
                    pending.discard(h)
        for h in pending:
            out[h]["error"] = "timed out"
    finally:
        for p in procs:
            p.join(max(0.0, 10.0) if p.is_alive() else 0)
            if p.is_alive():
                p.kill()
                p.join(10.0)
        for c in conns:
            c.close()
    for h, p in enumerate(procs):
        out[h]["exitcode"] = p.exitcode
    return out


def require(results: List[Dict[str, Any]]) -> List[Any]:
    """Every host's result; raises with the failing hosts' errors."""
    bad = [(h, r) for h, r in enumerate(results) if "error" in r or r["exitcode"] != 0]
    if bad:
        raise RuntimeError("hosts failed:\n" + "\n".join(
            f"--- host {h} (exit {r['exitcode']})\n{r.get('error', '')}" for h, r in bad))
    return [r["result"] for r in results]


# ---------------------------------------------------------------- the model

@dataclasses.dataclass
class Config:
    """One dry run's model and serving settings, the same on every host."""

    layers: int = 2
    width: int = 128
    vocab: int = 300
    batch: int = 8            # the global batch; each host serves batch / hosts
    tp: int = 1
    device: str = "cpu"       # every host's device ("cuda": the current one)
    tp_devices: Optional[List[str]] = None
    dtype: str = "float32"
    quantization: Optional[str] = "int8"   # None: dense
    prefill_chunk: int = 8
    graphs: bool = True
    n_tok: int = 6            # tokens a request generates
    long_prompt: int = 40     # the long prompt of each host's requests
    voter: int = 0            # the host whose shutdown stops them all
    vocab_path: str = ""
    vote_timeout: float = 300.0
    tp_timeout: float = 300.0


def write_vocab(path: str, size: int) -> str:
    """A byte-complete vocab of `size` ids (ids 1..256 the single bytes, the
    rest distinct multi-byte ASCII strings)."""
    lines = [f"{b + 1} {bytes([b])!r} 1" for b in range(256)]
    lines += [f"{257 + i} {str(10 + i).encode()!r} {len(str(10 + i))}" for i in range(size - 257)]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
    return path


def model_config(cfg: Config):
    from chirrup_tpu_torch.engine.structures import ModelLoadConfig

    return ModelLoadConfig(
        model_path="<synthetic>", vocab_path=cfg.vocab_path, vocab_size=cfg.vocab,
        quantization=cfg.quantization, activation_dtype=cfg.dtype,
        wkv_state_dtype=cfg.dtype, prefill_chunk=cfg.prefill_chunk, tensor_parallel=cfg.tp,
        lockstep=True, synthetic_config=dict(n_layer=cfg.layers, n_embd=cfg.width,
                                             vocab_size=cfg.vocab))


def build_model(cfg: Config, batch: int, host: int = 0):
    """A meshless model (seed 0) of `batch` rows with host `host`'s sampler."""
    from chirrup_tpu_torch.engine.engine import build_serving_model
    from chirrup_tpu_torch.parallel import hosts

    return build_serving_model(model_config(cfg), batch, device=cfg.device, seed=0,
                               graphs=cfg.graphs, sampler_seed=hosts.sampler_seed(0, host))


def build_host_model(cfg: Config, batch: int, host: int):
    """Host `host`'s model of `batch` rows: meshless at tp 1, else rank 0 of
    a tp group of its own (its followers spawned on cfg.tp_devices, by
    default the host's CUDA devices 0..tp-1, or cfg.device for every rank
    on the CPU). Returns (model, close), close stopping the group."""
    import functools

    from chirrup_tpu_torch.engine.engine import build_serving_model
    from chirrup_tpu_torch.parallel import hosts, tp as tp_mod

    if cfg.tp == 1:
        return build_model(cfg, batch, host), lambda: None
    build = functools.partial(build_serving_model, model_config(cfg), batch, seed=0,
                              graphs=cfg.graphs, sampler_seed=hosts.sampler_seed(0, host))
    devices = cfg.tp_devices or (
        [f"cuda:{r}" for r in range(cfg.tp)] if cfg.device.startswith("cuda")
        else [cfg.device] * cfg.tp)
    connect, procs = tp_mod.start(cfg.tp, build, devices, timeout=cfg.tp_timeout)
    try:
        model = build(connect())
    except BaseException:
        tp_mod.stop(procs, 0.0)
        raise

    def close():
        model.close()
        codes = tp_mod.stop(procs, 60.0)
        if codes != [0] * len(procs):
            raise RuntimeError(f"host {host}: tp followers exited with {codes}")

    return model, close


@dataclasses.dataclass
class Greedy:
    temperature: float = 0.0
    top_p: float = 0.3
    top_k: int = 0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    penalty_decay: float = 1.0
    forbidden_tokens: tuple = ()


def row_prompt(row: int, n: int, V: int) -> List[int]:
    return [(13 * row + 7 * j) % (V - 2) + 1 for j in range(n)]


def drive_rows(model, rows: Sequence[int], steps: int = 3) -> np.ndarray:
    """Phase 1 on a model whose slot i is global row rows[i]: each row's own
    prompt (2 to prefill_chunk tokens) inserted, prefilled in one chunk but
    its last token, then `steps` greedy decode steps; (steps, len(rows))
    tokens."""
    B, T, V = model.batch_size, model.prefill_chunk, model.config.vocab_size
    carry = model.init_carry()
    tokens = np.zeros((B, T), np.int32)
    lengths = np.zeros((B,), np.int32)
    step = np.zeros((B,), np.int32)
    for i, g in enumerate(rows):
        model.insert_slot(carry, i, None, Greedy())
        p = row_prompt(g, 2 + g % (T - 1), V)
        tokens[i, :len(p) - 1] = p[:-1]
        lengths[i] = len(p) - 1
        step[i] = p[-1]
    model.prefill_step(carry, tokens, lengths)
    active = np.arange(B) < len(rows)
    out = []
    for k in range(steps):
        carry, sampled, _ = model.decode_step(carry, step, active, active, active & (k > 0))
        out.append(sampled.cpu().numpy()[:len(rows)])
    return np.stack(out)


def host_prompts(cfg: Config, host: int) -> List[List[int]]:
    """Host `host`'s requests: two short prompts and one of long_prompt tokens."""
    V = cfg.vocab
    return [row_prompt(100 * host + 1, 5, V), row_prompt(100 * host + 2, 12, V),
            row_prompt(100 * host + 3, cfg.long_prompt, V)]


class _Sink:
    def __init__(self):
        self.events = []

    def put_nowait(self, item):
        self.events.append(item)


def _tasks(cfg: Config, host: int):
    from chirrup_tpu_torch.engine.structures import Task

    return [Task(output_queue=_Sink(), task_event_queue=queue.Queue(), prompt_str="",
                 prefill_tokens=list(p), state=None, temperature=0.0, max_tokens=cfg.n_tok,
                 stop_tokens=[], presence_penalty=0.0, frequency_penalty=0.0)
            for p in host_prompts(cfg, host)]


def _tokens(task) -> List[int]:
    out = []
    for kind, payload in task.output_queue.events:
        if kind == "tokens_generated":
            out.extend(t for t, _ in payload)
        elif kind == "token_generated":
            out.append(payload[0])
    return out


def reference_tokens(model, cfg: Config, hosts: int) -> List[List[List[int]]]:
    """Every host's requests through a worker without lockstep on `model`
    (a batch of batch / hosts rows), one host's at a time."""
    from chirrup_tpu_torch.engine.worker import Worker
    from chirrup_tpu_torch.utils.tokenizer import WorldTokenizer

    tokenizer = WorldTokenizer(cfg.vocab_path)
    out = []
    for h in range(hosts):
        tasks = _tasks(cfg, h)
        q: "queue.Queue" = queue.Queue()
        for t in tasks:
            q.put(t)
        w = Worker(worker_id=f"reference{h}", model_factory=lambda: (model, tokenizer),
                   task_queue=q, master_event_queue=queue.Queue(), worker_event_queue=None,
                   batch_size=model.batch_size)
        w._init_worker()
        deadline = time.monotonic() + 600
        while not all(t.is_finished() for t in tasks):
            if time.monotonic() > deadline:
                raise RuntimeError("reference worker did not finish")
            w.run_once()
        w._process_pending()
        out.append([_tokens(t) for t in tasks])
    return out


# -------------------------------------------------------------- host phases

def phase_programs(cfg: Config, host: int, hosts: int, model) -> Dict[str, Any]:
    b = cfg.batch // hosts
    rows = list(range(host * b, (host + 1) * b))
    return {"rows": rows, "tokens": drive_rows(model, rows).tolist()}


def phase_worker(cfg: Config, host: int, hosts: int, model) -> Dict[str, Any]:
    """The lockstep Worker on its thread over this host's rows: the requests
    to completion, then the voter's shutdown. Also measures the host's ms a
    decode step while every request decodes (hosts sharing a device share
    its time) and the kernels' launches with the worker's steps and chunks."""
    from chirrup_tpu_torch.engine.worker import Worker, start_worker_thread
    from chirrup_tpu_torch.ops import _kernels
    from chirrup_tpu_torch.parallel import hosts as hosts_mod

    from chirrup_tpu_torch.utils.tokenizer import WorldTokenizer

    b = cfg.batch // hosts
    barrier = hosts_mod.vote_group(cfg.vote_timeout)
    vote = hosts_mod.vote_group(cfg.vote_timeout)
    tokenizer = WorldTokenizer(cfg.vocab_path)
    events: "queue.Queue" = queue.Queue()

    class _Events:
        def put_nowait(self, item):
            events.put(item)

    q: "queue.Queue" = queue.Queue()
    master: "queue.Queue" = queue.Queue()
    w = Worker(worker_id=f"host{host}", model_factory=lambda: (model, tokenizer),
               task_queue=q, master_event_queue=master, worker_event_queue=_Events(),
               batch_size=b, warmup_programs=True, lockstep=True, vote=vote,
               slot_range=(host * b, (host + 1) * b))
    thread = start_worker_thread(w)
    try:
        while True:
            _, kind, payload = events.get(timeout=600)
            if kind == "worker_loaded":
                if payload["status"] != "success":
                    raise RuntimeError(f"host {host}: worker failed to load: {payload}")
                break
        _kernels.reset_launches()
        steps0, chunks0 = w.steps_run, w.chunks_run
        tasks = _tasks(cfg, host)
        for t in tasks:
            q.put(t)
        # the decode window: from every request's first tokens to a block
        # before the last (a worker reads K tokens a block)
        marks: Dict[str, Any] = {}
        last = max(2, cfg.n_tok - 16)
        deadline = time.monotonic() + 600
        while not all(t.is_finished() for t in tasks):
            if time.monotonic() > deadline or not thread.is_alive():
                raise RuntimeError(f"host {host}: requests did not finish")
            n = min(len(t.generated_tokens) for t in tasks)
            if n >= 1:
                marks.setdefault("first", (time.perf_counter(), w.steps_run))
            if n >= last:
                marks.setdefault("last", (time.perf_counter(), w.steps_run))
            time.sleep(0.001)
        barrier.all_reduce([0])   # every host's requests are done
        t_vote = time.time()
        if host == cfg.voter:
            master.put({"type": "shutdown"})
        thread.join(600)
        if thread.is_alive():
            raise RuntimeError(f"host {host}: no shutdown quorum")
    finally:
        barrier.close()
    ms_step = None
    if "last" in marks and marks["last"][1] > marks["first"][1]:
        ms_step = (1e3 * (marks["last"][0] - marks["first"][0])
                   / (marks["last"][1] - marks["first"][1]))
    return {"tokens": [_tokens(t) for t in tasks], "stop_loop": w.loop_count,
            "stopped_at": time.time(), "vote_started": t_vote,
            "vote_us": 1e6 * w.vote_seconds / max(w.vote_loops, 1), "vote_loops": w.vote_loops,
            "ms_step": ms_step, "steps": w.steps_run - steps0, "chunks": w.chunks_run - chunks0,
            "launches": dict(_kernels.LAUNCHES)}


def _chat(port: int, body: Dict[str, Any]) -> Dict[str, Any]:
    conn = http.client.HTTPConnection(HOST_ADDR, port, timeout=600)
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"chat completion: {resp.status} {data[:500]!r}")
        return json.loads(data)
    finally:
        conn.close()


def phase_server(cfg: Config, host: int, hosts: int) -> Dict[str, Any]:
    """The engine and HTTP server (lockstep, a state pool of 4 rows): the
    same chat completion twice, the second resumed from the first's prefix
    snapshot; then the server closes (its engine votes) and joins."""
    from chirrup_tpu_torch.server.app import App
    from chirrup_tpu_torch.server.config import ServerConfig

    sc = ServerConfig(synthetic_model=f"{cfg.layers},{cfg.width}", vocab_path=cfg.vocab_path,
                      vocab_size=cfg.vocab, batch_size=cfg.batch, state_cache_size=4,
                      lockstep=1, tensor_parallel=cfg.tp,
                      quantization=cfg.quantization or "none", activation_dtype=cfg.dtype,
                      wkv_state_dtype=cfg.dtype, prefill_chunk=cfg.prefill_chunk,
                      device="" if cfg.device.startswith("cuda") else cfg.device,
                      host=HOST_ADDR, port=0)
    body = {"model": "rwkv-latest:no-thinking", "max_tokens": cfg.n_tok, "temperature": 0.0,
            "ignore_eos": True,
            "messages": [{"role": "user", "content": f"hello from host {host} again ok"}]}

    from chirrup_tpu_torch.parallel import hosts as hosts_mod

    barrier = hosts_mod.vote_group(cfg.vote_timeout)

    async def drive():
        app = App(sc)
        port = await app.start()
        try:
            await app.load()
            cold = await asyncio.to_thread(_chat, port, body)
            resumed = await asyncio.to_thread(_chat, port, body)
            stats = app.state_cache.stats()
            worker = app.engine.workers[0]
            # every host's requests are done before any server votes
            await asyncio.to_thread(barrier.all_reduce, [0])
        finally:
            await app.close()   # engine.shutdown votes; join waits for the quorum
            barrier.close()
        return {"cold": cold["choices"][0]["message"], "resumed": resumed["choices"][0]["message"],
                "cache_hits": stats["hits"], "slot_range": list(worker.slot_range),
                "stop_loop": worker.loop_count, "worker_alive": app.engine.worker_threads[0].is_alive()}

    return asyncio.run(drive())


def host_main(host: int, cfg: Config, phases: Sequence[str] = ("programs", "worker", "server")
              ) -> Dict[str, Any]:
    """One host's phases, in order; each phase's result by name."""
    from chirrup_tpu_torch.parallel.hosts import host_world

    hosts = host_world()[1]
    if cfg.device.startswith("cuda"):
        torch.cuda.set_device(torch.device(cfg.device))
    elif cfg.device == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // hosts))
    out: Dict[str, Any] = {}
    if "programs" in phases or "worker" in phases:
        model, close = build_host_model(cfg, cfg.batch // hosts, host)
        try:
            if "programs" in phases:
                out["programs"] = phase_programs(cfg, host, hosts, model)
            if "worker" in phases:
                out["worker"] = phase_worker(cfg, host, hosts, model)
        finally:
            close()
        del model
        if cfg.device.startswith("cuda"):
            torch.cuda.empty_cache()
    if "server" in phases:
        out["server"] = phase_server(cfg, host, hosts)
    return out


def check(cfg: Config, hosts: int, results: List[Dict[str, Any]], reference_model) -> List[str]:
    """The parent's checks of the hosts' results against `reference_model`
    (seed 0, batch / hosts rows, host 0's sampler); the problems found."""
    problems = []
    b = cfg.batch // hosts
    if "programs" in results[0]:
        for h, r in enumerate(results):
            want = drive_rows(reference_model, list(range(h * b, (h + 1) * b)))
            if r["programs"]["tokens"] != want.tolist():
                problems.append(f"host {h}: programs' tokens {r['programs']['tokens']} "
                                f"!= one model's {want.tolist()}")
    if "worker" in results[0]:
        want = reference_tokens(reference_model, cfg, hosts)
        for h, r in enumerate(results):
            if r["worker"]["tokens"] != want[h]:
                problems.append(f"host {h}: worker tokens {r['worker']['tokens']} != {want[h]}")
        loops = {r["worker"]["stop_loop"] for r in results}
        if len(loops) != 1:
            problems.append(f"hosts stopped after different loops: {loops}")
    if "server" in results[0]:
        for h, r in enumerate(results):
            s = r["server"]
            if s["cold"] != s["resumed"] or s["cache_hits"] < 1 or s["worker_alive"]:
                problems.append(f"host {h}: server phase {s}")
        if len({r["server"]["stop_loop"] for r in results}) != 1:
            problems.append("servers' workers stopped after different loops: "
                            f"{[r['server']['stop_loop'] for r in results]}")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chirrup_tpu_torch.parallel.dryrun_multihost")
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    device = args.device
    if device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    cuda = device.startswith("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(layers=args.layers, width=args.width, vocab=args.vocab, batch=args.batch,
                     tp=args.tp, device=device, quantization="int8" if cuda else None,
                     dtype="bfloat16" if cuda else "float32",
                     prefill_chunk=64 if cuda else 8, graphs=cuda and args.tp == 1,
                     tp_devices=None, vocab_path=write_vocab(os.path.join(tmp, "vocab.txt"),
                                                             args.vocab))
        t0 = time.time()
        results = require(launch(args.hosts, host_main, (cfg,), timeout=args.timeout))
        reference = build_model(cfg, cfg.batch // args.hosts)
        problems = check(cfg, args.hosts, results, reference)
    for h, r in enumerate(results):
        w = r["worker"]
        print(f"[host {h}] rows {r['programs']['rows'][0]}..{r['programs']['rows'][-1]}; "
              f"worker stopped after loop {w['stop_loop']}, vote {w['vote_us']:.1f} us a loop; "
              f"server: cold == resumed {r['server']['cold'] == r['server']['resumed']}")
    if problems:
        print("\n".join(problems))
        return 1
    print(f"dryrun_multihost OK: {args.hosts} hosts x tp {args.tp} in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

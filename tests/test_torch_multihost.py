"""Lockstep multi-host serving in chirrup_tpu_torch on the CPU: host
processes forked by parallel/dryrun_multihost.launch (each with the
environment torchrun sets: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), the
vote group over gloo, each host's engine at tp 1 and at tp 2 (its own gloo
tp group); the counterparts of tests/test_multihost.py and
tests/test_engine_tp.py::test_lockstep_engine_single_process.

The model is the JAX engine fixture's (JAX synthetic weights, seed 0,
float32), written once as a native checkpoint that every host reads; the
dp 1 port engine and the JAX engine serve the same prompts for comparison.
Every launch has its own time limit and reaps its processes.
"""

import asyncio
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from chirrup_tpu_torch.engine.engine import AsyncEngineCore
from chirrup_tpu_torch.engine.structures import ModelLoadConfig, PoolHandle, RequestState
from chirrup_tpu_torch.models import checkpoint
from chirrup_tpu_torch.models.config import RWKV7Config
from chirrup_tpu_torch.models.loader import params_from_numpy
from chirrup_tpu_torch.parallel import dryrun_multihost as dryrun
from chirrup_tpu_torch.parallel.hosts import ENV

from tests.engine_fixtures import VOCAB_SIZE, write_tiny_vocab

SYNTH = dict(n_layer=2, n_embd=128, vocab_size=VOCAB_SIZE, d_decay_lora=32, d_iclr_lora=32,
             d_v_lora=16, d_gate_lora=32)
# each host's greedy prompts (host 0's, host 1's)
PROMPTS = (("hello world the User says hello", "the Assistant says world"),
           ("hello the world", "User hello world the Assistant says hello again"))
CACHE_PROMPT = "hello world the Assistant says hello world again and again ok"
GREEDY = dict(temperature=0.0, stop_tokens=[0], presence_penalty=0.0, frequency_penalty=0.0)
# more forbidden ids than an admission's batched insert takes (8)
FORBIDDEN = list(range(100, 112))
BATCH = 8             # the global batch: 4 rows a host
GROUP_TIMEOUT = 60.0  # seconds a collective or a vote may wait
LAUNCH_TIMEOUT = 400.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    return write_tiny_vocab(str(tmp_path_factory.mktemp("vocab") / "vocab.txt"))


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    """The JAX engine's worker-0 weights as a native checkpoint."""
    import jax

    from chirrup_tpu.models.config import RWKV7Config as JConfig
    from chirrup_tpu.models.loader import synthetic_params as j_synthetic_params

    tree = jax.tree_util.tree_map(np.asarray, j_synthetic_params(JConfig(**SYNTH), seed=0))
    path = str(tmp_path_factory.mktemp("ckpt") / "model")
    checkpoint.save_native(path, RWKV7Config(**SYNTH), params_from_numpy(tree, device="cpu"))
    return path


def _config(vocab_path, model_path, tp=1, lockstep=True):
    return ModelLoadConfig(model_path=model_path, vocab_path=vocab_path, vocab_size=VOCAB_SIZE,
                           quantization=None, wkv_state_dtype="float32",
                           activation_dtype="float32", prefill_chunk=8, tensor_parallel=tp,
                           lockstep=lockstep)


async def _run(eng, prompt, **kw):
    """(tokens, logits rows, the cache_prefill payload or None)."""
    comp = eng.completion(prompt, **{**GREEDY, **kw})
    toks, logits, snap = [], [], None
    async for ev in comp:
        if ev[0] == "token":
            toks.append(ev[1])
            if len(ev) > 3:
                logits.append(ev[3])
        elif ev[0] == "cache_prefill":
            snap = ev[1]
    return toks, logits, snap


async def _serve(eng, host):
    """What a host serves: its greedy prompts at once, then (host 0 with host
    snapshots, host 1 from its state pool) a cache_prefill and its resume,
    then on host 1 a return_logits request and one with a forbidden set over
    the batched insert's cap."""
    out = {}
    runs = await asyncio.gather(*[_run(eng, p, max_tokens=5) for p in PROMPTS[host]])
    out["greedy"] = [r[0] for r in runs]
    ids = eng.tokenizer.encode(CACHE_PROMPT)
    cold, _, snap = await _run(eng, CACHE_PROMPT, prefill_tokens=list(ids), max_tokens=4,
                               cache_prefill=True, cache_prefill_padding=3)
    cut = len(snap["prefilled_tokens"])
    out["snapshot"] = type(snap["state"]).__name__
    resumed, _, _ = await _run(eng, CACHE_PROMPT, prefill_tokens=list(ids[cut:]),
                               state=snap["state"], max_tokens=4)
    out["cache"] = (cold, resumed, cut, len(ids))
    if host == 1:
        toks, logits, _ = await _run(eng, PROMPTS[1][0], max_tokens=3, return_logits=True)
        out["logits"] = (toks, [np.asarray(row).shape for row in logits],
                         [int(np.argmax(row)) for row in logits])
        out["forbidden"] = (await _run(eng, PROMPTS[1][1], max_tokens=5,
                                       forbidden_tokens=FORBIDDEN))[0]
    return out


def _lockstep_host(host, vocab_path, model_path, tp, voter):
    """One host's engine (lockstep, tp over gloo): _serve, then a barrier
    (every host done) and the voter's shutdown; every host's worker stops
    on the quorum."""
    from chirrup_tpu_torch.parallel import hosts

    barrier = hosts.vote_group(GROUP_TIMEOUT)

    async def go():
        eng = AsyncEngineCore()
        await eng.init(worker_num=1, model_config=_config(vocab_path, model_path, tp),
                       batch_size=BATCH, device="cpu", load_timeout=120,
                       tp_timeout=GROUP_TIMEOUT, vote_timeout=GROUP_TIMEOUT,
                       state_pool_size=4 if host == 1 else 0)
        worker = eng.workers[0]
        world = worker.model.tp.world if worker.model.tp is not None else 1
        try:
            out = await _serve(eng, host)
            await asyncio.to_thread(barrier.all_reduce, [0])
            if host == voter:
                eng.shutdown()
            await asyncio.to_thread(eng.worker_threads[0].join, 60)
            out.update(slot_range=worker.slot_range, stop_loop=worker.loop_count,
                       stopped=not eng.worker_threads[0].is_alive(), world=world)
        finally:
            eng.shutdown()
            eng.join(timeout=GROUP_TIMEOUT)
        out["followers_alive"] = [p.is_alive() for p in eng._tp_processes]
        return out

    try:
        return asyncio.run(asyncio.wait_for(go(), LAUNCH_TIMEOUT - 30))
    finally:
        barrier.close()


@pytest.fixture(scope="module")
def dp1(vocab_path, model_path):
    """The same requests on one port engine without lockstep (4 rows, a
    state pool), by host."""

    async def go():
        eng = AsyncEngineCore()
        await eng.init(worker_num=1, model_config=_config(vocab_path, model_path, lockstep=False),
                       batch_size=BATCH // 2, device="cpu", load_timeout=60,
                       state_pool_size=4)
        try:
            return [await _serve(eng, h) for h in range(2)]
        finally:
            eng.shutdown()
            eng.join(timeout=GROUP_TIMEOUT)

    return asyncio.run(asyncio.wait_for(go(), 120))


@pytest.fixture(scope="module")
def jax_greedy(vocab_path):
    """The JAX engine's greedy tokens for every host's prompts, same weights."""
    from chirrup_tpu.engine.engine import AsyncEngineCore as JEngine

    from tests.engine_fixtures import synthetic_model_config

    async def go():
        eng = JEngine()
        await eng.init(worker_num=1, batch_size=4, load_timeout=180,
                       model_config=synthetic_model_config(vocab_path, synthetic_config=SYNTH))
        try:
            out = []
            for prompts in PROMPTS:
                runs = []
                for p in prompts:
                    comp = eng.completion(p, max_tokens=5, **GREEDY)
                    runs.append([e[1] async for e in comp if e[0] == "token"])
                out.append(runs)
            return out
        finally:
            eng.shutdown()
            eng.join(timeout=10)

    return asyncio.run(asyncio.wait_for(go(), 200))


@pytest.fixture(scope="module", params=[1, 2], ids=["tp1", "tp2"])
def hosts_run(request, vocab_path, model_path):
    """Two lockstep hosts at tp 1 or 2; host 1 starts the shutdown."""
    tp = request.param
    t0 = time.monotonic()
    results = dryrun.require(dryrun.launch(
        2, _lockstep_host, (vocab_path, model_path, tp, 1), timeout=LAUNCH_TIMEOUT))
    return tp, results, time.monotonic() - t0


def test_lockstep_hosts_greedy_match_dp1_and_jax(hosts_run, dp1, jax_greedy):
    """Each host's greedy tokens equal the dp 1 port engine's and the JAX
    engine's on the same weights; host i serves rows (4i, 4i + 4) of the
    global batch of 8, over a tp group of its own at tp 2."""
    tp, results, _ = hosts_run
    for h, r in enumerate(results):
        assert r["slot_range"] == (4 * h, 4 * h + 4)
        assert r["world"] == tp
        assert all(len(t) >= 1 for t in r["greedy"])
        assert r["greedy"] == dp1[h]["greedy"] == jax_greedy[h]


def test_lockstep_cache_prefill_resume_equals_cold(hosts_run, dp1):
    """cache_prefill then state= on each host (host 0 a host RequestState,
    host 1 a row of its state pool) resumes to the cold run's tokens, which
    equal the dp 1 engine's."""
    _, results, _ = hosts_run
    assert [r["snapshot"] for r in results] == [RequestState.__name__, PoolHandle.__name__]
    for h, r in enumerate(results):
        cold, resumed, cut, n = r["cache"]
        assert cut == n - 3 and len(cold) >= 1
        assert resumed == cold == dp1[h]["cache"][0]


def test_lockstep_complex_admissions_on_host1(hosts_run, dp1):
    """On host 1: a return_logits request gets a (V,) logits row with each
    token (its argmax the greedy token) and the dp 1 engine's tokens; a
    forbidden set of 12 ids (over the batched insert's 8) is served with
    the dp 1 engine's tokens and none of the ids."""
    _, results, _ = hosts_run
    toks, shapes, argmax = results[1]["logits"]
    assert len(toks) >= 1 and shapes == [(VOCAB_SIZE,)] * len(toks) and argmax == toks
    assert toks == dp1[1]["logits"][0]
    forbidden = results[1]["forbidden"]
    assert len(forbidden) >= 1 and not set(forbidden) & set(FORBIDDEN)
    assert forbidden == dp1[1]["forbidden"]


def test_lockstep_shutdown_from_host1_stops_both_at_one_loop(hosts_run):
    """A shutdown started on host 1 stops both hosts' workers after the same
    loop, and every tp follower has exited."""
    _, results, seconds = hosts_run
    assert all(r["stopped"] for r in results)
    assert results[0]["stop_loop"] == results[1]["stop_loop"]
    assert not any(a for r in results for a in r["followers_alive"])
    assert seconds < LAUNCH_TIMEOUT


def _dead_peer_host(host, vocab_path):
    """A lockstep Worker run by hand; host 1 dies after three loops and
    host 0 loops on until its vote raises."""
    import queue

    from chirrup_tpu_torch.engine.worker import Worker
    from chirrup_tpu_torch.parallel import hosts

    cfg = dryrun.Config(vocab_path=vocab_path, vocab=VOCAB_SIZE)
    model = dryrun.build_model(cfg, 4, host)
    w = Worker(worker_id=f"host{host}", model_factory=lambda: (model, None),
               task_queue=queue.Queue(), master_event_queue=queue.Queue(),
               worker_event_queue=None, batch_size=4, lockstep=True,
               vote=hosts.vote_group(GROUP_TIMEOUT), slot_range=(4 * host, 4 * host + 4))
    w._init_worker()
    for _ in range(3):
        w.run_once()
    if host == 1:
        os._exit(3)
    t0 = time.monotonic()
    try:
        while time.monotonic() - t0 < 3 * GROUP_TIMEOUT:
            w.run_once()
    except Exception as exc:  # noqa: BLE001 — what the test reads
        return {"raised": repr(exc), "seconds": time.monotonic() - t0, "loop": w.loop_count}
    return {"raised": None, "seconds": time.monotonic() - t0, "loop": w.loop_count}


def test_killed_host_makes_its_peer_raise(vocab_path):
    """Host 1 dies between loops: host 0's next vote raises within the vote
    group's time-out instead of hanging."""
    results = dryrun.launch(2, _dead_peer_host, (vocab_path,), timeout=LAUNCH_TIMEOUT)
    assert results[1]["exitcode"] == 3
    r0 = results[0]
    assert results[0]["exitcode"] == 0, r0
    assert r0["result"]["raised"] is not None
    assert r0["result"]["seconds"] < GROUP_TIMEOUT + 10
    assert r0["result"]["loop"] == 4   # the loop after host 1's last


def test_lockstep_engine_single_host_tp2(vocab_path, model_path, monkeypatch):
    """Lockstep without the hosts' environment is one host (dp 1) over the
    whole batch, here at tp 2 (tests/test_engine_tp.py::
    test_lockstep_engine_single_process): correct greedy completions, the
    second in a reused slot equal to the first; a shutdown stops it and its
    follower."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)

    async def go():
        eng = AsyncEngineCore()
        await eng.init(worker_num=1, model_config=_config(vocab_path, model_path, tp=2),
                       batch_size=4, device="cpu", load_timeout=60, tp_timeout=GROUP_TIMEOUT)
        try:
            w = eng.workers[0]
            assert w.lockstep and w.slot_range == (0, 4) and w.vote is None
            assert w.model.tp.world == 2
            first = (await _run(eng, "hello world the User", max_tokens=4))[0]
            second = (await _run(eng, "hello world the User", max_tokens=4))[0]
            return first, second
        finally:
            eng.shutdown()
            eng.join(timeout=GROUP_TIMEOUT)
            assert not any(p.is_alive() for p in eng._tp_processes)

    first, second = asyncio.run(asyncio.wait_for(go(), 120))
    assert 1 <= len(first) <= 4 and second == first


def test_lockstep_refusals(vocab_path, model_path, monkeypatch):
    """Lockstep takes one worker, and a global batch that divides by the
    hosts."""
    cfg = _config(vocab_path, model_path)
    with pytest.raises(ValueError, match="exactly one worker"):
        asyncio.run(AsyncEngineCore().init(worker_num=2, model_config=cfg, device="cpu"))
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="must divide by the 3 lockstep hosts"):
        asyncio.run(AsyncEngineCore().init(worker_num=1, model_config=cfg, batch_size=8,
                                           device="cpu"))


def test_dryrun_multihost_runs_end_to_end():
    """python -m chirrup_tpu_torch.parallel.dryrun_multihost: two host
    processes, the three phases, exit 0."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ENV:
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-m", "chirrup_tpu_torch.parallel.dryrun_multihost",
                        "--timeout", str(LAUNCH_TIMEOUT)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=LAUNCH_TIMEOUT + 60)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "dryrun_multihost OK: 2 hosts" in r.stdout

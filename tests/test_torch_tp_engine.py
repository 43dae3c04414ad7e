"""Tensor parallelism through chirrup_tpu_torch's public entry points on the
CPU: AsyncEngineCore.init(tensor_parallel=...) (rank 0's worker here, the
other ranks spawned and joined by gloo), the server's --tensor_parallel flag,
and what the engine refuses. The counterparts of tests/test_engine_tp.py.

The model is the JAX engine fixture's (tests/engine_fixtures.py: JAX
synthetic weights, seed 0, float32), written once as a native checkpoint that
every rank reads its shard of; the JAX tp engine builds the same weights
itself.
"""

import asyncio
import http.client
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import jax
import pytest
import torch

from chirrup_tpu.engine.engine import AsyncEngineCore as JEngine
from chirrup_tpu.models.config import RWKV7Config as JConfig
from chirrup_tpu.models.loader import synthetic_params as j_synthetic_params
from chirrup_tpu_torch.engine.engine import AsyncEngineCore
from chirrup_tpu_torch.engine.structures import ModelLoadConfig, RequestState
from chirrup_tpu_torch.models import checkpoint
from chirrup_tpu_torch.models.config import RWKV7Config
from chirrup_tpu_torch.models.loader import params_from_numpy

from tests.engine_fixtures import VOCAB_SIZE, synthetic_model_config, write_tiny_vocab

SYNTH = dict(n_layer=2, n_embd=128, vocab_size=VOCAB_SIZE, d_decay_lora=32, d_iclr_lora=32,
             d_v_lora=16, d_gate_lora=32)
PROMPT = "hello world the User says hello"
CACHE_PROMPT = "hello world the Assistant says hello world again and again ok"
GREEDY = dict(temperature=0.0, stop_tokens=[0], presence_penalty=0.0, frequency_penalty=0.0)
GROUP_TIMEOUT = 30.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    return write_tiny_vocab(str(tmp_path_factory.mktemp("vocab") / "vocab.txt"))


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    """The JAX engine's worker-0 weights as a native checkpoint."""
    tree = jax.tree_util.tree_map(np.asarray, j_synthetic_params(JConfig(**SYNTH), seed=0))
    path = str(tmp_path_factory.mktemp("ckpt") / "model")
    checkpoint.save_native(path, RWKV7Config(**SYNTH), params_from_numpy(tree, device="cpu"))
    return path


def _config(vocab_path, model_path, tp=1):
    return ModelLoadConfig(model_path=model_path, vocab_path=vocab_path, vocab_size=VOCAB_SIZE,
                           quantization=None, wkv_state_dtype="float32",
                           activation_dtype="float32", prefill_chunk=8, tensor_parallel=tp)


async def _engine(cfg, **kw):
    eng = AsyncEngineCore()
    try:
        await eng.init(worker_num=kw.pop("worker_num", 1), model_config=cfg, batch_size=4,
                       load_timeout=60, device="cpu", tp_timeout=GROUP_TIMEOUT, **kw)
    except BaseException:
        _stop(eng)
        raise
    return eng


def _stop(eng):
    eng.shutdown()
    eng.join(timeout=GROUP_TIMEOUT)
    assert all(not p.is_alive() for p in eng._tp_processes)


async def _run(eng, prompt, **kw):
    """(tokens, the cache_prefill event's payload or None)."""
    comp = eng.completion(prompt, **{**GREEDY, **kw})
    toks, snap = [], None
    async for ev in comp:
        if ev[0] == "token":
            toks.append(ev[1])
        elif ev[0] == "cache_prefill":
            snap = ev[1]
    return toks, snap


def _greedy(cfg, n=6, **kw):
    async def go():
        eng = await _engine(cfg, **kw)
        try:
            model = eng.workers[0].model
            info = (model.tp.world if model.tp is not None else 1, model.wkv_width)
            return (await _run(eng, PROMPT, max_tokens=n))[0], info
        finally:
            _stop(eng)

    return asyncio.run(asyncio.wait_for(go(), 120))


def test_tp2_engine_greedy_matches_tp1_and_jax_tp2(vocab_path, model_path, cpu_devices):
    """Greedy completions through AsyncEngineCore at tensor_parallel=2 equal
    those at tp 1 and the JAX engine's at tp 2 on the same weights
    (tests/test_engine_tp.py:73-90): the followers exit when the engine is
    joined."""
    tp2, info2 = _greedy(_config(vocab_path, model_path, tp=2))
    assert info2 == (2, 64)
    tp1, info1 = _greedy(_config(vocab_path, model_path))
    assert info1 == (1, 128)

    async def run_jax():
        eng = JEngine()
        await eng.init(worker_num=1, batch_size=4, load_timeout=180,
                       model_config=synthetic_model_config(vocab_path, tensor_parallel=2,
                                                           synthetic_config=SYNTH))
        try:
            assert eng.workers[0].model.mesh.shape["tp"] == 2
            comp = eng.completion(PROMPT, max_tokens=6, **GREEDY)
            return [e[1] async for e in comp if e[0] == "token"]
        finally:
            eng.shutdown()
            eng.join(timeout=10)

    jax_tp2 = asyncio.run(asyncio.wait_for(run_jax(), 200))
    assert len(tp2) >= 1
    assert tp2 == tp1 == jax_tp2


@pytest.mark.parametrize("state_pool_size", [0, 4], ids=["host", "pool"])
def test_tp2_cache_prefill_resume_equals_uncached(vocab_path, model_path, state_pool_size):
    """At tp 2, a prompt with cache_prefill and then the same prompt resumed
    from its snapshot (a host RequestState gathered from both ranks, or a
    PoolHandle naming a row of every rank's pool) with the rest of the
    prompt: the resumed greedy tokens equal the uncached run's."""

    async def go():
        eng = await _engine(_config(vocab_path, model_path, tp=2),
                            state_pool_size=state_pool_size)
        try:
            ids = eng.tokenizer.encode(CACHE_PROMPT)
            toks1, snap = await _run(eng, CACHE_PROMPT, prefill_tokens=list(ids), max_tokens=4,
                                     cache_prefill=True, cache_prefill_padding=3)
            cut = len(snap["prefilled_tokens"])
            toks2, _ = await _run(eng, CACHE_PROMPT, prefill_tokens=list(ids[cut:]),
                                  state=snap["state"], max_tokens=4)
            return ids, toks1, snap, toks2
        finally:
            _stop(eng)

    ids, toks1, snap, toks2 = asyncio.run(asyncio.wait_for(go(), 120))
    assert list(snap["prefilled_tokens"]) == ids[:-3]
    if state_pool_size == 0:
        st = snap["state"]
        assert isinstance(st, RequestState)
        assert tuple(st.wkv.shape) == (2, 64, 128) and st.elapsed == len(ids) - 3
    assert len(toks1) >= 1 and toks2 == toks1


def test_tp2_serves_a_pth_and_its_int8_native_dir(vocab_path, tmp_path):
    """A `.pth` served as INT8 (w8a16, float32) at tp 2: every rank reads the
    dense tree on the host, quantizes it whole and keeps its shard; the
    native directory of the same quantized tree is read shard by shard. Both
    give the greedy tokens of the `.pth` at tp 1."""
    from chirrup_tpu_torch.engine import serving
    from chirrup_tpu_torch.models import loader
    from tests.test_loader import V, _make_state_dict

    pth = str(tmp_path / "model.pth")
    torch.save(_make_state_dict(), pth)
    native_dir = str(tmp_path / "native")
    cfg, params = loader.load_model(pth, device="cpu")
    checkpoint.save_native(native_dir, cfg, serving._quantize_params(params))

    def greedy(path, tp):
        mc = ModelLoadConfig(model_path=path, vocab_path=vocab_path, vocab_size=V,
                             quantization="int8", mm8_core="pallas", wkv_state_dtype="float32",
                             activation_dtype="float32", prefill_chunk=8, tensor_parallel=tp)

        async def go():
            eng = await _engine(mc)
            try:
                assert eng.workers[0].model.wkv_width == 128 // tp
                return (await _run(eng, "hello world the", max_tokens=6))[0]
            finally:
                _stop(eng)

        return asyncio.run(asyncio.wait_for(go(), 120))

    want = greedy(pth, 1)
    assert len(want) == 6
    assert greedy(pth, 2) == want
    assert greedy(native_dir, 2) == want


def test_engine_refuses_worker_num_with_tp(vocab_path, model_path, monkeypatch):
    """worker_num x tensor_parallel ranks beyond the visible CUDA devices
    (disjoint device groups in the JAX engine) raise before any process
    starts; so does a model factory, which the other ranks could not
    call."""
    cfg = _config(vocab_path, model_path, tp=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    eng = AsyncEngineCore()
    with pytest.raises(ValueError, match="worker_num 2 x tensor_parallel 2 needs 4 CUDA "
                                         "devices, 3 visible"):
        asyncio.run(eng.init(worker_num=2, model_config=cfg))
    assert eng._tp_processes == []
    monkeypatch.undo()
    with pytest.raises(ValueError, match="model_factory"):
        asyncio.run(AsyncEngineCore().init(worker_num=1, model_config=cfg, device="cpu",
                                           model_factory=lambda: None))


def test_tp_needs_its_cuda_devices(vocab_path, model_path):
    """Without a device or a device list, tensor_parallel takes CUDA devices
    0..tp-1 and raises where they are absent; it never falls back to the
    CPU."""
    cfg = _config(vocab_path, model_path, tp=2)
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices present: the default devices exist")
    with pytest.raises((RuntimeError, ValueError), match="CUDA"):
        asyncio.run(AsyncEngineCore().init(worker_num=1, model_config=cfg))


def test_server_tensor_parallel_flag_reaches_model_load_config(capsys):
    """--tensor_parallel reaches ModelLoadConfig (tests/test_engine_tp.py:
    122-132), as do --lockstep 1 and --worker_num 2 --tensor_parallel 2; a
    tensor_parallel below 1 is refused."""
    from chirrup_tpu_torch.server.app import _model_config_from_server_config
    from chirrup_tpu_torch.server.config import parse_config

    sc = parse_config(["--tensor_parallel", "4", "--synthetic_model", "2,128",
                       "--vocab_path", "/dev/null"])
    mc = _model_config_from_server_config(sc)
    assert isinstance(mc, ModelLoadConfig) and mc.tensor_parallel == 4 and not mc.lockstep
    sc = parse_config(["--lockstep", "1", "--vocab_path", "/dev/null"])
    assert _model_config_from_server_config(sc).lockstep is True
    sc = parse_config(["--worker_num", "2", "--tensor_parallel", "2", "--vocab_path", "/dev/null"])
    mc = _model_config_from_server_config(sc)
    assert (sc.worker_num, mc.tensor_parallel) == (2, 2)
    with pytest.raises(SystemExit):
        parse_config(["--tensor_parallel", "0"])
    assert "at least 1" in capsys.readouterr().err


def test_server_entry_point_serves_at_tp2(vocab_path, model_path):
    """python -m chirrup_tpu_torch.server --tensor_parallel 2 --device cpu on
    the checkpoint: it spawns its second rank, serves a greedy completion
    of 4 tokens, and exits 0 on SIGINT (its worker stops the rank)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "chirrup_tpu_torch.server", "--host", "127.0.0.1", "--port",
         "0", "--device", "cpu", "--tensor_parallel", "2", "--model-path", model_path,
         "--vocab-path", vocab_path, "--vocab-size", str(VOCAB_SIZE), "--quantization", "none",
         "--activation-dtype", "float32", "--wkv-state-dtype", "float32", "--prefill-chunk", "8",
         "--batch-size", "4", "--state-cache-size", "4"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    def call(port, body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request("POST", "/v1/chat/completions", body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        port, lines = None, []
        deadline = time.time() + 120
        while port is None:
            assert time.time() < deadline and proc.poll() is None, lines
            line = proc.stderr.readline()
            lines.append(line)
            if "listening on http://" in line:
                port = int(line.rsplit(":", 1)[1].split(";")[0])
        while "model loaded" not in lines[-1]:
            assert time.time() < deadline and proc.poll() is None, lines
            lines.append(proc.stderr.readline())
        status, body = call(port, {"messages": [{"role": "user", "content": "hello"}],
                                   "max_tokens": 4, "temperature": 0, "ignore_eos": True})
        assert status == 200 and body["usage"]["completion_tokens"] == 4
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()

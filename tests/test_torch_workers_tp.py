"""worker_num x tensor_parallel in chirrup_tpu_torch on the CPU: each worker
rank 0 of a tp group of its own (a thread of the engine's process, its
followers spawned, gloo between them), the counterpart of the JAX engine's
per-worker tp device groups (chirrup_tpu/engine/engine.py:212-241).

The model is the JAX engine fixture's (JAX synthetic weights, seed 0,
float32), written once as a native checkpoint that every rank reads its
shard of.
"""

import asyncio

import numpy as np
import pytest

from chirrup_tpu_torch.engine import engine as engine_mod
from chirrup_tpu_torch.engine.engine import AsyncEngineCore
from chirrup_tpu_torch.engine.structures import ModelLoadConfig
from chirrup_tpu_torch.models import checkpoint
from chirrup_tpu_torch.models.config import RWKV7Config
from chirrup_tpu_torch.models.loader import params_from_numpy

from tests.engine_fixtures import VOCAB_SIZE, synthetic_model_config, write_tiny_vocab

SYNTH = dict(n_layer=2, n_embd=128, vocab_size=VOCAB_SIZE, d_decay_lora=32, d_iclr_lora=32,
             d_v_lora=16, d_gate_lora=32)
PROMPTS = ("hello world the User says hello", "the Assistant says world", "hello the world",
           "User hello world the Assistant says hello again")
GREEDY = dict(temperature=0.0, stop_tokens=[0], presence_penalty=0.0, frequency_penalty=0.0)
GROUP_TIMEOUT = 30.0


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


def _config(vocab_path, model_path, tp):
    return ModelLoadConfig(model_path=model_path, vocab_path=vocab_path, vocab_size=VOCAB_SIZE,
                           quantization=None, wkv_state_dtype="float32",
                           activation_dtype="float32", prefill_chunk=8, tensor_parallel=tp)


def _serve(vocab_path, model_path, worker_num, tp):
    """Every prompt at once through an engine of worker_num workers at tp
    (2 rows each, so both workers of two take requests): the greedy tokens,
    each worker's (world, decode steps), and the followers after the join."""

    async def go():
        eng = AsyncEngineCore()
        await eng.init(worker_num=worker_num, model_config=_config(vocab_path, model_path, tp),
                       batch_size=2, device="cpu", load_timeout=90, tp_timeout=GROUP_TIMEOUT)
        try:
            worlds = [(w.model.tp.world if w.model.tp is not None else 1, w.model.wkv_width)
                      for w in eng.workers]
            runs = [eng.completion(p, max_tokens=5, **GREEDY) for p in PROMPTS]
            tokens = await asyncio.gather(*[_tokens(c) for c in runs])
            steps = [w.steps_run for w in eng.workers]
        finally:
            eng.shutdown()
            eng.join(timeout=GROUP_TIMEOUT)
        followers = [(p.name, p.is_alive(), p.exitcode) for p in eng._tp_processes]
        return tokens, worlds, steps, followers

    return asyncio.run(asyncio.wait_for(go(), 180))


async def _tokens(comp):
    return [e[1] async for e in comp if e[0] == "token"]


def test_workers_tp2_match_tp1_and_jax_tp2(vocab_path, model_path, cpu_devices):
    """Two workers, each a tp 2 group of its own: every greedy completion
    equals the one worker's at tp 1 and the JAX engine's at tp 2 on the same
    weights; both workers served, and both groups' followers exited 0 on
    shutdown."""
    tokens, worlds, steps, followers = _serve(vocab_path, model_path, 2, 2)
    assert worlds == [(2, 64), (2, 64)]
    assert all(s > 0 for s in steps)
    assert sorted(name for name, _, _ in followers) == ["chirrup_tpu_torch:w0tp1",
                                                       "chirrup_tpu_torch:w1tp1"]
    assert all(not alive and code == 0 for _, alive, code in followers)
    tp1, worlds1, _, _ = _serve(vocab_path, model_path, 1, 1)
    assert worlds1 == [(1, 128)]

    async def run_jax():
        from chirrup_tpu.engine.engine import AsyncEngineCore as JEngine

        eng = JEngine()
        await eng.init(worker_num=1, batch_size=4, load_timeout=180,
                       model_config=synthetic_model_config(vocab_path, tensor_parallel=2,
                                                           synthetic_config=SYNTH))
        try:
            assert eng.workers[0].model.mesh.shape["tp"] == 2
            return [await _tokens(eng.completion(p, max_tokens=5, **GREEDY)) for p in PROMPTS]
        finally:
            eng.shutdown()
            eng.join(timeout=10)

    jax_tp2 = asyncio.run(asyncio.wait_for(run_jax(), 200))
    assert all(len(t) >= 1 for t in tokens)
    assert tokens == tp1 == jax_tp2


class _FailingWorker(engine_mod.Worker):
    """worker_1 fails once its tp group is up and its model is built."""

    def _init_worker(self):
        super()._init_worker()
        if self.worker_id == "worker_1":
            raise RuntimeError("worker 1 cannot load")


def test_a_worker_failing_to_load_stops_every_group(vocab_path, model_path, monkeypatch):
    """Worker 1 fails to load after its group is up: init raises, and the
    followers of both groups are stopped."""
    monkeypatch.setattr(engine_mod, "Worker", _FailingWorker)
    eng = AsyncEngineCore()
    with pytest.raises(RuntimeError, match="worker_1 failed to load"):
        asyncio.run(asyncio.wait_for(
            eng.init(worker_num=2, model_config=_config(vocab_path, model_path, 2),
                     batch_size=2, device="cpu", load_timeout=90, tp_timeout=GROUP_TIMEOUT),
            120))
    eng.shutdown()
    eng.join(timeout=GROUP_TIMEOUT)
    assert len(eng._tp_processes) == 2
    assert not any(p.is_alive() for p in eng._tp_processes)


def test_worker_groups_take_disjoint_devices(monkeypatch):
    """Worker k's ranks take CUDA devices k*tp .. (k+1)*tp - 1; fewer than
    worker_num*tp visible devices raise a ValueError before any process
    starts; a device list gives each worker its slice, a device every rank."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    groups = engine_mod._tp_device_groups(2, 2, None, None)
    assert groups == [[torch.device("cuda", 0), torch.device("cuda", 1)],
                      [torch.device("cuda", 2), torch.device("cuda", 3)]]
    with pytest.raises(ValueError, match="needs 6 CUDA devices, 4 visible"):
        engine_mod._tp_device_groups(3, 2, None, None)
    assert engine_mod._tp_device_groups(2, 2, None, ["a", "b", "c", "d"]) == [["a", "b"],
                                                                            ["c", "d"]]
    assert engine_mod._tp_device_groups(2, 2, "cpu", None) == [["cpu", "cpu"], ["cpu", "cpu"]]
    with pytest.raises(ValueError, match="tp_devices: 2 devices"):
        engine_mod._tp_device_groups(2, 2, None, ["a", "b"])

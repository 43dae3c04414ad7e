"""chirrup_tpu_torch AsyncEngineCore (the decode slice, end to end) against the
JAX engine, plus the port's import and device rules."""

import asyncio
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from chirrup_tpu.engine.engine import AsyncEngineCore as JEngine
from chirrup_tpu_torch.engine.engine import AsyncEngineCore, build_model_factory
from chirrup_tpu_torch.engine.structures import ModelLoadConfig, RequestStatus
from chirrup_tpu_torch.engine.worker import Worker

from tests.engine_fixtures import VOCAB_SIZE, synthetic_model_config, write_tiny_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = "hello world the"


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    return write_tiny_vocab(str(tmp_path_factory.mktemp("vocab") / "vocab.txt"))


def _port_config(vocab_path):
    return ModelLoadConfig(
        model_path="<synthetic>", vocab_path=vocab_path, vocab_size=VOCAB_SIZE,
        quantization=None, wkv_state_dtype="float32", activation_dtype="float32",
        synthetic_config=dict(n_layer=2, n_embd=128, vocab_size=VOCAB_SIZE,
                              d_decay_lora=32, d_iclr_lora=32, d_v_lora=16,
                              d_gate_lora=32))


async def _greedy(engine, prompt, n):
    comp = engine.completion(prompt, temperature=0.0, max_tokens=n,
                             presence_penalty=0.0, frequency_penalty=0.0, stop_tokens=[0])
    out = [ev[1] async for ev in comp if ev[0] == "token"]
    return out, comp.task


def test_engine_greedy_matches_jax_engine(vocab_path):
    """The same synthetic model (the JAX engine's worker 0 weights, seed 0)
    behind both engines. The prompt is shorter than min_forward_seq_len in
    both workers, so both feed it token by token through the decode step and
    the greedy tokens must be equal. The port's engine gets the JAX
    weights through a model factory; the fp32 model keeps both within float32
    rounding, far inside this fixture's greedy margins."""
    import jax
    import numpy as np
    from chirrup_tpu.models.config import RWKV7Config as JConfig
    from chirrup_tpu.models.loader import synthetic_params as j_synthetic_params
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
    from chirrup_tpu_torch.models.loader import params_from_numpy
    from chirrup_tpu_torch.utils.tokenizer import WorldTokenizer

    n = 6
    cfg = _port_config(vocab_path)

    async def run_jax():
        eng = JEngine()
        await eng.init(worker_num=1, model_config=synthetic_model_config(vocab_path),
                       batch_size=2, load_timeout=120)
        try:
            assert len(eng.tokenizer.encode(PROMPT)) < eng.workers[0].min_forward_seq_len
            assert eng.workers[0].min_forward_seq_len == Worker.min_forward_seq_len
            return await _greedy(eng, PROMPT, n)
        finally:
            eng.shutdown()

    def factory():
        dense = jax.tree_util.tree_map(
            np.asarray, j_synthetic_params(JConfig(**cfg.synthetic_config), seed=0))
        rt = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32)
        model = ServingModel(RWKV7Config(**cfg.synthetic_config),
                             params_from_numpy(dense, device="cpu"), rt, 2, device="cpu")
        return model, WorldTokenizer(vocab_path)

    async def run_port():
        eng = AsyncEngineCore()
        await eng.init(worker_num=1, model_config=cfg, batch_size=2, load_timeout=60,
                       model_factory=factory, device="cpu")
        try:
            return await _greedy(eng, PROMPT, n)
        finally:
            eng.shutdown()

    want, _ = asyncio.run(asyncio.wait_for(run_jax(), 180))
    got, task = asyncio.run(asyncio.wait_for(run_port(), 60))
    assert len(want) >= 1
    assert got == want
    assert task.request_status in (RequestStatus.FINISHED_LENGTH_CAPPED,
                                   RequestStatus.FINISHED_STOPPED)


def test_engine_concurrent_requests_cpu(vocab_path):
    """More requests than slots, greedy and sampled with penalties, through the
    port's own synthetic-model factory in K-step decode blocks: every request
    finishes within its max_tokens, and the greedy one gives the same tokens
    alone and under load."""

    async def go():
        eng = AsyncEngineCore()
        await eng.init(worker_num=1, model_config=_port_config(vocab_path), batch_size=3,
                       load_timeout=60, decode_block_size=4, device="cpu")
        try:
            alone, _ = await _greedy(eng, PROMPT, 5)
            comps = [eng.completion(f"hello world {i}", temperature=1.0, top_p=0.8,
                                    max_tokens=3 + i, stop_tokens=[0],
                                    presence_penalty=0.3, frequency_penalty=0.3)
                     for i in range(4)]
            texts, (loaded, _) = await asyncio.gather(
                asyncio.gather(*[c.get_full_completion() for c in comps]),
                _greedy(eng, PROMPT, 5))
            return alone, loaded, comps, texts
        finally:
            eng.shutdown()
            eng.join(timeout=10)

    alone, loaded, comps, texts = asyncio.run(asyncio.wait_for(go(), 120))
    assert loaded == alone and len(alone) >= 1
    for i, (c, text) in enumerate(zip(comps, texts)):
        assert c.task.is_finished() and isinstance(text, str)
        assert 1 <= len(c.task.generated_tokens) <= 3 + i


@pytest.mark.parametrize("core,merged", [("auto", True), ("pallas", False)])
def test_engine_mm8_core(vocab_path, core, merged):
    """ModelLoadConfig.mm8_core reaches the worker's ServingModel: the w8a8
    default merges R/K/V into one weight, the exact w8a16 core ("pallas")
    keeps them apart; an INT8 engine on either core serves a greedy request."""
    cfg = dataclasses.replace(_port_config(vocab_path), quantization="int8", mm8_core=core)
    model, _ = build_model_factory(cfg, 2, device="cpu")()
    assert model.mm8_core == {"auto": "pallas_a8", "pallas": "pallas"}[core]
    assert ("Wrkv" in model.params["blocks"]["att"]) == merged

    async def go():
        eng = AsyncEngineCore()
        await eng.init(worker_num=1, model_config=cfg, batch_size=2, load_timeout=60,
                       device="cpu")
        try:
            return await _greedy(eng, PROMPT, 4)
        finally:
            eng.shutdown()

    tokens, task = asyncio.run(asyncio.wait_for(go(), 60))
    assert task.is_finished() and 1 <= len(tokens) <= 4


def test_package_imports_no_jax():
    """Importing the port (every module of it) loads neither JAX nor any module
    of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import chirrup_tpu_torch\n"
        "for m in pkgutil.walk_packages(chirrup_tpu_torch.__path__, 'chirrup_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'chirrup_tpu' or m.startswith('chirrup_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('chirrup_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_device_without_cuda_raises(vocab_path, monkeypatch):
    """With CUDA absent, every entry point that is given no device raises
    instead of running on the CPU."""
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
    from chirrup_tpu_torch.models.loader import synthetic_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_config(vocab_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model_factory(cfg, 2)
    small = RWKV7Config(n_layer=1, n_embd=64, vocab_size=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_params(small)
    params = synthetic_params(small, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingModel(small, params, RuntimeConfig(), 2)

    async def go():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            await AsyncEngineCore().init(worker_num=1, model_config=cfg, batch_size=2)

    asyncio.run(go())


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("wrapper", ["wkv7_step_fused", "wkv7_chunk_fused", "wkv7_batch",
                                     "quant_rows", "gemm", "mm8_core_w16", "penalty_tail"])
def test_wrappers_raise_off_cpu_and_cuda(wrapper):
    """A wrapper takes its plain version only for CPU tensors; any other device
    that is not CUDA raises instead of falling back."""
    from chirrup_tpu_torch.ops import mm8_cuda, sampling_cuda, wkv7_cuda

    B, C, V = 2, 64, 256
    i32, b8 = torch.int32, torch.bool
    calls = {
        "wkv7_step_fused": lambda: wkv7_cuda.wkv7_step_fused(
            _meta(1, B, 64, C), 0, *(_meta(B, C) for _ in range(5)),
            *(_meta(C) for _ in range(5)), _meta(B, dtype=i32), _meta(B, dtype=i32)),
        "wkv7_chunk_fused": lambda: wkv7_cuda.wkv7_chunk_fused(
            _meta(1, B, 64, C), 0, *(_meta(B, 3, C) for _ in range(5)),
            *(_meta(C) for _ in range(5)), _meta(B, dtype=i32), _meta(B, dtype=i32)),
        "wkv7_batch": lambda: wkv7_cuda.wkv7_batch(
            _meta(1, B, 64, C), *(_meta(B, 3, C) for _ in range(6)), _meta(B, dtype=i32)),
        "quant_rows": lambda: mm8_cuda.quant_rows(_meta(B, C), _meta(1, C), _meta(1, C)),
        "mm8_core_w16": lambda: mm8_cuda.mm8_core_w16(_meta(B, C),
                                                      _meta(C, C, dtype=torch.int8)),
        "gemm": lambda: mm8_cuda.gemm(_meta(1, B, C, dtype=torch.int8), _meta(1, B, 4),
                                      _meta(C, C, dtype=torch.int8), _meta(C), _meta(C)),
        "penalty_tail": lambda: sampling_cuda.penalty_tail(
            _meta(B, V), _meta(B, V), _meta(B, V), _meta(B), _meta(B), _meta(B),
            _meta(B, dtype=i32), _meta(B, dtype=b8), _meta(B, dtype=b8)),
    }
    with pytest.raises(ValueError, match="no kernel for device meta"):
        calls[wrapper]()

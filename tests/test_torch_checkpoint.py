"""The port's checkpoint loading against the JAX package's: `.pth` state dicts
(bit-equal trees, ln0 folded into emb), native checkpoint directories written
by either package (float32/int8 and bfloat16 leaves), parameter_groups, and
the engine serving from both kinds of checkpoint on the CPU."""

import asyncio
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from chirrup_tpu.engine.serving import ServingModel as JServing
from chirrup_tpu.engine.serving import _quantize_params as j_quantize_params
from chirrup_tpu.models import checkpoint as jckpt
from chirrup_tpu.models import loader as jloader
from chirrup_tpu.models.config import RuntimeConfig as JRuntime
from chirrup_tpu_torch.engine import serving
from chirrup_tpu_torch.engine.engine import AsyncEngineCore, build_model_factory
from chirrup_tpu_torch.engine.serving import ServingModel
from chirrup_tpu_torch.engine.structures import ModelLoadConfig
from chirrup_tpu_torch.models import checkpoint, loader
from chirrup_tpu_torch.models.config import RuntimeConfig
from chirrup_tpu_torch.ops.mm8 import Mm8Weight

from tests.engine_fixtures import write_tiny_vocab
from tests.test_loader import V, _make_state_dict


def _flat(tree, prefix=""):
    """{path: numpy array} of a tree of either package (Mm8Weight fields as
    .q/.mx/...; bfloat16 as its uint16 bits)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    elif hasattr(tree, "q") and hasattr(tree, "ry"):
        for f in ("q", "mx", "rx", "my", "ry"):
            out.update(_flat(getattr(tree, f), f"{prefix}.{f}"))
    elif isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        out[prefix] = (t.view(torch.int16).numpy().view(np.uint16)
                       if t.dtype == torch.bfloat16 else t.numpy())
    else:
        a = np.asarray(tree)
        out[prefix] = a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a
    return out


def _assert_bit_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _dir_bytes(path):
    return {f: open(os.path.join(path, f), "rb").read() for f in sorted(os.listdir(path))}


@pytest.fixture(scope="module", params=[True, False], ids=["block0_v", "no_block0_v"])
def pth(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pth") / "model.pth")
    torch.save(_make_state_dict(with_block0_v=request.param), path)
    return path


def test_pth_tree_bit_equal_to_jax_loader(pth):
    """infer_config and every leaf of the tree (the ln0-folded emb, the
    transposed linears, block 0's zero v-LoRA) equal the JAX loader's."""
    jcfg, jparams = jloader.load_model(pth)
    cfg, params = loader.load_model(pth, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_bit_equal(params, jparams)
    assert params["emb"].dtype == torch.float32
    sd = loader.load_state_dict_pth(pth)
    jsd = jloader.load_state_dict_pth(pth)
    for vocab_size in (None, 1024):
        assert (dataclasses.asdict(loader.infer_config(sd, vocab_size=vocab_size))
                == dataclasses.asdict(jloader.infer_config(jsd, vocab_size=vocab_size)))


def test_pth_loads_on_the_named_device_only(pth):
    if torch.cuda.is_available():
        assert loader.load_model(pth)[1]["emb"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loader.load_model(pth)


@pytest.fixture(scope="module")
def jax_int8(pth):
    cfg, params = jloader.load_model(pth)
    return cfg, j_quantize_params(params)


def test_jax_native_dir_loads_bit_equal(jax_int8, tmp_path):
    """A float32/int8 directory the JAX package writes loads in the port
    leaf for leaf; the port writes the same bytes for the same tree, and
    the JAX package loads the port's directory bit-equal."""
    jcfg, jparams = jax_int8
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_native(jdir, jcfg, jparams)
    assert checkpoint.is_native_checkpoint(jdir)
    cfg, params = checkpoint.load_native(jdir, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(checkpoint.native_config(jdir)) == dataclasses.asdict(jcfg)
    assert isinstance(params["blocks"]["att"]["Wr"], Mm8Weight)
    _assert_bit_equal(params, jparams)

    checkpoint.save_native(pdir, cfg, params)
    assert _dir_bytes(pdir) == _dir_bytes(jdir)
    jcfg2, jparams2 = jckpt.load_native(pdir)
    assert jcfg2 == jcfg
    _assert_bit_equal(params, jparams2)


def test_bf16_native_dir_loads_bit_equal(jax_int8, tmp_path):
    """bf16 leaves, as the converter's default writes them (descr '<V2'):
    each leaf the port loads carries the file's uint16 bits, and the port
    writes the same bytes for the same tree."""
    jcfg, jparams = jax_int8
    bf16 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        jparams)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_native(jdir, jcfg, bf16)
    with open(os.path.join(jdir, "meta.json")) as f:
        leaves = json.load(f)["leaves"]
    assert leaves["emb"]["dtype"] == "bfloat16"
    assert leaves["blocks.att.Wr.__mm8_q"]["dtype"] == "int8"

    cfg, params = checkpoint.load_native(jdir, device="cpu")
    assert params["emb"].dtype == torch.bfloat16
    flat = checkpoint._flatten(params)
    assert sorted(flat) == sorted(leaves)
    for key, info in leaves.items():
        raw = np.load(os.path.join(jdir, info["file"]))
        t = flat[key]
        if info["dtype"] == "bfloat16":
            assert raw.dtype.itemsize == 2
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          raw.view(np.uint16), err_msg=key)
            # the bits mean what ml_dtypes reads them as
            np.testing.assert_array_equal(
                t.float().numpy(), raw.view(ml_dtypes.bfloat16).astype(np.float32))
        else:
            np.testing.assert_array_equal(t.numpy(), raw, err_msg=key)
    _assert_bit_equal(params, bf16)

    checkpoint.save_native(pdir, cfg, params)
    assert _dir_bytes(pdir) == _dir_bytes(jdir)


def test_native_tree_is_not_quantized_again(jax_int8, tmp_path, monkeypatch):
    """ServingModel serves a native INT8 tree as it is stored; its logits
    match the JAX ServingModel's on the JAX package's own load of the same
    directory within test_torch_serving's tolerance (2e-3 of their scale),
    greedy tokens equal. Both run the w8a16 core: the w8a8 core rounds its
    activation codes, which XLA and PyTorch may round one code apart
    (test_torch_serving.py), and one code of this checkpoint's head input
    moves a logit by ~1.6% of the scale."""
    jcfg, jparams = jax_int8
    path = str(tmp_path / "native")
    jckpt.save_native(path, jcfg, jparams)
    cfg, params = checkpoint.load_native(path, device="cpu")

    def no_requantize(_params):
        raise AssertionError("a native INT8 tree was quantized again")

    monkeypatch.setattr(serving, "_quantize_params", no_requantize)
    rt = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32,
                       quantization="int8", mm8_core="pallas")
    tm = ServingModel(cfg, params, rt, batch_size=2, device="cpu")
    jrt = JRuntime(activation_dtype=jnp.float32, wkv_state_dtype=jnp.float32,
                   quantization="int8", use_pallas_wkv=True, mm8_core="pallas")
    jm = JServing(*jckpt.load_native(path), jrt, batch_size=2, prefill_chunk=8,
                  interpret_pallas=True)
    from tests.test_torch_serving import _Task

    jc = jm.insert_slot(jm.init_carry(), 0, None, _Task())
    tc = tm.insert_slot(tm.init_carry(), 0, None, _Task())
    act, fb = np.array([True, False]), np.zeros(2, bool)
    for tok in (3, 5, 9, 1):
        toks = np.array([tok, 0], np.int32)
        jc, j_tok, j_raw = jm.decode_step(jc, jnp.asarray(toks), jnp.asarray(act),
                                          jnp.asarray(act), jnp.asarray(fb))
        tc, t_tok, t_raw = tm.decode_step(tc, toks, act, act, fb)
        assert int(t_tok[0]) == int(j_tok[0])
        j_raw = np.asarray(j_raw, np.float32)[0]
        np.testing.assert_allclose(t_raw.numpy()[0], j_raw, rtol=0,
                                   atol=2e-3 * np.abs(j_raw).max())


@pytest.mark.parametrize("quantized", [False, True])
def test_parameter_groups_match_jax(pth, quantized):
    jcfg, jparams = jloader.load_model(pth)
    _, params = loader.load_model(pth, device="cpu")
    if quantized:
        jparams, params = j_quantize_params(jparams), serving._quantize_params(params)
    assert loader.parameter_groups(params) == jloader.parameter_groups(jparams)


def test_engine_serves_pth_and_native(pth, tmp_path):
    """build_model_factory serves a request on the CPU from a `.pth`
    (quantized by ServingModel) and from the native directory of the same
    quantized tree: the same greedy tokens."""
    vocab = write_tiny_vocab(str(tmp_path / "vocab.txt"))
    native_dir = str(tmp_path / "native")
    cfg, params = loader.load_model(pth, device="cpu")
    checkpoint.save_native(native_dir, cfg, serving._quantize_params(params))

    async def serve(path):
        mc = ModelLoadConfig(model_path=path, vocab_path=vocab, vocab_size=V,
                             quantization="int8", wkv_state_dtype="float32",
                             activation_dtype="float32", prefill_chunk=8)
        engine = AsyncEngineCore()
        await engine.init(worker_num=1, model_config=mc, batch_size=2, load_timeout=120,
                          model_factory=build_model_factory(mc, 2, device="cpu"))
        try:
            comp = engine.completion("hello world the", temperature=0.0, max_tokens=6,
                                     stop_tokens=())
            tokens = [ev[1] async for ev in comp if ev[0] == "token"]
            return tokens, comp.task
        finally:
            engine.shutdown()
            engine.join()

    from_pth, task = asyncio.run(asyncio.wait_for(serve(pth), 240))
    assert task.is_finished() and len(from_pth) == 6
    from_native, _ = asyncio.run(asyncio.wait_for(serve(native_dir), 240))
    assert from_native == from_pth

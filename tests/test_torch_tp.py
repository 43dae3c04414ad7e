"""chirrup_tpu_torch tensor parallelism (parallel/tp.py, ServingModel(tp=...))
against the JAX package's tp mesh.

The port's ranks are spawned processes joined by gloo on the CPU (rank 0 is
this process); the JAX package runs its tp mesh on the virtual CPU devices
(tests/conftest.py) with its Pallas kernels in interpret mode. Both start from
one numpy tree, the JAX synthetic model.

Limits, each taken from a test that already holds the same two paths apart:
- port tp against JAX tp at the same tp: greedy tokens equal, logits and
  states within 2e-3 of their scale (the port's meshless w8a8 limit against
  the JAX package, tests/test_torch_serving.py), elapsed equal;
- port tp against port meshless: the JAX package's own tp-against-meshless
  limits (tests/test_parallel.py), states within rtol = atol = 2e-4 under the
  w8a16 core in float32 (the same math up to the order of the float32 sums)
  and the wkv state within 5e-2 under w8a8, whose row-parallel inputs are
  quantized with per-rank scales, as the JAX tp path does.
Every multi-process test joins its processes within a limit and kills what
is left; the groups time out after GROUP_TIMEOUT seconds.
"""

import dataclasses
import functools
import gc
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chirrup_tpu.engine.serving import ServingModel as JServing
from chirrup_tpu.engine.serving import _quantize_params as j_quantize_params
from chirrup_tpu.models.config import RWKV7Config as JConfig
from chirrup_tpu.models.config import RuntimeConfig as JRuntime
from chirrup_tpu.models.loader import synthetic_params as j_synthetic_params
from chirrup_tpu.ops import mm8 as jmm8
from chirrup_tpu.ops import mm8_pallas
from chirrup_tpu.parallel.mesh import make_mesh, param_shardings
from chirrup_tpu_torch.engine.engine import build_serving_model
from chirrup_tpu_torch.engine.serving import ServingModel
from chirrup_tpu_torch.engine.structures import ModelLoadConfig
from chirrup_tpu_torch.models import checkpoint, loader
from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
from chirrup_tpu_torch.ops import mm8, mm8_cuda
from chirrup_tpu_torch.parallel import tp

GROUP_TIMEOUT = 30.0
LORA = dict(d_decay_lora=32, d_iclr_lora=32, d_v_lora=16, d_gate_lora=32)
# four heads: one a rank at tp 4
CFG = dict(n_layer=2, n_embd=256, vocab_size=512, **LORA)
B = 4


class _Task:
    temperature, top_p, top_k = 0.0, 0.3, 0
    frequency_penalty, presence_penalty, penalty_decay = 0.0, 0.0, 1.0
    forbidden_tokens = ()


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def dense_tree():
    return _numpy_tree(j_synthetic_params(JConfig(**CFG), seed=3))


@pytest.fixture(scope="module")
def model_path(dense_tree, tmp_path_factory):
    """The dense tree as a native checkpoint, which every rank reads."""
    path = str(tmp_path_factory.mktemp("ckpt") / "model")
    checkpoint.save_native(path, RWKV7Config(**CFG), loader.params_from_numpy(dense_tree,
                                                                              device="cpu"))
    return path


def _build_fn(model_path, core):
    """Each rank's model (tp.start's build): the checkpoint served as INT8
    under `core`, float32, quantized whole on the host and then sharded."""
    config = ModelLoadConfig(model_path=model_path, vocab_path="", vocab_size=CFG["vocab_size"],
                             quantization="int8", mm8_core=core, activation_dtype="float32",
                             wkv_state_dtype="float32", prefill_chunk=8)
    return functools.partial(build_serving_model, config, B)


def _leaves_with_paths(tree, path=()):
    """(path, field, leaf) of a raw tree, an INT8 weight's parts by field."""
    fields = mm8.mm8_fields(tree)
    if fields is not None:
        for f, v in fields.items():
            yield path, f, v
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, path + (k,))
    else:
        yield path, None, tree


def _get(tree, path, field):
    for k in path:
        tree = tree[k]
    if field is None:
        return tree
    return tree[field] if isinstance(tree, dict) else getattr(tree, field)


def _spec_axis(spec, ndim):
    """The axis a PartitionSpec puts on "tp" (negative), or None."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    axes = [i - ndim for i, s in enumerate(spec) if s == "tp"]
    return axes[0] if axes else None


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_shard_params_follows_param_shardings(dense_tree, quantized, cpu_devices):
    """For every leaf of the raw tree (dense, and INT8 as the JAX package
    quantizes it), shard_params splits it along the axis that
    param_shardings puts on "tp" (or keeps it whole where that rule
    replicates it), rank r's block being the r-th of tp equal blocks, and
    the ranks' blocks reassembled give the whole leaf back."""
    tree = dense_tree
    if quantized:
        tree = _numpy_tree(j_quantize_params(jax.tree_util.tree_map(jnp.asarray, dense_tree)))
    world = 4
    shardings = param_shardings(make_mesh(tp=world), tree)
    shards = [tp.shard_params(tree, r, world) for r in range(world)]
    seen = 0
    for path, field, leaf in _leaves_with_paths(tree):
        axis = _spec_axis(_get(shardings, path, field).spec, leaf.ndim)
        assert tp.shard_axis(path, field) == axis, (path, field)
        blocks = [np.asarray(_get(s, path, field)) for s in shards]
        if axis is None:
            for b in blocks:
                np.testing.assert_array_equal(b, leaf)
        else:
            for r, b in enumerate(blocks):
                np.testing.assert_array_equal(b, np.split(leaf, world, axis=axis)[r])
            np.testing.assert_array_equal(np.concatenate(blocks, axis=axis), leaf)
        seen += 1
    assert seen == len(jax.tree_util.tree_leaves(tree))
    # the port's own tree (tensors) shards the same way
    t_shard = tp.shard_params(loader.params_from_numpy(tree, device="cpu"), 1, world)
    for path, field, leaf in _leaves_with_paths(shards[1]):
        np.testing.assert_array_equal(_get(t_shard, path, field).numpy(), leaf)


def test_sharded_loading_equals_shard_params(dense_tree, tmp_path):
    """A rank's shard read out of a native checkpoint (dense and INT8), and
    a rank's shard of the synthetic INT8 model made leaf by leaf, equal
    shard_params of the whole tree."""
    cfg = RWKV7Config(**CFG)
    world = 2
    quantized = _numpy_tree(j_quantize_params(jax.tree_util.tree_map(jnp.asarray, dense_tree)))
    for name, tree in (("dense", dense_tree), ("int8", quantized)):
        path = str(tmp_path / name)
        checkpoint.save_native(path, cfg, loader.params_from_numpy(tree, device="cpu"))
        assert checkpoint.is_quantized(path) == (name == "int8")
        _, whole = checkpoint.load_native(path, device="cpu")
        for r in range(world):
            _, got = checkpoint.load_native(path, device="cpu", shard=(r, world))
            want = tp.shard_params(whole, r, world)
            for p, f, leaf in _leaves_with_paths(want):
                torch.testing.assert_close(_get(got, p, f), leaf, rtol=0, atol=0)
    whole = loader.synthetic_params_int8(cfg, seed=7, device="cpu")
    for r in range(world):
        got = loader.synthetic_params_int8(cfg, seed=7, device="cpu", shard=(r, world))
        for p, f, leaf in _leaves_with_paths(tp.shard_params(whole, r, world)):
            torch.testing.assert_close(_get(got, p, f), leaf, rtol=0, atol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_row_parallel_w8a8_on_a_shard_matches_jax(world):
    """Wo, quantized whole, on each rank's block of its input rows: the
    activation codes and the int32 accumulators of the port's quantizer and
    GEMM equal the JAX package's (_quant_rows, mm8_core_pallas_a8) bit for
    bit, and the fused product (gate as mul_in) equals JAX's
    mm8_fused_a8_stacked on the same shard within 2e-4 of its scale
    (tests/test_torch_mm8.py's limit)."""
    rng = np.random.default_rng(11)
    L, C, li = 2, 512, 1
    ws = [jmm8.quantize(jnp.asarray(rng.standard_normal((C, C)).astype(np.float32)
                                    / np.sqrt(C))) for _ in range(L)]
    wo = {f: np.stack([np.asarray(getattr(w, f)) for w in ws]) for f in mm8.MM8_FIELDS}
    y, g = (rng.standard_normal((B, C)).astype(np.float32) for _ in range(2))
    path = ("blocks", "att", "Wo")
    for r in range(world):
        w = tp.shard_params(wo, r, world, path=path)
        cols = slice(r * C // world, (r + 1) * C // world)  # the rank's heads of y
        y_r, g_r = y[:, cols], g[:, cols]
        x_r = np.ascontiguousarray(y_r * g_r)
        assert w["q"].shape == (L, C // world, C) and w["mx"].shape == (L, C)
        x8_j, *_ = mm8_pallas._quant_rows(jnp.asarray(x_r), jnp.asarray(w["ry"][li][None]),
                                          jnp.asarray(w["my"][li][None]))
        x8_t, _ = mm8_cuda.quant_rows(torch.from_numpy(x_r), torch.from_numpy(w["ry"][li][None]),
                                      torch.from_numpy(w["my"][li][None]))
        np.testing.assert_array_equal(x8_t[0].numpy(), np.asarray(x8_j))
        acc_j = np.asarray(mm8_pallas.mm8_core_pallas_a8(x8_j, jnp.asarray(w["q"][li]),
                                                         interpret=True))
        M = w["q"].shape[-1]
        acc_t = mm8_cuda.gemm(x8_t, torch.zeros(1, B, 4), torch.from_numpy(w["q"][li]),
                              torch.zeros(M), torch.zeros(M), out_dtype=torch.int32).numpy()
        np.testing.assert_array_equal(acc_t, acc_j)
        out_j = np.asarray(mm8_pallas.mm8_fused_a8_stacked(
            jnp.asarray(y_r), *(jnp.asarray(w[f][li]) for f in ("mx", "rx", "my", "ry")),
            jnp.asarray(w["q"]), li, mul_in=jnp.asarray(g_r), interpret=True))
        out_t = mm8_cuda.mm8_fused_a8(
            torch.from_numpy(np.ascontiguousarray(y_r)),
            *(torch.from_numpy(w[f][li]) for f in ("mx", "rx", "my", "ry")),
            torch.from_numpy(w["q"]), layer=li,
            mul_in=torch.from_numpy(np.ascontiguousarray(g_r))).numpy()
        np.testing.assert_allclose(out_t, out_j, rtol=0, atol=2e-4 * np.abs(out_j).max())


# ----------------------------------------------------------- the tp model

def _drive(model, array=np.asarray, reports=None):
    """tests/test_parallel.py's sequence: insert two slots, prefill one (6
    tokens), decode both greedily for 3 steps. Returns (tokens (3, B), raw
    logits (3, B, V), slot 0's snapshot). `reports`, when a list, gets the
    port model's replica_report after every step."""
    carry = model.init_carry()
    carry = model.insert_slot(carry, 0, None, _Task())
    carry = model.insert_slot(carry, 1, None, _Task())
    tokens = np.zeros((B, 8), np.int32)
    tokens[0, :6] = [5, 6, 7, 8, 9, 10]
    lengths = np.zeros((B,), np.int32)
    lengths[0] = 6
    carry = model.prefill_step(carry, array(tokens), array(lengths))
    out, logits = [], []
    step_tokens = np.array([11, 3, 0, 0], np.int32)
    active = np.array([True, True, False, False])
    for _ in range(3):
        carry, sampled, raw = model.decode_step(carry, array(step_tokens), array(active),
                                                array(active))
        s = np.asarray(sampled)
        out.append(s.copy())
        logits.append(np.asarray(raw, np.float32))
        step_tokens = np.where(s >= 0, s, step_tokens).astype(np.int32)
        if reports is not None:
            reports.append(model.replica_report(carry))
    return np.stack(out), np.stack(logits), model.extract_slot(carry, 0)


def _runtime(core):
    return RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32,
                         quantization="int8", mm8_core=core)


def _run_port_tp(model_path, world, core):
    """The port at tp = `world` on the CPU: rank 0 here, ranks 1.. spawned.
    Returns _drive's result and the replica reports."""
    build = _build_fn(model_path, core)
    connect, procs = tp.start(world, build, ["cpu"] * world, timeout=GROUP_TIMEOUT)
    model = None
    try:
        ctx = connect()
        model = build(ctx)
        assert model.wkv_width == CFG["n_embd"] // world
        assert model.params["blocks"]["att"]["Wo"].q.shape[1] == CFG["n_embd"] // world
        reports = []
        result = _drive(model, reports=reports)
    finally:
        if model is not None:
            model.close()
        codes = tp.stop(procs, GROUP_TIMEOUT)
    assert codes == [0] * (world - 1)
    return result, reports


@pytest.mark.parametrize("world,core", [(2, "pallas_a8"), (4, "pallas_a8"), (2, "pallas"),
                                        (4, "pallas")])
def test_tp_serving_matches_jax_tp_and_meshless(dense_tree, model_path, cpu_devices, world,
                                                 core):
    """The port's tp ServingModel on _drive against the JAX package's tp
    ServingModel at the same tp (the fused serving configuration, interpret
    mode) and against the port's meshless model, under both INT8 cores."""
    (tokens, logits, snap), reports = _run_port_tp(model_path, world, core)
    # every rank sampled the same tokens: the replicated carry is bit-equal
    for rep in reports:
        assert len(rep) == world
        assert len({r["digest"] for r in rep}) == 1
        assert all(r["last_sampled"] == rep[0]["last_sampled"] for r in rep)

    jrt = JRuntime(activation_dtype=jnp.float32, wkv_state_dtype=jnp.float32,
                   quantization="int8", use_pallas_wkv=True, mm8_core=core)
    jm = JServing(JConfig(**CFG), jax.tree_util.tree_map(jnp.asarray, dense_tree), jrt,
                  batch_size=B, prefill_chunk=8, mesh=make_mesh(tp=world), interpret_pallas=True)
    j_tokens, j_logits, j_snap = _drive(jm, array=jnp.asarray)
    np.testing.assert_array_equal(tokens, j_tokens)
    assert snap.elapsed == j_snap.elapsed == 6 + 3
    live = j_logits[:, :2]
    np.testing.assert_allclose(logits[:, :2], live, rtol=0, atol=2e-3 * np.abs(live).max())
    for a, b in ((snap.shift, j_snap.shift), (snap.wkv, j_snap.wkv)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-3 * np.abs(b).max())

    meshless = ServingModel(RWKV7Config(**CFG), loader.params_from_numpy(dense_tree, device="cpu"),
                            _runtime(core), B, prefill_chunk=8, device="cpu")
    m_tokens, _, m_snap = _drive(meshless)
    np.testing.assert_array_equal(tokens, m_tokens)
    assert snap.elapsed == m_snap.elapsed
    # tests/test_parallel.py's limits: w8a16 both states, w8a8 the wkv state
    # (the shift, each layer's input, drifts further under per-rank scales:
    # up to 7e-2 at 2 of 1,024 elements at tp 4 on this fixture, where the
    # port's tp path agrees with the JAX package's, held above, to ~3e-7)
    pairs = ((snap.shift, m_snap.shift), (snap.wkv, m_snap.wkv))
    tol = 2e-4 if core == "pallas" else 5e-2
    for a, b in pairs if core == "pallas" else pairs[1:]:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol, atol=tol)


def test_tp_snapshot_round_trip_and_pool(model_path):
    """At tp = 2: a host snapshot gathers the ranks' heads into the whole
    row, and inserting it back (each rank taking its heads) continues
    bit-equal to the slot it came from; a pool row stored and loaded on
    every rank does the same; the followers' carries are dropped as rank
    0's are collected."""
    build = _build_fn(model_path, "pallas_a8")
    connect, procs = tp.start(2, build, ["cpu"] * 2, timeout=GROUP_TIMEOUT)
    model = None
    try:
        ctx = connect()
        model = build(ctx)
        carry = model.init_carry()
        for s in range(3):
            model.insert_slot(carry, s, None, _Task())
        tokens = np.zeros((B, 8), np.int32)
        tokens[0] = np.arange(5, 13)
        lengths = np.array([8, 0, 0, 0], np.int32)
        model.prefill_step(carry, tokens, lengths)
        snap = model.extract_slot(carry, 0)
        assert tuple(snap.wkv.shape) == (2, 64, 256) and snap.elapsed == 8
        resolve = model.extract_slot_async(carry, 0)
        host = resolve()
        torch.testing.assert_close(host.wkv, snap.wkv, rtol=0, atol=0)
        pool = model.init_state_pool(2)
        model.pool_store_many(carry, pool, [(0, 1)])
        model.insert_slot(carry, 1, snap, _Task())
        model.pool_load(carry, pool, 1, 2)
        act = np.array([True, True, True, False])
        step = np.array([13, 13, 13, 0], np.int32)
        for _ in range(2):
            carry, sampled, _ = model.decode_step(carry, step, act, act)
            s = sampled.numpy()
            assert s[0] == s[1] == s[2]
            step = np.where(s >= 0, s, step).astype(np.int32)
        rows = [model.extract_slot(carry, s) for s in range(3)]
        for r in rows[1:]:
            torch.testing.assert_close(r.wkv, rows[0].wkv, rtol=0, atol=0)
            torch.testing.assert_close(r.shift, rows[0].shift, rtol=0, atol=0)
        rep = model.replica_report(carry)
        assert len({r["digest"] for r in rep}) == 1
        del carry, pool
        gc.collect()
        assert ctx._released  # sent with the next call
        model.replica_report(model.init_carry())
    finally:
        if model is not None:
            model.close()
        codes = tp.stop(procs, GROUP_TIMEOUT)
    assert codes == [0]


def test_killed_follower_makes_rank0_raise(model_path):
    """A follower killed while rank 0 serves: rank 0's next call raises at
    once (the follower's exit is checked before a call is sent), and a
    collective rank 0 makes with the dead rank raises within the group's
    time-out instead of hanging."""
    build = _build_fn(model_path, "pallas")
    connect, procs = tp.start(2, build, ["cpu"] * 2, timeout=GROUP_TIMEOUT)
    model = None
    try:
        ctx = connect()
        model = build(ctx)
        carry = model.init_carry()
        procs[0].kill()
        procs[0].join(GROUP_TIMEOUT)
        act = np.array([True, False, False, False])
        with pytest.raises(RuntimeError, match="rank 1 .* exited"):
            model.decode_step(carry, np.array([5, 0, 0, 0], np.int32), act, act)
        t0 = time.monotonic()
        with pytest.raises(Exception):
            ctx.all_reduce(torch.ones(4))
        assert time.monotonic() - t0 < GROUP_TIMEOUT + 10
    finally:
        if model is not None:
            model.close()
        tp.stop(procs, 5.0)
    assert not procs[0].is_alive()


def test_meshless_model_has_no_tp_path():
    """Without a TPContext nothing of the tp path runs: no reduce_fn, the
    whole wkv width, calls not mirrored, close() a no-op."""
    cfg = RWKV7Config(**CFG)
    model = ServingModel(cfg, loader.synthetic_params(cfg, seed=1, device="cpu"),
                         _runtime("pallas"), B, device="cpu")
    assert model.tp is None and model._reduce_fn is None and model.wkv_width == cfg.n_embd
    assert len(model.replica_report(model.init_carry())) == 1
    model.close()


def test_gloo_on_cuda_refuses_graphs():
    """A TPContext whose backend is gloo on a CUDA device cannot capture
    graphs: the model raises rather than running another path."""
    ctx = dataclasses.replace(
        tp.TPContext(rank=0, world=1, device=torch.device("cpu"), backend="gloo", group=None,
                     ctrl=None), device=torch.device("cuda", 0))

    cfg = RWKV7Config(**CFG)
    with pytest.raises(ValueError, match="graphs=False"):
        ServingModel(cfg, {}, _runtime("pallas"), B, tp=ctx)

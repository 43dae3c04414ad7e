"""The w8a16 GEMM's host side (ops/mm8_cuda.py w16_plan) and the K-major
codes of ServingModel under mm8_core "pallas", on the CPU.

The kernel (csrc/mm8_w16.cu) reads the int8 codes K-major through the same
tensor map as the w8a8 GEMM and launches the tile configuration, cluster
split and grid that w16_plan returns; both are plain Python, so what the
kernel relies on is checked here: the layout and its values against the JAX
package's tree, that no N-major copy outlives the load, that the split-K
slices cover K exactly once, that every decode site fills the card, and that
unsupported shapes and N-major codes are refused. The kernel's own results
are checked on the card by chip_smoke.py.
"""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chirrup_tpu.engine.serving import ServingModel as JServing
from chirrup_tpu.models.config import RWKV7Config as JConfig
from chirrup_tpu.models.config import RuntimeConfig as JRuntime
from chirrup_tpu.models.loader import synthetic_params as j_synthetic_params
from chirrup_tpu.ops import mm8_pallas
from chirrup_tpu_torch.engine.serving import ServingModel
from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
from chirrup_tpu_torch.models.loader import params_from_numpy, synthetic_params_int8
from chirrup_tpu_torch.ops import mm8 as tmm8
from chirrup_tpu_torch.ops import mm8_cuda

# (site, K, M) of the w8a16 serving path at 7.2B width (C 4096, d_ffn 16384,
# V 65536): R, K, V and Wo share one shape; the FFN pair; the head
SITES = [("att R/K/V/Wo", 4096, 4096), ("ffn Wk", 4096, 16384), ("ffn Wv", 16384, 4096),
         ("head", 4096, 65536)]
ROWS = [1, 37, 64, 512, 1000, 2048]
LORA = dict(d_decay_lora=32, d_iclr_lora=32, d_v_lora=16, d_gate_lora=32)
W16 = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32,
                    quantization="int8", mm8_core="pallas")


def _code_tensors(params):
    att, ffn = params["blocks"]["att"], params["blocks"]["ffn"]
    return {**{f"att {k}": att[k] for k in ("Wr", "Wk", "Wv", "Wo")},
            "ffn Wk": ffn["Wk"], "ffn Wv": ffn["Wv"], "head": params["head"]}


def _k_major(q):
    K = q.shape[-2]
    layers = [q[i] for i in range(q.shape[0])] if q.dim() == 3 else [q]
    return all(t.stride() == (1, K) for t in layers)


def test_w16_codes_k_major_match_jax_tree():
    """Under mm8_core "pallas" ServingModel stores every code tensor (R, K, V
    unmerged, Wo, the FFN pair, the head) K-major, with the logical shape and
    the values of the JAX ServingModel's tree built from the same dense
    weights; the scales are the JAX ones too, and no code tensor holds a
    second copy."""
    cfg = dict(n_layer=2, n_embd=128, vocab_size=512, **LORA)
    dense = jax.tree_util.tree_map(np.asarray, j_synthetic_params(JConfig(**cfg), seed=4))
    jrt = JRuntime(activation_dtype=jnp.float32, wkv_state_dtype=jnp.float32,
                   quantization="int8", use_pallas_wkv=True, mm8_core="pallas")
    jm = JServing(JConfig(**cfg), jax.tree_util.tree_map(jnp.asarray, dense), jrt,
                  batch_size=2, interpret_pallas=True)
    tm = ServingModel(RWKV7Config(**cfg), params_from_numpy(dense, device="cpu"), W16,
                      batch_size=2, device="cpu")
    want, got = _code_tensors(jm.params), _code_tensors(tm.params)
    for site, w in got.items():
        assert _k_major(w.q) and not w.q.is_contiguous(), site
        assert w.q.untyped_storage().nbytes() == w.q.numel(), site
        np.testing.assert_array_equal(w.q.numpy(), np.asarray(want[site].q), site)
        for f in ("mx", "rx", "my", "ry"):
            np.testing.assert_array_equal(getattr(w, f).numpy(),
                                          np.asarray(getattr(want[site], f)), f"{site} {f}")


def test_w16_load_frees_n_major_codes(monkeypatch):
    """Given a function that makes the tree, ServingModel under mm8_core
    "pallas" replaces each of its seven code tensors by its K-major copy one
    at a time: every N-major tensor is freed before the next copy is made and
    none outlives the load."""
    cfg = RWKV7Config(n_layer=2, n_embd=128, vocab_size=512)
    replaced = []
    real = tmm8.to_k_major

    def to_k_major(w):
        assert all(r() is None for r in replaced), "an N-major code tensor is still alive"
        out = real(w)
        replaced.append(weakref.ref(w.q))
        return out

    monkeypatch.setattr(tmm8, "to_k_major", to_k_major)
    m = ServingModel(cfg, lambda: synthetic_params_int8(cfg, seed=2, dtype=torch.float32,
                                                        device="cpu"), W16, 2, device="cpu")
    assert len(replaced) == 7 and all(r() is None for r in replaced)
    assert all(_k_major(w.q) for w in _code_tensors(m.params).values())


@pytest.mark.parametrize("B", ROWS)
def test_w16_plan_serving_sites(B):
    """At every path-A site and row count: a tile of W16_TILES, the 64 x 128
    decode tile with K split across a cluster of at most 4 (at least 128
    CTAs at every site) at B <= 64 and a 128-row prefill tile, unsplit,
    above; the split-K slices are whole 128-deep stages that cover K exactly
    once; the grid covers every row and column."""
    for site, K, M in SITES:
        plan = mm8_cuda.w16_plan(B, K, M, (1, K))
        assert mm8_cuda.W16_TILES.get((plan.bm, plan.bn)) == plan.stages, site
        cover = np.zeros(K, np.int64)
        for k0, k1 in plan.k_slices:
            assert k0 % mm8_cuda.W16_BK == 0 and k1 % mm8_cuda.W16_BK == 0 and k1 > k0
            cover[k0:k1] += 1
        assert (cover == 1).all(), site
        assert len(plan.k_slices) == plan.split and plan.split in (1, 2, 4)
        gx, gy, gz = plan.grid
        assert gz == 1 and gx % plan.split == 0
        assert (gx // plan.split) * plan.bm >= B > (gx // plan.split - 1) * plan.bm
        assert gy * plan.bn == M
        if B <= 64:
            assert (plan.bm, plan.bn) == (64, 128) and gx * gy >= 128, (site, plan)
        else:
            assert plan.bm == 128 and plan.bn in (128, 256) and plan.split == 1, (site, plan)


def test_w16_plan_decode_splits():
    """The decode tile fits two CTAs on an SM, so K is split until the grid
    has 256 CTAs, at most 4 ways: the 32 column tiles of R, K, V, Wo and FFN
    Wv 4 ways, FFN Wk's 128 tiles 2 ways; the head's 512 are not split."""
    splits = {site: mm8_cuda.w16_plan(64, K, M, (1, K)).split for site, K, M in SITES}
    assert splits == {"att R/K/V/Wo": 4, "ffn Wk": 2, "ffn Wv": 4, "head": 1}


@pytest.mark.parametrize("B,wide", [(512, {"ffn Wk"}),
                                    (1000, {"att R/K/V/Wo", "ffn Wk", "ffn Wv"}),
                                    (2048, {"att R/K/V/Wo", "ffn Wk", "ffn Wv"})])
def test_w16_plan_prefill_width_fills_waves(B, wide):
    """At prefill row counts the tile is 256 columns wide unless 128 fills
    the waves of one CTA per SM on 132 SMs clearly better, by the w8a8
    GEMM's rule: at 512 rows the 4096-wide sites would have 64 CTAs of 256
    columns, so they take 128."""
    for site, K, M in SITES[:3]:
        plan = mm8_cuda.w16_plan(B, K, M, (1, K), sms=132)
        assert plan.bn == (256 if site in wide else 128), (B, site)
        assert mm8_cuda.W16_TILES[(plan.bm, plan.bn)] == plan.stages


@pytest.mark.parametrize("case,args", [
    ("N-major codes", (64, 4096, 4096, (4096, 1))),
    ("N-major head", (2048, 4096, 65536, (65536, 1))),
    ("a strided view", (64, 4096, 4096, (2, 8192))),
    ("K not a multiple of 128", (64, 4032, 4096, (1, 4032))),
    ("M not a multiple of 128", (64, 4096, 4032, (1, 4096))),
    ("no rows", (0, 4096, 4096, (1, 4096))),
])
def test_w16_plan_refuses(case, args):
    with pytest.raises(ValueError):
        mm8_cuda.w16_plan(*args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_core_w16_k_major_matches_pallas(dtype):
    """The plain version reads K-major codes as the JAX core reads N-major
    ones: mm8_core_w16 on layer li of stacked K-major codes against
    mm8_core_pallas_stacked (interpret mode) on the same values. Both sum
    exact products in float32, in orders that differ (the CPU's BLAS takes
    another path for the transposed layout): 1e-5 of the output's scale."""
    rng = np.random.default_rng(6)
    L, B, K, M, li = 2, 5, 256, 384, 1
    q = rng.integers(-128, 128, (L, K, M)).astype(np.int8)
    qk = tmm8.to_k_major(tmm8.Mm8Weight(torch.from_numpy(q), *(torch.zeros(L, n) for n in
                                                              (M, M, K, K)))).q
    assert _k_major(qk) and torch.equal(qk, torch.from_numpy(q))
    xs = rng.standard_normal((B, K)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(mm8_pallas.mm8_core_pallas_stacked(jnp.asarray(xs, jdt), jnp.asarray(q),
                                                         li, interpret=True))
    got = mm8_cuda.mm8_core_w16(torch.from_numpy(xs).to(tdt), qk, layer=li)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, M)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())

"""The w8a8 GEMM's host side (ops/mm8.py to_k_major, ops/mm8_cuda.py
gemm_plan) and the K-major codes of ServingModel, on the CPU (the w8a16
GEMM's plan: tests/test_torch_mm8_w16_plan.py).

The kernel (csrc/mm8_a8.cu) reads the int8 codes K-major and launches the
tile configuration, cluster split and grid that gemm_plan returns; both are
plain Python, so what the kernel relies on is checked here: the layout, that
tiles never straddle an R/K/V variant, that the split-K slices cover K exactly
once, that every decode site fills the card, and that unsupported shapes and
N-major codes are refused. The kernel's own exactness is checked on the card
by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from chirrup_tpu.ops import mm8_pallas
from chirrup_tpu_torch.engine.serving import ServingModel
from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
from chirrup_tpu_torch.models.loader import synthetic_params_int8
from chirrup_tpu_torch.ops import mm8 as tmm8
from chirrup_tpu_torch.ops import mm8_cuda

# (site, n variants, K, M) of the 7.2B serving path (C 4096, d_ffn 16384,
# V 65536): merged R/K/V, Wo, the FFN pair, the head
SITES = [("att R/K/V", 3, 4096, 3 * 4096), ("att Wo", 1, 4096, 4096),
         ("ffn Wk", 1, 4096, 16384), ("ffn Wv", 1, 16384, 4096), ("head", 1, 4096, 65536)]
ROWS = [1, 37, 64, 512, 1000, 2048]


def _k_major_layers(q):
    K = q.shape[-2]
    return all(q[i].stride() == (1, K) for i in range(q.shape[0])) if q.dim() == 3 \
        else q.stride() == (1, K)


@pytest.mark.parametrize("kind", ["unstacked", "stacked", "multi"])
def test_to_k_major(kind):
    """Same logical values and shape, each layer with strides (1, K), a view
    of one storage of exactly numel bytes (no hidden second copy), q[layer] a
    view at a pointer offset, and a second call a no-op."""
    g = torch.Generator().manual_seed(1)
    codes = lambda *s: torch.randint(-128, 128, s, generator=g, dtype=torch.int8)
    if kind == "unstacked":
        w = tmm8.quantize(torch.randn(256, 384, generator=g))
    elif kind == "stacked":
        w = tmm8.quantize_stacked(torch.randn(3, 256, 128, generator=g))
    else:
        parts = [tmm8.Mm8Weight(codes(2, 128, 256), *(torch.rand(2, n, generator=g)
                                                      for n in (256, 256, 128, 128)))
                 for _ in range(3)]
        w = tmm8.merge_stacked(parts)
    wk = tmm8.to_k_major(w)
    q = wk.q
    assert type(wk) is type(w) and q.shape == w.q.shape and q.dtype == torch.int8
    assert torch.equal(q, w.q)
    assert _k_major_layers(q) and not _k_major_layers(w.q)
    assert q.untyped_storage().nbytes() == q.numel()
    for f in ("mx", "rx", "my", "ry"):
        assert getattr(wk, f) is getattr(w, f)
    if q.dim() == 3:
        K, M = q.shape[1:]
        assert q[1].data_ptr() == q.data_ptr() + K * M
    again = tmm8.to_k_major(wk)
    assert again is wk and again.q.data_ptr() == q.data_ptr()


@pytest.mark.parametrize("core", ["pallas_a8", "pallas"])
def test_serving_model_code_layout(core):
    """ServingModel stores every code tensor K-major under both cores, as
    both GEMM kernels read them: the w8a8 core's merged R/K/V and the w8a16
    core's separate R, K, V, then Wo, the FFN pair and the head; no code
    tensor keeps a second copy under either."""
    cfg = RWKV7Config(n_layer=2, n_embd=128, vocab_size=512)
    params = synthetic_params_int8(cfg, seed=2, dtype=torch.float32, device="cpu")
    rt = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32,
                       quantization="int8", mm8_core=core)
    m = ServingModel(cfg, params, rt, 2, device="cpu")
    att, ffn = m.params["blocks"]["att"], m.params["blocks"]["ffn"]
    names = (["Wrkv"] if core == "pallas_a8" else ["Wr", "Wk", "Wv"]) + ["Wo"]
    ws = [att[k] for k in names] + [ffn["Wk"], ffn["Wv"], m.params["head"]]
    for w in ws:
        assert _k_major_layers(w.q) and not w.q.is_contiguous()
        assert w.q.untyped_storage().nbytes() == w.q.numel()
    assert torch.equal(m.params["head"].q, params["head"].q)
    assert torch.equal(att["Wo"].q, params["blocks"]["att"]["Wo"].q)


@pytest.mark.parametrize("B", ROWS)
def test_gemm_plan_serving_sites(B):
    """At every serving site and row count: the tile is the decode one (64
    rows, split-K across a cluster until the grid has >= 128 CTAs) at B <= 64
    and a 128-row prefill tile above; no tile straddles a variant; the split-K
    slices are whole 128-byte stages that cover K exactly once; the grid
    covers every row and column."""
    for site, n, K, M in SITES:
        plan = mm8_cuda.gemm_plan(n, B, K, M, (1, K))
        width = M // n
        assert width % plan.bn == 0, site
        assert (plan.bm, plan.bn, plan.stages) in {(bm, bn, s) for (bm, bn), s
                                                   in mm8_cuda.A8_TILES.items()}
        cover = np.zeros(K, np.int64)
        for k0, k1 in plan.k_slices:
            assert k0 % mm8_cuda.A8_BK == 0 and k1 % mm8_cuda.A8_BK == 0 and k1 > k0
            cover[k0:k1] += 1
        assert (cover == 1).all(), site
        assert len(plan.k_slices) == plan.split and plan.split in (1, 2, 4)
        gx, gy, gz = plan.grid
        assert gz == 1 and gx % plan.split == 0
        assert (gx // plan.split) * plan.bm >= B > (gx // plan.split - 1) * plan.bm
        assert gy * plan.bn == M
        if B <= 64:
            assert plan.bm == 64 and gx * gy >= 128, (site, plan)
        else:
            assert plan.bm == 128 and plan.split == 1


def test_gemm_plan_decode_splits():
    """The column tiles of R/K/V (96), Wo and FFN Wv (32 each) fall short of
    the card, so K is split 2, 4 and 4 ways; FFN Wk (128 tiles) and the head
    (512) are not split."""
    splits = {site: mm8_cuda.gemm_plan(n, 64, K, M, (1, K)).split for site, n, K, M in SITES}
    assert splits == {"att R/K/V": 2, "att Wo": 4, "ffn Wk": 1, "ffn Wv": 4, "head": 1}


@pytest.mark.parametrize("case,args", [
    ("N-major codes", (1, 64, 4096, 4096, (4096, 1))),
    ("N-major, R/K/V", (3, 2048, 4096, 12288, (12288, 1))),
    ("K not a multiple of 128", (1, 64, 4032, 4096, (1, 4032))),
    ("variant width not a multiple of 128", (3, 64, 4096, 3 * 4032, (1, 4096))),
    ("columns do not split into variants", (3, 64, 4096, 4096, (1, 4096))),
    ("no rows", (1, 0, 4096, 4096, (1, 4096))),
])
def test_gemm_plan_refuses(case, args):
    with pytest.raises(ValueError):
        mm8_cuda.gemm_plan(*args)


def test_gemm_plan_narrow_variants():
    """A variant width that is a multiple of 128 but not of 256 takes the
    128-column prefill tile, so no tile straddles two variants."""
    plan = mm8_cuda.gemm_plan(3, 512, 256, 3 * 384, (1, 256), sms=24)
    assert (plan.bm, plan.bn) == (128, 128)
    assert mm8_cuda.gemm_plan(3, 512, 256, 3 * 512, (1, 256), sms=24).bn == 256


def test_k_major_codes_match_jax_core():
    """The plain version reads K-major codes as it reads N-major ones: the
    exact int32 GEMM of stacked K-major codes equals the JAX a8 core (the
    Pallas kernel in interpret mode) on the same layer, and the fused w8a8
    matmul is bit-equal between the two layouts."""
    rng = np.random.default_rng(3)
    L, B, K, M, li = 2, 5, 256, 256, 1
    x8 = rng.integers(-127, 128, (B, K)).astype(np.int8)
    q = rng.integers(-128, 128, (L, K, M)).astype(np.int8)
    w = tmm8.Mm8Weight(torch.from_numpy(q), *(torch.from_numpy(
        rng.random((L, n)).astype(np.float32) * 0.01) for n in (M, M, K, K)))
    wk = tmm8.to_k_major(w)
    acc = mm8_cuda.mm8_core_a8(torch.from_numpy(x8), wk.q, layer=li).numpy()
    want = np.asarray(mm8_pallas.mm8_core_pallas_a8(x8, q[li], interpret=True))
    np.testing.assert_array_equal(acc, want)
    x = torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32))
    y_n = tmm8.mm8_matmul(x, tmm8.LayerIndexed(w, li))
    y_k = tmm8.mm8_matmul(x, tmm8.LayerIndexed(wk, li))
    assert torch.equal(y_n, y_k)


def test_serving_model_frees_replaced_codes(monkeypatch):
    """Given a function that makes the tree, ServingModel holds the only
    reference to it: each code tensor it replaces by its K-major copy is
    freed before the next copy is made, so loading costs at most one code
    tensor more than the loaded model."""
    import weakref

    cfg = RWKV7Config(n_layer=2, n_embd=128, vocab_size=512)
    rt = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32,
                       quantization="int8")
    replaced = []
    real = tmm8.to_k_major

    def to_k_major(w):
        assert all(r() is None for r in replaced), "an N-major code tensor is still alive"
        out = real(w)
        replaced.append(weakref.ref(w.q))
        return out

    monkeypatch.setattr(tmm8, "to_k_major", to_k_major)
    m = ServingModel(cfg, lambda: synthetic_params_int8(cfg, seed=2, dtype=torch.float32,
                                                        device="cpu"), rt, 2, device="cpu")
    assert len(replaced) == 5 and all(r() is None for r in replaced)
    assert _k_major_layers(m.params["blocks"]["ffn"]["Wv"].q)


@pytest.mark.parametrize("B,wide", [(512, {"ffn Wk"}), (1000, {"att R/K/V", "att Wo", "ffn Wk",
                                                               "ffn Wv"}),
                                    (2048, {"att R/K/V", "att Wo", "ffn Wk", "ffn Wv"})])
def test_gemm_plan_prefill_width_fills_waves(B, wide):
    """At prefill row counts the tile is 256 columns wide unless 128 fills
    the waves of one CTA per SM on 132 SMs clearly better: at 512 rows the
    wide tile would leave R/K/V's second wave 45% full and give Wo and FFN Wv
    64 CTAs, so those take 128 columns."""
    for site, n, K, M in SITES[:4]:
        plan = mm8_cuda.gemm_plan(n, B, K, M, (1, K), sms=132)
        assert plan.bn == (256 if site in wide else 128), (B, site)

"""The numerics of the fp32 flash-attention kernels, forward and backward,
which run 3xTF32 on the tensor cores: `tf32_split` (the operand split, round
to nearest with ties away from zero, as `cvt.rna.tf32.f32`), the plain 3xTF32
forward and backward built on it (which round where the kernels round)
against the fp32 plain versions and the JAX package's Pallas forward and
backward in interpret mode, the fp32 dK/dV split plan, and the kernel
source's contract. The CUDA kernels themselves are held against both plain
versions on the card (tests/test_torch_port_cuda.py, chip_smoke.py,
scripts/flash_fwd_f32.py, scripts/flash_bwd_f32.py)."""
import os
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difashion_tpu.nn.pallas.flash_attention import _forward as jax_forward
from difashion_tpu.nn.pallas.flash_attention import flash_attention as jax_flash
from difashion_tpu_torch.nn import kernels
from difashion_tpu_torch.nn.kernels.flash_attention import (
    F32_DKV_TILES,
    F32_SOURCE,
    SM_COUNT,
    SPLIT_MIN_Q_TILES,
    dkv_splits,
    flash_attention_3xtf32_ref,
    flash_attention_bwd_3xtf32_ref,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from difashion_tpu_torch.nn.kernels.tf32 import tf32_split

# the gradients' bound in chip_smoke.py (F32_TOL): relative L2
F32_TOL = 2e-5


def _f(bits):
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _bits(t):
    return [b & 0xFFFFFFFF for b in t.view(torch.int32).tolist()]


# (input bits, hi bits, lo bits or None for NaN): worked by hand
SPLIT_CASES = [
    (0x3F800000, 0x3F800000, 0x00000000),   # 1.0: exact in TF32, lo 0
    (0x3F801000, 0x3F802000, 0xBA000000),   # 1 + 2^-11, a tie: away from zero; lo -2^-11
    (0x3F800FFF, 0x3F800000, 0x3A000000),   # below the tie: down; lo (2^12 - 1) 2^-23 is
                                            # itself a tie and rounds to 2^-11
    (0x3F803000, 0x3F804000, 0xBA000000),   # a tie above an odd TF32 value: away as well
    (0xBF801000, 0xBF802000, 0x3A000000),   # the negative tie: away from zero too
    (0x40490FDB, 0x40490000, 0x3A7DC000),   # pi: hi 3.140625, lo its remainder in TF32
    (0x000116C2, 0x00012000, 0x80000000),   # a subnormal: TF32 keeps bits 13 and up, so
                                            # hi rounds up and lo (-0x93e units) to -0
    (0x00001000, 0x00002000, 0x80002000),   # the subnormal tie: away, and lo's tie as well
    (0x7F7FFFFF, 0x7F800000, 0xFF800000),   # the largest float rounds to inf (as rna does)
    (0x7F800000, 0x7F800000, None),         # inf passes through; lo inf - inf = NaN
    (0xFF800000, 0xFF800000, None),         # -inf
    (0x7FC00000, 0x7FC00000, None),         # NaN passes through
]


@pytest.mark.parametrize("x,hi,lo", SPLIT_CASES)
def test_tf32_split_hand_cases(x, hi, lo):
    h, l = tf32_split(torch.tensor([_f(x)], dtype=torch.float32))
    assert _bits(h) == [hi]
    if lo is None:
        assert torch.isnan(l).all()
    else:
        assert _bits(l) == [lo]


def test_tf32_split_against_float64_rounding():
    """On normal values (with normal remainders) of every magnitude and sign:
    hi is x rounded to 11 significant bits, ties away from zero (computed
    here in float64 from frexp), lo is x - hi rounded the same way, both
    have the 13 low bits clear, and hi + lo is x to 2^-22 of |x|."""
    rng = np.random.RandomState(0)
    x = (rng.randn(20000) * np.exp2(rng.randint(-100, 100, 20000))).astype(np.float32)
    # ties and near-ties (13 low bits of exactly 0x1000, 0x0fff and 0x1001) of
    # values whose remainders are normal too
    base = rng.randint(0x0C000000, 0x7F000000, 3000).astype(np.uint32) & ~np.uint32(0x1FFF)
    ties = np.concatenate([base | 0x1000, base | 0x0FFF, base | 0x1001]).view(np.float32)
    x = np.concatenate([x, ties, -ties])

    def rna11(v):
        m, e = np.frexp(v.astype(np.float64))
        r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
        return np.ldexp(r, e - 11).astype(np.float32)

    hi, lo = (t.numpy() for t in tf32_split(torch.from_numpy(x)))
    np.testing.assert_array_equal(hi, rna11(x))
    nz = (x - hi) != 0
    np.testing.assert_array_equal(lo[nz], rna11((x - hi)[nz]))
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    err = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert (err <= np.abs(x.astype(np.float64)) * 2.0 ** -22).all()


def test_tf32_split_takes_fp32_only():
    with pytest.raises(TypeError):
        tf32_split(torch.ones(3, dtype=torch.float64))


# the shapes of tests/test_torch_port_flash_bwd.py
SHAPES = [
    (1, 2, 256, 256, 64),
    (1, 2, 256, 77, 64),
    (1, 1, 100, 50, 32),
    (1, 2, 64, 64, 64),
    (1, 2, 77, 77, 64),
    (2, 3, 130, 77, 16),
    (1, 2, 200, 77, 40),
    (2, 1, 130, 150, 80),
]


def _inputs(b, h, sq, skv, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32)
            for s in ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d), (b, h, sq, d))]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _pallas_lse(q, k, v):
    """The natural-log LSE [B*H, Sq] of the Pallas forward (`_forward`, the
    function `flash_attention` reaches) in interpret mode, on inputs padded
    to its 128-row blocks as `flash_attention` pads them."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    pad = lambda x, s: np.pad(x.reshape(b * h, s, d), [(0, 0), (0, -s % 128), (0, 0)])
    _, lse = jax_forward(jnp.asarray(pad(q, sq)), jnp.asarray(pad(k, skv)),
                         jnp.asarray(pad(v, skv)), 1.0 / np.sqrt(d), 128, 128, True, skv)
    return np.asarray(lse)[:, 0, :sq]


@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES)
def test_3xtf32_plain_forward_matches_fp32_and_pallas(b, h, sq, skv, d):
    """The forward as the fp32 kernels round it (S and P V each from TF32
    hi / lo operands, three products summed) is within F32_TOL of the fp32
    plain forward and of the Pallas forward in interpret mode, O and the LSE
    alike, per element and in relative L2."""
    q, k, v, _ = _inputs(b, h, sq, skv, d)
    want = (np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), block_q=128, block_kv=128,
                                 interpret=True)), _pallas_lse(q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_attention_3xtf32_ref(tq, tk, tv)
    fp32 = flash_attention_ref(tq, tk, tv)
    for name, g, f, w in zip(("o", "lse"), got, fp32, want):
        assert g.dtype == torch.float32 and g.shape == f.shape, name
        torch.testing.assert_close(g, f, rtol=F32_TOL, atol=F32_TOL)
        torch.testing.assert_close(g, torch.from_numpy(np.array(w)), rtol=F32_TOL, atol=F32_TOL)
        assert _rel(g, f) <= F32_TOL and _rel(g, w) <= F32_TOL, name
        # and not the fp32 forward itself: the splits are taken
        assert not torch.equal(g, f), name


def test_3xtf32_plain_forward_takes_fp32_only():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _inputs(1, 1, 8, 8, 16)[:3])
    with pytest.raises(TypeError):
        flash_attention_3xtf32_ref(q, k, v)


@pytest.mark.parametrize("b,h,sq,skv,d", SHAPES)
def test_3xtf32_plain_backward_matches_fp32_and_pallas(b, h, sq, skv, d):
    """The backward as the fp32 kernels round it (every product's operands
    split into TF32 hi and lo, three products summed) is within F32_TOL of
    the fp32 plain backward and of `jax.vjp` of the Pallas kernel."""
    q, k, v, do = _inputs(b, h, sq, skv, d)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, block_q=128, block_kv=128,
                                               interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv)
    got = flash_attention_bwd_3xtf32_ref(tq, tk, tv, o, lse, tdo)
    fp32 = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo)
    for name, g, f, w in zip(("dq", "dk", "dv"), got, fp32, want):
        assert g.dtype == torch.float32 and g.shape == f.shape
        assert _rel(g, f) <= F32_TOL, name
        assert _rel(g, np.asarray(w)) <= F32_TOL, name
        # and not the fp32 backward itself: the splits are taken
        assert not torch.equal(g, f), name


def test_3xtf32_plain_backward_takes_fp32_only():
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in _inputs(1, 1, 8, 8, 16))
    o, lse = flash_attention_ref(q, k, v)
    with pytest.raises(TypeError):
        flash_attention_bwd_3xtf32_ref(q, k, v, o, lse, do)


# (B, H, Sq, Skv, d) of the training UNet's attentions at the recipe's 8 rows
# (sd2_base) and sd15's, as in tests/test_torch_port_flash_bwd.py
TRAIN_SITES = {
    "self_4096": (8, 5, 4096, 4096, 64), "cross_4096x77": (8, 5, 4096, 77, 64),
    "self_1024": (8, 10, 1024, 1024, 64), "cross_1024x77": (8, 10, 1024, 77, 64),
    "self_256": (8, 20, 256, 256, 64), "cross_256x77": (8, 20, 256, 77, 64),
    "mid_self_64": (8, 20, 64, 64, 64), "mid_cross_64x77": (8, 20, 64, 77, 64),
    "sd15_self_4096": (8, 8, 4096, 4096, 40), "sd15_cross_4096x77": (8, 8, 4096, 77, 40),
    "sd15_self_1024": (8, 8, 1024, 1024, 80), "sd15_cross_1024x77": (8, 8, 1024, 77, 80),
}


@pytest.mark.parametrize("site", sorted(TRAIN_SITES))
def test_f32_dkv_split_plan_at_the_training_sites(site):
    """In fp32 the 77-token cross-attention at 4096 tokens (one KV tile of
    128 rows a head: 40 blocks at batch 8 and 5 heads, 64 at sd15's 8 heads,
    one block an SM on 132 SMs) is split; every other training site is
    not."""
    b, h, sq, skv, d = TRAIN_SITES[site]
    splits = dkv_splits(b, h, sq, skv, d, torch.float32)
    assert splits == {"cross_4096x77": 3, "sd15_cross_4096x77": 2}.get(site, 1)


def test_f32_dkv_split_plan_never_makes_an_empty_part():
    """The fp32 kernels cut their Q tiles into parts of ceil(q_tiles /
    splits): every part but the last has SPLIT_MIN_Q_TILES Q tiles or more,
    the last at least one, and a split plan fills at most one wave of fp32
    blocks."""
    for b in (1, 2, 8):
        for h in (1, 5, 8, 20):
            for sq in (1, 63, 64, 77, 100, 300, 1000, 4096, 8192):
                for skv in (1, 77, 100, 300, 4096):
                    for d in (4, 16, 32, 64, 80, 128):
                        splits = dkv_splits(b, h, sq, skv, d, torch.float32)
                        kv_rows, bq, per_sm = F32_DKV_TILES[
                            32 if d <= 32 else 64 if d <= 64 else 128]
                        q_tiles = -(-sq // bq)
                        per = -(-q_tiles // splits)
                        assert splits >= 1 and (splits - 1) * per < q_tiles
                        if splits > 1:
                            assert per >= SPLIT_MIN_Q_TILES
                            assert -(-skv // kv_rows) * b * h * splits <= SM_COUNT * per_sm


def test_f32_source_runs_3xtf32_on_the_tensor_cores():
    """The fp32 source's forward, dQ and dK/dV run tf32 products on the
    tensor cores with both operands split, the small terms first (lo*hi,
    hi*lo, hi*hi): mma.sync at any head dim, wgmma (tf32, K-major) at 64,
    picked on the C side for the forward as for the backward; they sum
    without atomics (but for the phase-timing build), the SIMT forward is
    gone, the split entry the wrapper calls is there, and the tiles and
    shared-memory budgets F32_DKV_TILES assumes."""
    src = open(os.path.join(kernels.CSRC_DIR, f"{F32_SOURCE}.cu")).read()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    body = src[src.index("mma_3xtf32(float"):]
    body = body[:body.index("}\n")]
    assert body.index("a.lo, bh0, bh1") < body.index("a.hi, bl0, bl1") < body.index(
        "a.hi, bh0, bh1")
    for product in re.findall(r"(?:\n\s+hopper::wgmma_tf32_\w+\([^;]*;){3}", src):
        arg = r"(tf_desc<\w+>\([^()]*\)|[\w.\[\]]+)"
        calls = re.findall(rf"wgmma_tf32_\w+\((\w+), {arg}, {arg},", product)
        assert len(calls) == 3 and len({c[0] for c in calls}) == 1
        (_, a1, b1), (_, a2, b2), (_, a3, b3) = calls   # lo hi, hi lo, hi hi
        assert a2 == a3 and b1 == b3 and a1 != a2 and b1 != b2
    # the forward's S and P V (6), dQ's S, dP and dS K (9), dK/dV's S^T,
    # dP^T, P^T dO and dS^T Q (12)
    assert src.count("hopper::wgmma_tf32_") == 27
    # outside the phase-timing build (-DF32_PHASE_TIMES, a measurement only)
    timed = re.compile(r"#ifdef F32_PHASE_TIMES.*?#endif", re.S)
    kept = timed.sub("", src).lower().replace("no\n// atomics", "").replace("no atomics", "")
    assert "atomic" not in kept
    for name in ("flash_attention_fwd_f32", "flash_attention_dq_f32", "flash_attention_dkv_f32",
                 "flash_attention_dkv_split_f32"):
        assert f'extern "C" int {name}(' in src
    assert "fwd_f32_kernel" not in src and "fmaf(a[i], b[j], acc[i][j])" not in src
    assert "fwd_wg_kernel<<<grid" in src and "fwd_tc_kernel<DP, W><<<grid" in src
    fwd = src[src.index("int fwd(const void* q"):]
    fwd = fwd[:fwd.index("\n}\n")]
    assert "const bool wg = DP == 64 && vec;" in fwd and "(Sq + 127) / 128" in fwd
    for kernel in ("fwd_wg_kernel(", "fwd_tc_kernel("):
        body = src[src.index(f"\n{kernel}"):]
        body = body[:body.index("\n}\n")]
        # the products' sums in fresh accumulators, added to O once a tile
        assert "part" in body or "accumulate<DP>(acc, s" in body, kernel
        assert "online_softmax(s, m, l, alpha" in body, kernel
    assert re.search(r"constexpr int smem = 6 \* kRows \* DP \* 4 \+ 2 \* 2 \* kRows \* 4;", src)
    assert "const bool wg = DP == 64 && vec;" in src and "constexpr int kQT = 32;" in src
    assert "dkv_wg_kernel<<<grid" in src and "(Skv + 127) / 128" in src
    for dp, (kv_rows, bq, per_sm) in F32_DKV_TILES.items():
        if dp == 64:
            assert (kv_rows, bq, per_sm) == (128, 32, 1)
        else:
            smem = 6 * 64 * dp * 4 + 2 * 2 * 64 * 4
            assert (kv_rows, bq) == (64, 64) and per_sm == min(4, (228 * 1024) // (smem + 1024))


def test_skinny_f32_source_runs_3xtf32_on_the_tensor_cores():
    """The fp32 skinny-N source runs tf32 products on the tensor cores
    (wgmma m64nNk8, K-major) with both operands split into hi and lo (x's
    and w's chunks, dx's [K, N] weight transposed on the way), the small
    terms first (lo*hi, hi*lo, hi*hi) into a chunk's fresh accumulators that
    are added to the running sums once a chunk, with the flash kernels'
    rounding to TF32; no atomics, and the entry the wrapper calls."""
    src = open(os.path.join(kernels.CSRC_DIR, "skinny_matmul_f32.cu")).read()
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in src
    # the three products of each 8-deep step: lo(x) hi(w), hi(x) lo(w), hi(x) hi(w)
    calls = re.findall(r"mma_tf32\(part, tile_desc\((\w+), kk\), tile_desc\((\w+), kk\), "
                       r"([^)]*)\);", src)
    assert calls == [("xl", "wh", "kk != 0"), ("xh", "wl", "1"), ("xh", "wh", "1")]
    assert "acc[i] += part[i]" in src
    # both operands split: x's rows, w's rows ([N, K]) or columns ([K, N])
    assert src.count("put_row4(st, st + kXTile") == 1
    assert "put_row4(wst, wst + kWTile" in src and "put_col4(wst, wst + kWTile" in src
    f32_src = open(os.path.join(kernels.CSRC_DIR, f"{F32_SOURCE}.cu")).read()
    rounding = "return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
    assert rounding in src and rounding in f32_src
    assert "lo = to_tf32(x - __uint_as_float(hi));" in src
    assert "atomic" not in src.lower()
    assert 'extern "C" int skinny_matmul_f32(' in src
    assert "skinny_matmul_f32_kernel<KN><<<grid" in src

"""The fused AMP stage (K1): plain version, per-tile valid math and the
kernels' algorithm (the CUDA-core route's f32 numerics and the tensor-core
route's bf16 operands, at each route's tile) against
audiolcm_tpu.nn.pallas_amp_stage, the tensor-core kernel's packed weights
multiplied as its conv walks them, its tile and grid, and the CUDA kernels
against the plain version on the card (`gpu` marker).

The JAX kernel runs in interpret mode. Stage: kernels (3, 7, 11), dilations
(1, 3, 5), C=6, random snake parameters, weights and biases from a numpy
seed. f32 tolerance atol 2e-5 (the ROADMAP bar, as in
test_pallas_amp_stage.py:225) unless a test states another.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiolcm_torch import obs
from audiolcm_torch.nn import amp_stage as A
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

try:
    import jax
    import jax.numpy as jnp

    from audiolcm_tpu.models.bigvgan import AMPBlock1
    from audiolcm_tpu.nn import pallas_amp_stage as P
except ImportError:  # the machine with the card has no JAX: only the gpu test runs there
    jax = jnp = AMPBlock1 = P = None

KS, DS = (3, 7, 11), (1, 3, 5)


def make_params(seed: int, c: int, ks=KS, ds=DS, w_scale=1.0):
    """Reference-layout AMPBlock1 param trees (JAX names, numpy leaves)."""
    rng = np.random.default_rng(seed)
    trees = []
    for k in ks:
        p = {}
        for m in range(len(ds)):
            for a in ("act1", "act2"):
                p[f"{a}_{m}"] = {n: (rng.standard_normal(c) * 0.3).astype(np.float32)
                                 for n in ("alpha", "beta")}
            for cv in ("conv1", "conv2"):
                p[f"{cv}_{m}"] = {
                    "kernel": (rng.standard_normal((k, c, c)) * w_scale / np.sqrt(c * k)).astype(np.float32),
                    "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}
        trees.append(p)
    return trees


def jax_stage_params(trees, ds=DS):
    return P.extract_stage_params(trees, len(ds))


def torch_stage_params(trees, ds=DS, dtype=torch.float32):
    """The port's stage_params: linear-scale snakes, (C_out, C_in, k) weights."""
    t = lambda v: torch.from_numpy(np.array(v, np.float32))
    out = []
    for p in trees:
        subs = []
        for m in range(len(ds)):
            s = {"a1": t(p[f"act1_{m}"]["alpha"]).exp(), "b1": t(p[f"act1_{m}"]["beta"]).exp(),
                 "a2": t(p[f"act2_{m}"]["alpha"]).exp(), "b2": t(p[f"act2_{m}"]["beta"]).exp(),
                 "w1": t(p[f"conv1_{m}"]["kernel"]).permute(2, 1, 0).contiguous(),
                 "c1b": t(p[f"conv1_{m}"]["bias"]),
                 "w2": t(p[f"conv2_{m}"]["kernel"]).permute(2, 1, 0).contiguous(),
                 "c2b": t(p[f"conv2_{m}"]["bias"])}
            subs.append({k: v.to(dtype) for k, v in s.items()})
        out.append({"sub": subs})
    return out


def jax_unfused(x, trees, ks=KS, ds=DS):
    acc = None
    for k, p in zip(ks, trees):
        h = AMPBlock1(k, ds).apply({"params": p}, x)
        acc = h if acc is None else acc + h
    return acc / len(ks)


def jax_golden(fn, x):
    """Run a JAX reference under jit (faster than op-by-op on the CPU)."""
    return np.asarray(jax.jit(fn)(jnp.asarray(x)))


def _x(seed, b, t, c):
    return np.random.default_rng(seed).standard_normal((b, t, c)).astype(np.float32)


def test_stage_valid_cl_matches_jax():
    c, l = 6, 512
    trees = make_params(0, c)
    x = _x(1, 1, l, c)[0].T.copy()  # (C, L)
    jsp = [{"sub": [dict(s, w1t=jnp.transpose(s["w1"], (0, 2, 1)),
                         w2t=jnp.transpose(s["w2"], (0, 2, 1))) for s in sp["sub"]]}
           for sp in jax_stage_params(trees)]
    golden = jax_golden(lambda v: P.stage_valid_cl(v, jsp, KS, DS), x)
    out = A.stage_valid_cl(torch.from_numpy(x), torch_stage_params(trees), KS, DS).numpy()
    assert out.shape == (c, l - 2 * A.stage_radius(KS, DS)) == golden.shape
    np.testing.assert_allclose(out, golden, atol=2e-5)


@pytest.fixture(scope="module")
def stage_2048():
    c, t = 6, 2048
    trees = make_params(2, c)
    x = _x(3, 2, t, c)
    golden = jax_golden(lambda v: jax_unfused(v, trees), x)
    fused = jax_golden(lambda v: P.fused_amp_stage_cl_batched(
        v, jax_stage_params(trees), KS, DS,
        reference_fn=lambda xb: jax_unfused(xb, trees), tile=512, interpret=True), x)
    return x, trees, golden, fused


def test_plain_stage_matches_jax_fused_and_unfused_everywhere(stage_2048):
    """Whole sequence, first and last samples included."""
    x, trees, golden, fused = stage_2048
    out = A.fused_amp_stage_plain(torch.from_numpy(x), torch_stage_params(trees), KS, DS).numpy()
    np.testing.assert_allclose(out, golden, atol=2e-5)
    np.testing.assert_allclose(out, fused, atol=2e-5)
    np.testing.assert_allclose(out[:, :128], golden[:, :128], atol=2e-5)
    np.testing.assert_allclose(out[:, -128:], golden[:, -128:], atol=2e-5)


@pytest.mark.parametrize("tile", [512, 352, 128])
def test_kernel_algorithm_matches_jax_fused(stage_2048, tile):
    """The CUDA kernel's per-tile algorithm (tile + halo, shrinking valid
    ranges, edge rules in global coordinates) equals the JAX fused stage,
    edges included, for tiles that do and do not divide T."""
    x, trees, golden, fused = stage_2048
    out = A.stage_tiles_emulated(torch.from_numpy(x), torch_stage_params(trees), KS, DS,
                                 tile=tile).numpy()
    np.testing.assert_allclose(out, fused, atol=2e-5)
    np.testing.assert_allclose(out, golden, atol=2e-5)


@pytest.mark.parametrize("t,tile", [(1000, 352), (50, 128), (200, 32)])
def test_kernel_algorithm_ragged_and_short(t, tile):
    """Ragged last tile, and sequences shorter than the stage radius (96)
    where one window holds both edges; JAX's fused path only takes
    T divisible by its tile, so the golden is the JAX unfused stage."""
    c = 6
    trees = make_params(4, c)
    x = _x(5, 2, t, c)
    golden = jax_golden(lambda v: jax_unfused(v, trees), x)
    sp = torch_stage_params(trees)
    out = A.stage_tiles_emulated(torch.from_numpy(x), sp, KS, DS, tile=tile).numpy()
    np.testing.assert_allclose(out, golden, atol=2e-5)
    plain = A.fused_amp_stage_plain(torch.from_numpy(x), sp, KS, DS).numpy()
    np.testing.assert_allclose(plain, golden, atol=2e-5)


def test_fast_cos_stage_close_to_exact(stage_2048):
    """fast=True (polynomial cos, max err ~5e-7 per call) through 18
    activations stays within 1e-4 of exact (the JAX package's bar)."""
    x, trees, _, _ = stage_2048
    sp = torch_stage_params(trees)
    exact = A.stage_tiles_emulated(torch.from_numpy(x), sp, KS, DS)
    fast = A.stage_tiles_emulated(torch.from_numpy(x), sp, KS, DS, fast=True)
    np.testing.assert_allclose(fast.numpy(), exact.numpy(), atol=1e-4)


def test_bf16_error_not_worse_than_unfused_bf16(stage_2048):
    """The bar of test_pallas_amp_stage.py:139-180: in bf16 the fused stage's
    mean error against the f32 golden is at most 1.02x the port's unfused
    bf16 path's. The emulation takes the route a bf16 CUDA tensor takes,
    the tensor-core kernel's (bf16 conv operands, f32 sums and residual, one
    rounding at the output); the CPU wrapper runs the plain version, which
    is the unfused path itself."""
    x, trees, golden, _ = stage_2048
    golden = golden.astype(np.float64)
    scale = np.abs(golden).mean()
    xb = torch.from_numpy(x).bfloat16()
    spb = torch_stage_params(trees, dtype=torch.bfloat16)
    err = lambda y: np.abs(y.float().numpy().astype(np.float64) - golden).mean() / scale
    unfused_err = err(A.fused_amp_stage_plain(xb, spb, KS, DS))
    kernel = A.stage_tiles_emulated(xb, spb, KS, DS)
    assert kernel.dtype == torch.bfloat16
    assert err(kernel) <= unfused_err * 1.02, (err(kernel), unfused_err)
    packed = A.pack_stage(spb, KS, DS, torch.bfloat16, "cpu")
    assert err(A.fused_amp_stage(xb, packed, KS, DS)) <= unfused_err * 1.02


@pytest.mark.parametrize("form", ["tc", "cl"])
def test_per_item_forms_match_jax(stage_2048, form):
    """K2a (fused_amp_stage_tc) and K2b (fused_amp_stage_cl) against the JAX
    fused_amp_stage / fused_amp_stage_cl in interpret mode, tile 512 over
    T = 2048 (4 tiles, so JAX takes its kernel, not _fallback); on the CPU
    the port's wrappers run the plain version and launch nothing."""
    x, trees, golden, _ = stage_2048
    jax_fn = P.fused_amp_stage if form == "tc" else P.fused_amp_stage_cl
    ref = jax_golden(lambda v: jax_fn(v, jax_stage_params(trees), KS, DS,
                                      reference_fn=lambda xb: jax_unfused(xb, trees), tile=512,
                                      interpret=True), x)
    port = A.fused_amp_stage_tc if form == "tc" else A.fused_amp_stage_cl
    before = obs.counters()
    packed = A.pack_stage(torch_stage_params(trees), KS, DS, torch.float32, "cpu")
    out = port(torch.from_numpy(x), packed, KS, DS).numpy()
    assert obs.counters() == before
    np.testing.assert_allclose(out, ref, atol=2e-5)
    np.testing.assert_allclose(out, golden, atol=2e-5)


def test_wrapper_dispatch_and_validation(stage_2048):
    x, trees, _, _ = stage_2048
    xt, sp = torch.from_numpy(x), torch_stage_params(trees)
    f32, cpu = torch.float32, torch.device("cpu")
    packed = A.pack_stage(sp, KS, DS, f32, cpu)
    before = obs.counters()
    out = A.fused_amp_stage(xt, packed, KS, DS, accum="f32", conv="kstack")
    assert torch.equal(out, A.fused_amp_stage_plain(xt, sp, KS, DS))
    assert obs.counters() == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="accum"):
        A.fused_amp_stage(xt, packed, KS, DS, accum="f16")
    with pytest.raises(ValueError, match="conv"):
        A.fused_amp_stage(xt, packed, KS, DS, conv="im2col")
    with pytest.raises(ValueError, match="does not fit"):
        A.fused_amp_stage(torch.zeros(1, 64, 96), packed, KS, DS)
    bad = [{"sub": [dict(s, w1=s["w1"][:, :, :-1]) for s in blk["sub"]]} for blk in sp]
    with pytest.raises(ValueError, match="w1 has shape"):
        A.pack_stage(bad, KS, DS, f32, cpu)
    with pytest.raises(ValueError, match="resblocks"):
        A.pack_stage(sp[:2], KS, DS, f32, cpu)
    with pytest.raises(ValueError, match="resblocks"):  # packed for another stage
        A.fused_amp_stage(xt, A.pack_stage(sp[:2], KS[:2], DS, f32, cpu), KS, DS)
    with pytest.raises(TypeError, match="packed"):  # the params themselves
        A.fused_amp_stage(xt, sp, KS, DS)
    with pytest.raises(ValueError, match="packed for"):  # another dtype's kernel
        A.fused_amp_stage(xt, A.pack_stage(sp, KS, DS, torch.bfloat16, cpu), KS, DS)
    with pytest.raises(ValueError, match="cuda or cpu"):
        A.fused_amp_stage(xt.to("meta"), packed, KS, DS)
    with pytest.raises(ValueError, match="conv 'tap' or 'mstack'"):
        A.fused_amp_stage_cl(xt, packed, KS, DS, conv="kstack")
    with pytest.raises(ValueError, match="accum"):
        A.fused_amp_stage_tc(xt, packed, KS, DS, accum="f16")


def test_pick_tile_fits_shared_memory():
    r = A.stage_radius(KS, DS)
    assert r == 96 == P.stage_radius(KS, DS)
    assert A.pick_tile(48, r) == 128 and A.pick_tile(24, r) == 352
    for c in (6, 24, 48, 64):
        assert A.smem_bytes(c, A.pick_tile(c, r), r) <= A.SMEM_BYTES


@pytest.fixture(scope="module")
def stage_c24():
    """C=24 (the narrowest serving stage's width) on a short T."""
    c, t = 24, 512
    trees = make_params(8, c)
    x = _x(9, 2, t, c)
    return x, trees, jax_golden(lambda v: jax_unfused(v, trees), x)


def _mean_err(y, golden):
    golden = golden.astype(np.float64)
    return np.abs(y.float().numpy().astype(np.float64) - golden).mean() / np.abs(golden).mean()


@pytest.mark.parametrize("case", ["stage_2048", "stage_c24"])
@pytest.mark.parametrize("tile", [None, 64])
def test_mma_route_bf16_error_not_worse_than_unfused_bf16(request, case, tile):
    """The tensor-core route's numerics (bf16 x: conv inputs and
    weights rounded to bf16, the first conv's output rounded to bf16, f32
    sums, residual and resblock mean) at its own tile (None: pick_tile_mma)
    and a small one: mean error against the JAX f32 golden at most 1.02x
    the port's unfused bf16 path's, at C=6 T=2048 and C=24 T=512."""
    x, trees, golden = request.getfixturevalue(case)[:3]
    xb = torch.from_numpy(x).bfloat16()
    spb = torch_stage_params(trees, dtype=torch.bfloat16)
    unfused = _mean_err(A.fused_amp_stage_plain(xb, spb, KS, DS), golden)
    out = A.stage_tiles_emulated(xb, spb, KS, DS, tile=tile)
    assert out.dtype == torch.bfloat16
    assert _mean_err(out, golden) <= unfused * 1.02, (_mean_err(out, golden), unfused)


@pytest.mark.parametrize("tile", [None, 80])
def test_mma_tiling_f32_operands_matches_jax_fused(stage_2048, tile):
    """The tensor-core route's tiling (its tile for this shape, 32 at C=6,
    B=2, T=2048, or 80: a multiple of 16, not of 32) with f32 operands
    equals the JAX fused stage (fused_amp_stage_cl_batched in interpret
    mode) to the f32 bar."""
    x, trees, golden, fused = stage_2048
    tile = tile or A.pick_tile_mma(6, KS, DS, *x.shape[:2])
    out = A.stage_tiles_emulated(torch.from_numpy(x), torch_stage_params(trees), KS, DS,
                                 tile=tile).numpy()
    np.testing.assert_allclose(out, fused, atol=2e-5)
    np.testing.assert_allclose(out, golden, atol=2e-5)


@pytest.mark.parametrize("t,tile", [(1000, 192), (50, 16), (200, 48)])
def test_mma_route_ragged_and_short(t, tile):
    """A ragged last tile and sequences shorter than the stage radius on the
    tensor-core route's tiling: f32 operands to the f32 bar against the JAX
    unfused stage, bf16 operands within 1.02x the unfused bf16 path's error."""
    c = 6
    trees = make_params(10, c)
    x = _x(11, 2, t, c)
    golden = jax_golden(lambda v: jax_unfused(v, trees), x)
    out = A.stage_tiles_emulated(torch.from_numpy(x), torch_stage_params(trees), KS, DS,
                                 tile=tile).numpy()
    np.testing.assert_allclose(out, golden, atol=2e-5)
    xb, spb = torch.from_numpy(x).bfloat16(), torch_stage_params(trees, dtype=torch.bfloat16)
    unfused = _mean_err(A.fused_amp_stage_plain(xb, spb, KS, DS), golden)
    assert _mean_err(A.stage_tiles_emulated(xb, spb, KS, DS, tile=tile), golden) <= unfused * 1.02


def test_pick_route_and_mma_tile_fit_shared_memory():
    r = A.stage_radius(KS, DS)
    assert A.pick_route(torch.zeros(1).bfloat16()) == "mma"
    assert A.pick_route(torch.zeros(1)) == "cuda_core"
    assert A.max_tile_mma(48, r, 11) == 168 and A.max_tile_mma(24, r, 11) == 616
    for c in range(1, A.MMA_MAX_C + 1):
        tile = A.max_tile_mma(c, r, 11)
        assert tile % 8 == 0 and A.smem_bytes_mma(c, tile, r, 11) <= A.SMEM_BYTES
        assert A.smem_bytes_mma(c, tile + 8, r, 11) > A.SMEM_BYTES or tile == A.MAX_TILE_MMA
        n = tile + 2 * r
        np_, hrows = A.mma_layout(c, n)
        assert np_ % 8 == 4 and np_ >= n and hrows % 8 == 1 and hrows >= n + 64
    assert A.mma_layout(48, 384) == (388, 449) and A.mma_layout(24, 704) == (708, 769)
    assert A.conv_groups(48, 11) == 66 and A.conv_groups(24, 11) == 34 and A.conv_groups(6, 3) == 4
    with pytest.raises(ValueError, match="C <= 64"):
        A.max_tile_mma(72, r, 11)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("t", [39936, 79872, 159744, 319488, 79795, 100, 5])
def test_tile_and_grid_cover_every_sample_once(b, t):
    """pick_tile_mma's tile and grid_mma's grid at C = 48 and 24: the tile a
    multiple of 8 that fits shared memory; the blocks cover every (batch,
    sample) exactly once, T ragged and shorter than a tile included; from
    the 5 s clip (T = 39 936 at C = 48) up, the grid's waves of one block
    per SM on the card's 132 SMs leave under 5 % of their slots idle (the
    parent's batch-1 grids of 1.2 to 6.3 waves left up to 40 %)."""
    r = A.stage_radius(KS, DS)
    for c in (48, 24):
        tile = A.pick_tile_mma(c, KS, DS, b, t)
        assert tile % 8 == 0 and tile <= A.max_tile_mma(c, r, 11)
        assert A.smem_bytes_mma(c, tile, r, 11) <= A.SMEM_BYTES
        assert A.route_tile("mma", c, KS, DS, b, t) == tile
        nx, ny = A.grid_mma(b, t, tile)
        seen = np.zeros((b, t), np.int64)
        for j in range(ny):
            for i in range(nx):
                seen[j, i * tile:min((i + 1) * tile, t)] += 1
        assert (seen == 1).all() and (nx - 1) * tile < t
        slots = -(-nx * ny // A.NUM_SMS) * A.NUM_SMS  # waves of one block per SM
        if t >= 39936:
            assert slots - nx * ny < 0.05 * slots, (c, tile)
    assert A.pick_tile_mma(24, KS, DS, 1, 5) > 5  # a sequence shorter than its tile


def test_cpu_path_launches_no_mma_kernel(stage_2048):
    """bf16 CPU tensors take the plain version on every wrapper: no launch,
    of either kernel, is counted."""
    x, trees, _, _ = stage_2048
    xb, spb = torch.from_numpy(x).bfloat16(), torch_stage_params(trees, dtype=torch.bfloat16)
    packed = A.pack_stage(spb, KS, DS, torch.bfloat16, "cpu")
    before = obs.counters()
    for fn in (A.fused_amp_stage, A.fused_amp_stage_tc, A.fused_amp_stage_cl):
        assert torch.equal(fn(xb, packed, KS, DS), A.fused_amp_stage_plain(xb, spb, KS, DS))
    assert obs.counters() == before


def wgmma_conv_from_packed(h: torch.Tensor, packed: torch.Tensor, c: int, k: int, d: int,
                           lo: int, hi: int) -> torch.Tensor:
    """csrc/amp_stage.cu's conv_mma in torch: h (planes, rows, 8) is H, one
    plane of 16-byte rows per 8-channel group; packed one conv's (groups,
    8 NT, 8) B. Each 64-sample tile from lo walks the k16 steps as the
    kernel's descriptors do: step s's first K column is group q = 2 s =
    u k + j, rows p0 - half + j d .. + 63 of plane u; its second the next
    group (d rows on in the same plane, or the next plane's tap 0), or, for
    the padded group past k ng, the rows one below the first (against zero
    weights); B is groups 2 s and 2 s + 1. The 64 x 16 A times the 16 x N B,
    as wgmma m64nNk16 does. Returns (hi - lo, C) f32, without bias."""
    ng = -(-c // 8)
    nq, half = k * ng, (k - 1) // 2 * d
    groups, npad, _ = packed.shape
    planes, rows, _ = h.shape
    flat = h.reshape(planes * rows, 8)
    start = lambda q, row0: q // k * rows + row0 + q % k * d  # noqa: E731
    nmt = -(-(hi - lo) // 64)
    out = torch.zeros(nmt * 64, npad)
    for mt in range(nmt):
        row0 = lo + 64 * mt - half
        for s in range(groups // 2):
            first = start(2 * s, row0)
            second = start(2 * s + 1, row0) if 2 * s + 1 < nq else first + 1
            assert first // rows == (first + 63) // rows  # a column stays in its plane
            amat = torch.cat([flat[first:first + 64], flat[second:second + 64]], 1)
            bmat = packed[2 * s:2 * s + 2].float().transpose(1, 2).reshape(16, npad)
            out[64 * mt:64 * mt + 64] += amat @ bmat
    return out[:hi - lo, :c]


@pytest.mark.parametrize("c", [6, 24, 48])
@pytest.mark.parametrize("k,d", [(3, 1), (7, 3), (11, 5)])
def test_pack_conv_wgmma_layout(c, k, d):
    """pack_conv_wgmma's layout, multiplied as the kernel's conv_mma walks
    it with H (wgmma_conv_from_packed), gives the conv of the bf16-rounded
    input and weights: the K flattening over (channel group, tap), the
    padded group, pad channels (C = 6) and a ragged last M tile (101
    outputs: one 64-row tile and 37 rows of the next). H's rows past the
    conv's input, but the first (which the padded group reads against zero
    weights, and which the kernel keeps finite), hold NaN, as stale shared
    memory might: only the discarded rows of the ragged tile may read
    them."""
    rng = np.random.default_rng(12)
    w = torch.from_numpy(rng.standard_normal((c, c, k)).astype(np.float32))
    half = (k - 1) // 2 * d
    lo, hi = half, half + 101
    ng = -(-c // 8)
    rows = torch.from_numpy(rng.standard_normal((hi + half, c)).astype(np.float32))
    rows = rows.bfloat16().float()
    h = torch.zeros(ng, A.mma_layout(c, hi + half)[1], 8)
    h[:, :hi + half] = F.pad(rows, (0, 8 * ng - c)).reshape(-1, ng, 8).transpose(0, 1)
    h[:, hi + half + 1:] = float("nan")
    packed = A.pack_conv_wgmma(w)
    assert packed.shape == (A.conv_groups(c, k), 8 * ng, 8) and packed.dtype == torch.bfloat16
    assert A.conv_groups(c, k) % 2 == 0 and A.conv_groups(c, k) - k * ng in (0, 1)
    for q in range(k * ng):  # group q = u k + j: input channels 8u.. of tap j
        u, j = divmod(q, k)
        want_q = F.pad(w[:, 8 * u:8 * u + 8, j], (0, 8 - w[:, 8 * u:8 * u + 8, j].shape[1]))
        assert torch.equal(packed[q, :c].float(), want_q.bfloat16().float())
    got = wgmma_conv_from_packed(h, packed, c, k, d, lo, hi)
    want = F.conv1d(rows.T[None], w.bfloat16().float(), dilation=d)[0].T
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    assert torch.equal(A.pack_conv_wgmma(torch.stack([w, 2 * w]))[1], A.pack_conv_wgmma(2 * w))
    sp = [{"sub": [{"w1": w, "w2": 2 * w, **{n: torch.ones(c) for n in
                                              ("a1", "b1", "c1b", "a2", "b2", "c2b")}}]}]
    flat, _ = A.pack_stage_params_mma(sp, "cpu")
    assert torch.equal(flat, torch.cat([packed.reshape(-1), A.pack_conv_wgmma(2 * w).reshape(-1)]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest -m gpu tests/test_torch_amp_stage.py)")
    return torch.device("cuda:0")


def launches() -> tuple:
    """The recorder's AMP-stage launch totals: (f32 route, tensor-core route)."""
    c = obs.counters()
    return c.get("amp_stage.f32", 0), c.get("amp_stage.mma", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("c,b,t", [
    (6, 2, 1000), (24, 2, 159744), (48, 2, 79872), (64, 2, 4000),
    (48, 1, 39936), (48, 1, 79872), (48, 1, 159744),  # batch 1 at the 5 / 10 / 20 s clips
    (24, 1, 79872), (24, 1, 159744), (24, 1, 319488),
    (48, 8, 79872), (24, 8, 159744),  # batch 8 of 10 s clips, the flagship cell's tiles
    (48, 2, 79795), (48, 8, 79795),  # a T that is no multiple of the tile
    (24, 1, 5)])  # a T shorter than one tile
def test_kernel_matches_plain_on_card(cuda_device, c, b, t):
    """The sm_90a kernels against the plain version on the card: f32 on the
    CUDA-core kernel (TF32 off; atol 1e-4: f32 sums in another order over
    18 convs; one launch, counted in the recorder's `amp_stage.f32`), and
    bf16 on the tensor-core kernel (one launch, counted in `amp_stage.mma`)
    against the f32 plain result, no worse than the plain bf16 path x1.02
    over the whole output, the first and last 256 samples and the last tile
    (ragged at T = 79 795); K2a/K2b (one launch per batch element) in f32
    too. Each shape launches at pick_tile_mma's tile for it on this card
    (batch 8 of 10 s clips at the tiles the serving vocoder takes), so the
    kernel's shared-memory layout fits where smem_bytes_mma says, and each
    kernel reads weights packed once (`pack_stage`) as the vocoder hands
    them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = make_params(6, c)
    x = torch.from_numpy(_x(7, b, t, c)).to(cuda_device)
    tile = A.pick_tile_mma(c, KS, DS, b, t, A._sms(cuda_device.index or 0))
    if t == 79795:
        assert t % tile
    if t == 5:
        assert t < tile
    for fast in (False, True):
        sp = [{"sub": [{k: v.to(cuda_device) for k, v in s.items()} for s in blk["sub"]]}
              for blk in torch_stage_params(trees)]
        plain = A.fused_amp_stage_plain(x, sp, KS, DS, fast)
        packed = A.pack_stage(sp, KS, DS, torch.float32, cuda_device)
        before = launches()
        out = A.fused_amp_stage(x, packed, KS, DS, fast=fast)
        torch.cuda.synchronize()
        assert launches() == (before[0] + 1, before[1])
        assert (out - plain).abs().max().item() < 1e-4
        for per_item in (A.fused_amp_stage_tc, A.fused_amp_stage_cl):
            before = launches()
            assert (per_item(x, packed, KS, DS, fast=fast) - plain).abs().max().item() < 1e-4
            assert launches() == (before[0] + x.shape[0], before[1])
        spb = [{"sub": [{k: v.bfloat16() for k, v in s.items()} for s in blk["sub"]]} for blk in sp]
        packed = A.pack_stage(spb, KS, DS, torch.bfloat16, cuda_device)
        before = launches()
        kb = A.fused_amp_stage(x.bfloat16(), packed, KS, DS, fast=fast).float()
        torch.cuda.synchronize()
        assert launches() == (before[0], before[1] + 1)
        pb = A.fused_amp_stage_plain(x.bfloat16(), spb, KS, DS, fast).float()
        for lo, hi in ((0, t), (0, min(256, t)), (max(t - 256, 0), t), ((t - 1) // tile * tile, t)):
            err = lambda y: (y[:, lo:hi] - plain[:, lo:hi]).abs().mean().item()
            assert err(kb) <= err(pb) * 1.02, (lo, hi, err(kb), err(pb))


@pytest.mark.gpu
def test_captured_fused_stage_runs_only_its_kernel(cuda_device):
    """A fused stage of the serving vocoder captured in a CUDA graph, its
    parameters packed before the capture (`BigVGAN.pack_stage_weights`, as
    the pipeline does when it is built): a replay launches K1's kernel and
    no other (no packing), and gives the eager output."""
    from torch.profiler import ProfilerActivity, profile

    from audiolcm_torch.models.bigvgan import BigVGAN, BigVGANConfig

    torch.manual_seed(0)
    voc = BigVGAN(BigVGANConfig(fast_snake=True), pallas_stage_max_channels=48)
    voc = voc.to(device=cuda_device, dtype=torch.bfloat16).eval().requires_grad_(False)
    voc.pack_stage_weights()
    i = 5  # C = 24, the last fused stage
    assert voc.stage_route(i, torch.bfloat16, cuda_device, 16) == "fused"
    # the upsampler's output as the vocoder hands it over: (B, C, T) data, a (B, T, C) view
    x = torch.randn(1, 24, 4096, device=cuda_device).bfloat16().transpose(1, 2)
    with torch.inference_mode():
        run = lambda: A.fused_amp_stage(x, voc.fused_params(i, x.dtype, x.device), KS, DS,  # noqa: E731
                                        fast=True)
        eager = run()
        side = torch.cuda.Stream(cuda_device)
        side.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(cuda_device).wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "amp_stage_mma_kernel" in kernels[0], kernels
    assert torch.equal(y, eager)

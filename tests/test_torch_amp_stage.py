"""The fused AMP stage (K1): plain version, per-tile valid math and the
kernels' algorithm (the CUDA-core route's f32 numerics and the tensor-core
route's bf16 operands, at each route's tile) against
audiolcm_tpu.nn.pallas_amp_stage, the tensor-core kernel's weight
fragments multiplied as its conv walks them, and the CUDA kernels against
the plain version on the card (`gpu` marker).

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
    assert err(A.fused_amp_stage(xb, spb, KS, DS)) <= unfused_err * 1.02


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
    out = port(torch.from_numpy(x), torch_stage_params(trees), KS, DS).numpy()
    assert obs.counters() == before
    np.testing.assert_allclose(out, ref, atol=2e-5)
    np.testing.assert_allclose(out, golden, atol=2e-5)


def test_wrapper_dispatch_and_validation(stage_2048):
    x, trees, _, _ = stage_2048
    xt, sp = torch.from_numpy(x), torch_stage_params(trees)
    before = obs.counters()
    out = A.fused_amp_stage(xt, sp, KS, DS, accum="f32", conv="kstack")
    assert torch.equal(out, A.fused_amp_stage_plain(xt, sp, KS, DS))
    assert obs.counters() == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="accum"):
        A.fused_amp_stage(xt, sp, KS, DS, accum="f16")
    with pytest.raises(ValueError, match="conv"):
        A.fused_amp_stage(xt, sp, KS, DS, conv="im2col")
    with pytest.raises(ValueError, match="does not fit"):
        A.fused_amp_stage(torch.zeros(1, 64, 96), sp, KS, DS)
    bad = [{"sub": [dict(s, w1=s["w1"][:, :, :-1]) for s in blk["sub"]]} for blk in sp]
    with pytest.raises(ValueError, match="w1 has shape"):
        A.fused_amp_stage(xt, bad, KS, DS)
    with pytest.raises(ValueError, match="resblocks"):
        A.fused_amp_stage(xt, sp[:2], KS, DS)
    with pytest.raises(ValueError, match="cuda or cpu"):
        A.fused_amp_stage(xt.to("meta"), sp, KS, DS)
    with pytest.raises(ValueError, match="conv 'tap' or 'mstack'"):
        A.fused_amp_stage_cl(xt, sp, KS, DS, conv="kstack")
    with pytest.raises(ValueError, match="accum"):
        A.fused_amp_stage_tc(xt, sp, KS, DS, accum="f16")


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
    """The tensor-core route's tiling (its tile, 512 at C=6, or 80: a
    multiple of 16, not of 32) with f32 operands equals the JAX fused stage
    (fused_amp_stage_cl_batched in interpret mode) to the f32 bar."""
    x, trees, golden, fused = stage_2048
    tile = tile or A.pick_tile_mma(6, A.stage_radius(KS, DS))
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
    assert A.pick_tile_mma(48, r) == 192 and A.pick_tile_mma(24, r) == 512
    for c in (6, 24, 48, 64):
        tile = A.pick_tile_mma(c, r)
        assert tile % 16 == 0 and A.smem_bytes_mma(c, tile, r) <= A.SMEM_BYTES
        np_, hp = A.mma_pitches(c, tile + 2 * r)
        assert np_ % 8 == 4 and hp % 8 == 0 and (hp // 8) % 2 == 1 and hp >= c
    assert A.mma_pitches(48, 384) == (388, 56) and A.mma_pitches(24, 704) == (708, 24)
    with pytest.raises(ValueError, match="C <= 64"):
        A.pick_tile_mma(72, r)


def test_cpu_path_launches_no_mma_kernel(stage_2048):
    """bf16 CPU tensors take the plain version on every wrapper: no launch,
    of either kernel, is counted."""
    x, trees, _, _ = stage_2048
    xb, spb = torch.from_numpy(x).bfloat16(), torch_stage_params(trees, dtype=torch.bfloat16)
    before = obs.counters()
    for fn in (A.fused_amp_stage, A.fused_amp_stage_tc, A.fused_amp_stage_cl):
        assert torch.equal(fn(xb, spb, KS, DS), A.fused_amp_stage_plain(xb, spb, KS, DS))
    assert obs.counters() == before


def mma_conv_from_fragments(h: torch.Tensor, frags: torch.Tensor, c: int, k: int, d: int,
                            lo: int, hi: int) -> torch.Tensor:
    """csrc/amp_stage.cu's conv_mma in torch, lane by lane: h (rows, HP)
    channels-last; frags one conv's (steps, NT, 32, 2) B fragments. Each
    warp tile of 16 positions walks the k16 steps; lane l's ldmatrix row is
    position l % 16 of the tile in group 2s + l // 16, whose (tap j, channel
    group cg) advance by two groups per step; the A and B fragments are
    multiplied as m16n8k16 does. Returns (hi - lo, C) f32, without bias."""
    ng = -(-c // 8)
    nq, half = k * ng, (k - 1) // 2 * d
    steps, nt = frags.shape[0], frags.shape[1]
    fb = frags.contiguous().view(torch.bfloat16).float().reshape(steps, nt, 32, 2, 2)
    bmat = torch.zeros(steps, 16, nt * 8)
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        for reg in range(2):
            for e in range(2):
                bmat[:, 8 * reg + 2 * t4 + e, g::8] = fb[:, :, lane, reg, e]
    nmt = -(-(hi - lo) // 16)
    out = torch.zeros(nmt * 16, nt * 8)
    for mt in range(nmt):
        p0 = lo + 16 * mt
        walk = [divmod(lane >> 4, ng) for lane in range(32)]
        for s in range(steps):
            amat = torch.zeros(16, 16)
            for lane in range(32):
                hsel, (j, cg) = lane >> 4, walk[lane]
                off_j, off_c = (j, cg) if 2 * s + hsel < nq else (0, 0)
                row = p0 + (lane & 15) - half + off_j * d
                amat[lane & 15, 8 * hsel:8 * hsel + 8] = h[row, 8 * off_c:8 * off_c + 8]
                cg += 2
                for _ in range(2):
                    if cg >= ng:
                        cg, j = cg - ng, j + 1
                walk[lane] = (j, cg)
            out[16 * mt:16 * mt + 16] += amat @ bmat[s]
    return out[:hi - lo, :c]


@pytest.mark.parametrize("c", [6, 24, 48])
@pytest.mark.parametrize("k,d", [(3, 1), (7, 3), (11, 5)])
def test_pack_conv_mma_fragments(c, k, d):
    """pack_conv_mma's fragments, multiplied as the kernel's conv_mma walks
    them (mma_conv_from_fragments), give the conv of the bf16-rounded input
    and weights: the fragment order, the K flattening over (tap, channel
    group), the padded group and pad channels. The rows past the written
    window hold NaN, as stale shared memory might: only discarded rows of a
    ragged last M tile read them."""
    rng = np.random.default_rng(12)
    w = torch.from_numpy(rng.standard_normal((c, c, k)).astype(np.float32))
    half = (k - 1) // 2 * d
    lo, hi = half, half + 37  # a ragged last M tile
    _, hp = A.mma_pitches(c, 0)
    rows = torch.from_numpy(rng.standard_normal((hi + half, c)).astype(np.float32))
    rows = rows.bfloat16().float()
    h = torch.zeros(hi + half + A.MMA_PAD_ROWS, hp)
    h[:hi + half, :c] = rows
    h[hi + half:] = float("nan")
    frags = A.pack_conv_mma(w)
    steps = -(-(k * -(-c // 8)) // 2)
    assert frags.shape == (steps, -(-c // 8), 32, 2) and frags.dtype == torch.int32
    got = mma_conv_from_fragments(h, frags, c, k, d, lo, hi)
    want = F.conv1d(rows.T[None], w.bfloat16().float(), dilation=d)[0].T
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    assert torch.equal(A.pack_conv_mma(torch.stack([w, 2 * w]))[1], A.pack_conv_mma(2 * w))


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
@pytest.mark.parametrize("c,t", [(6, 1000), (24, 159744), (48, 79872), (64, 4000)])
def test_kernel_matches_plain_on_card(cuda_device, c, t):
    """The sm_90a kernels against the plain version on the card: f32 on the
    CUDA-core kernel (TF32 off; atol 1e-4: f32 sums in another order over
    18 convs; one launch, counted in the recorder's `amp_stage.f32`), and
    bf16 on the tensor-core kernel (one launch, counted in `amp_stage.mma`)
    against the f32 plain result, no worse than the plain bf16 path x1.02
    over the whole output, the first and last 256 samples and the last
    (ragged but at T=159744) tile; K2a/K2b (one launch per batch element)
    in f32 too. Each C launches at pick_tile_mma's tile,
    so the kernel's shared-memory layout fits where smem_bytes_mma says."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = make_params(6, c)
    x = torch.from_numpy(_x(7, 2, t, c)).to(cuda_device)
    for fast in (False, True):
        sp = [{"sub": [{k: v.to(cuda_device) for k, v in s.items()} for s in blk["sub"]]}
              for blk in torch_stage_params(trees)]
        plain = A.fused_amp_stage_plain(x, sp, KS, DS, fast)
        before = launches()
        out = A.fused_amp_stage(x, sp, KS, DS, fast=fast)
        torch.cuda.synchronize()
        assert launches() == (before[0] + 1, before[1])
        assert (out - plain).abs().max().item() < 1e-4
        for per_item in (A.fused_amp_stage_tc, A.fused_amp_stage_cl):
            before = launches()
            assert (per_item(x, sp, KS, DS, fast=fast) - plain).abs().max().item() < 1e-4
            assert launches() == (before[0] + x.shape[0], before[1])
        spb = [{"sub": [{k: v.bfloat16() for k, v in s.items()} for s in blk["sub"]]} for blk in sp]
        before = launches()
        kb = A.fused_amp_stage(x.bfloat16(), spb, KS, DS, fast=fast).float()
        torch.cuda.synchronize()
        assert launches() == (before[0], before[1] + 1)
        pb = A.fused_amp_stage_plain(x.bfloat16(), spb, KS, DS, fast).float()
        tile = A.pick_tile_mma(c, A.stage_radius(KS, DS))
        for lo, hi in ((0, t), (0, 256), (t - 256, t), ((t - 1) // tile * tile, t)):
            err = lambda y: (y[:, lo:hi] - plain[:, lo:hi]).abs().mean().item()
            assert err(kb) <= err(pb) * 1.02, (lo, hi, err(kb), err(pb))

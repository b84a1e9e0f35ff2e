"""The fused AMP stage (K1): plain version, per-tile valid math and the
kernel's algorithm against audiolcm_tpu.nn.pallas_amp_stage, and the CUDA
kernel against the plain version on the card (`gpu` marker).

The JAX kernel runs in interpret mode. Stage: kernels (3, 7, 11), dilations
(1, 3, 5), C=6, random snake parameters, weights and biases from a numpy
seed. f32 tolerance atol 2e-5 (the ROADMAP bar, as in
test_pallas_amp_stage.py:225) unless a test states another.
"""

import numpy as np
import pytest
import torch

from audiolcm_torch.nn import amp_stage as A

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
    bf16 path's. The kernel's numerics (bf16 in, f32 inside, one rounding
    at the output) are the emulation's; the CPU wrapper runs the plain
    version, which is the unfused path itself."""
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
    A.LAUNCHES_TC = A.LAUNCHES_CL = 0
    out = port(torch.from_numpy(x), torch_stage_params(trees), KS, DS).numpy()
    assert A.LAUNCHES_TC == A.LAUNCHES_CL == 0
    np.testing.assert_allclose(out, ref, atol=2e-5)
    np.testing.assert_allclose(out, golden, atol=2e-5)


def test_wrapper_dispatch_and_validation(stage_2048):
    x, trees, _, _ = stage_2048
    xt, sp = torch.from_numpy(x), torch_stage_params(trees)
    A.LAUNCHES = 0
    out = A.fused_amp_stage(xt, sp, KS, DS, accum="f32", conv="kstack")
    assert torch.equal(out, A.fused_amp_stage_plain(xt, sp, KS, DS))
    assert A.LAUNCHES == 0  # the CPU path launches nothing
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest -m gpu tests/test_torch_amp_stage.py)")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("c,t", [(6, 1000), (24, 159744), (48, 79872)])
def test_kernel_matches_plain_on_card(cuda_device, c, t):
    """The sm_90a kernel against the plain version on the card (f32, TF32
    off; atol 1e-4: f32 sums in another order over 18 convs), and in bf16
    against the f32 plain result, no worse than the plain bf16 path x1.02;
    K2a/K2b (one launch per batch element) in f32 too."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = make_params(6, c)
    x = torch.from_numpy(_x(7, 2, t, c)).to(cuda_device)
    for fast in (False, True):
        sp = [{"sub": [{k: v.to(cuda_device) for k, v in s.items()} for s in blk["sub"]]}
              for blk in torch_stage_params(trees)]
        plain = A.fused_amp_stage_plain(x, sp, KS, DS, fast)
        before = A.LAUNCHES
        out = A.fused_amp_stage(x, sp, KS, DS, fast=fast)
        torch.cuda.synchronize()
        assert A.LAUNCHES == before + 1
        assert (out - plain).abs().max().item() < 1e-4
        for per_item in (A.fused_amp_stage_tc, A.fused_amp_stage_cl):
            assert (per_item(x, sp, KS, DS, fast=fast) - plain).abs().max().item() < 1e-4
        spb = [{"sub": [{k: v.bfloat16() for k, v in s.items()} for s in blk["sub"]]} for blk in sp]
        kb = A.fused_amp_stage(x.bfloat16(), spb, KS, DS, fast=fast).float()
        pb = A.fused_amp_stage_plain(x.bfloat16(), spb, KS, DS, fast).float()
        assert (kb - plain).abs().mean() <= (pb - plain).abs().mean() * 1.02

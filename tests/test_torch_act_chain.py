"""The activation chain K4 (`nn/act_chain.py`, `csrc/act_chain.cu`) and the
stage-interior profiler (`audiolcm_torch/tools/profile_stage_interior.py`)
against the JAX tool `tools/profile_stage_interior.py` and
`audiolcm_tpu.nn.pallas_amp_stage.valid_alias_free_snake_cl`.

The JAX tool is imported by file path with AUDIOLCM_INTERIOR_INTERPRET=1,
so its `act_only_fn` runs the Pallas kernel in interpret mode on the CPU.
Inputs come from numpy seeds. Tolerances: f32 atol 2e-5 (the ROADMAP bar);
bf16 by mean error against the f32 chain, at most 1.02x the JAX tool's
all-bf16 chain, and max abs difference to the JAX tool below 0.1 per
activation (the JAX tool's own smoke allows 0.2 at n_rep 2: scattered
bf16 rounding stays below it, an alignment bug gives O(1) errors).
"""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from audiolcm_torch import obs
from audiolcm_torch.nn import act_chain as K
from audiolcm_torch.nn.amp_stage import SMEM_BYTES
from audiolcm_torch.tools import profile_stage_interior as PT
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

try:
    import jax
    import jax.numpy as jnp

    from audiolcm_tpu.nn.pallas_amp_stage import valid_alias_free_snake_cl as jax_valid
except ImportError:  # the machine with the card has no JAX: only the gpu test runs there
    jax = jnp = jax_valid = None

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool(tmp_path_factory):
    """tools/profile_stage_interior.py in interpret mode. Importing it sets
    JAX's compilation-cache directory; the setting is put back at once, so
    nothing of this process is cached on its account."""
    saved = {k: os.environ.get(k) for k in ("AUDIOLCM_INTERIOR_INTERPRET",
                                            "JAX_COMPILATION_CACHE_DIR")}
    cache_dir = jax.config.jax_compilation_cache_dir
    os.environ["AUDIOLCM_INTERIOR_INTERPRET"] = "1"
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path_factory.mktemp("jax_cache"))
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_profile_stage_interior", os.path.join(ROOT, "tools", "profile_stage_interior.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert mod.INTERPRET
    return mod


def _x(seed, b, t, c):
    return np.random.default_rng(seed).standard_normal((b, t, c)).astype(np.float32)


def _snake_params(seed, c):
    rng = np.random.default_rng(seed)
    return [np.exp(0.3 * rng.standard_normal(c)).astype(np.float32) for _ in range(2)]


def jax_chain_f32(x, alpha, beta, n_rep, fast):
    """Edge pad by 6 * n_rep, then n_rep JAX valid activations: (B, C, T)."""
    h = 6 * n_rep

    def one(xc):  # (C, T)
        v = jnp.pad(xc, ((0, 0), (h, h)), mode="edge")
        for _ in range(n_rep):
            v = jax_valid(v, jnp.asarray(alpha), jnp.asarray(beta), fast=fast)
        return v

    return np.asarray(jax.jit(jax.vmap(one))(jnp.transpose(jnp.asarray(x), (0, 2, 1))))


@pytest.mark.parametrize("n_rep", [1, 2, 6])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("t,tile", [(512, 128), (500, 96)])
def test_chain_matches_jax_f32(n_rep, fast, t, tile):
    """The wrapper (plain version on the CPU) and the kernel's tiling, with
    a tile that divides T and a ragged one, first and last samples included."""
    x, (alpha, beta) = _x(n_rep, 2, t, 6), _snake_params(n_rep + 10, 6)
    golden = jax_chain_f32(x, alpha, beta, n_rep, fast)
    xt, at, bt = torch.from_numpy(x), torch.from_numpy(alpha), torch.from_numpy(beta)
    out = K.act_chain(xt, at, bt, n_rep, fast=fast)
    assert out.shape == (2, 6, t) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), golden, atol=2e-5)
    emulated = K.act_chain_tiles_emulated(xt, at, bt, n_rep, fast=fast, tile=tile)
    np.testing.assert_allclose(emulated.numpy(), golden, atol=2e-5)
    h = K.halo(n_rep)
    np.testing.assert_allclose(emulated.numpy()[..., :h], golden[..., :h], atol=2e-5)
    np.testing.assert_allclose(emulated.numpy()[..., -h:], golden[..., -h:], atol=2e-5)


@pytest.mark.parametrize("n_rep", [1, K.MAX_NREP])
def test_emulation_at_kernel_tile_matches_jax_f32(n_rep):
    """The kernel's algorithm at its own tile (`pick_tile`) and margin, for
    the shortest and the longest chain the wrapper takes: three tiles, the
    last ragged, the first and last halo(n_rep) samples included. At the
    profiler's alpha 0.3 (bf16) and beta 1, as on the card: with larger
    alpha / beta a chain of 18 amplifies f32 rounding so much that JAX's and
    torch's plain chains alone differ by more than 2e-5."""
    tile = K.pick_tile(n_rep)
    t = 2 * tile + 100
    x = _x(30 + n_rep, 1, t, 3)
    alpha = np.full(3, np.float32(torch.tensor(PT.ALPHA).bfloat16().float().item()))
    beta = np.full(3, np.float32(PT.BETA))
    golden = jax_chain_f32(x, alpha, beta, n_rep, True)
    xt, at, bt = torch.from_numpy(x), torch.from_numpy(alpha), torch.from_numpy(beta)
    emulated = K.act_chain_tiles_emulated(xt, at, bt, n_rep).numpy()
    assert emulated.shape == golden.shape == (1, 3, t)
    np.testing.assert_allclose(emulated, golden, atol=2e-5)
    h = K.halo(n_rep)
    np.testing.assert_allclose(emulated[..., :h], golden[..., :h], atol=2e-5)
    np.testing.assert_allclose(emulated[..., -h:], golden[..., -h:], atol=2e-5)


@pytest.mark.parametrize("n_rep", [2, 6])
def test_chain_matches_jax_tool_bf16(jax_tool, n_rep):
    """The JAX tool's act_only_fn (Pallas interpret mode, (2, 512, 8), tile
    256, alpha 0.3 and beta 1 in bf16, the whole chain in bf16) against the
    port's act_chain in bf16 (CPU: the plain all-bf16 chain) and the
    kernel's numerics (f32 inside, one rounding)."""
    c, t, tile = 8, 512, 256
    xb = torch.from_numpy(_x(20 + n_rep, 2, t, c)).bfloat16()
    ref = np.asarray(jax_tool.act_only_fn(c, t, tile, n_rep)(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    alpha, beta = torch.full((c,), PT.ALPHA).bfloat16(), torch.full((c,), PT.BETA)
    golden = K.act_chain_plain(xb.float(), alpha, beta, n_rep).numpy()
    np.testing.assert_allclose(golden, jax_chain_f32(xb.float().numpy(), alpha.float().numpy(),
                                                     beta.numpy(), n_rep, True), atol=2e-5)
    err = lambda y: np.abs(y.float().numpy() - golden).mean()
    ref_err = np.abs(ref - golden).mean()
    port = K.act_chain(xb, alpha, beta, n_rep)
    assert port.dtype == torch.bfloat16 and port.shape == ref.shape == (2, c, t)
    assert np.abs(port.float().numpy() - ref).max() < 0.1 * n_rep
    assert err(port) <= ref_err * 1.02, (err(port), ref_err)
    kernel = K.act_chain_tiles_emulated(xb, alpha, beta, n_rep, tile=tile)
    assert err(kernel) <= ref_err * 1.02, (err(kernel), ref_err)


def test_long_chains_amplify_f32_rounding():
    """Why the wrapper stops at MAX_NREP: at the profiler's parameters the
    plain f32 chain stays within 2.5e-5 of the same chain in f64 up to
    MAX_NREP, while at n_rep 158 (what the first kernel's tiling admitted)
    f32 rounding alone moves it by more than the kernel's 1e-4 bar, so no
    f32 kernel could be held to its plain version there."""
    x = torch.from_numpy(_x(5, 1, 3000, 2))
    a, b = torch.full((2,), PT.ALPHA).bfloat16(), torch.full((2,), PT.BETA)
    drift = lambda n: (K.act_chain_plain(x, a, b, n).double()
                       - K.act_chain_plain(x.double(), a.double(), b.double(), n)).abs().max()
    assert drift(K.MAX_NREP) < 2.5e-5
    assert drift(158) > 1e-4


def test_wrapper_dispatch_and_validation():
    x = torch.from_numpy(_x(3, 1, 100, 6))
    a, b = (torch.from_numpy(v) for v in _snake_params(4, 6))
    before = obs.counters()
    assert torch.equal(K.act_chain(x, a, b, 2), K.act_chain_plain(x, a, b, 2, True))
    assert obs.counters() == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match=r"\(B, T, C\)"):
        K.act_chain(x[0], a, b, 2)
    with pytest.raises(ValueError, match="alpha and beta"):
        K.act_chain(x, a[:5], b, 2)
    with pytest.raises(ValueError, match="n_rep"):
        K.act_chain(x, a, b, 0)
    with pytest.raises(ValueError, match="n_rep"):
        K.act_chain(x, a, b, K.MAX_NREP + 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.act_chain(x.to("meta"), a, b, 2)
    # the tile is the window less two margins (the halo rounded up to a run):
    # n_rep 2 takes the largest, 6 the next; all fit shared memory twice over
    assert K.pick_tile(1) == K.pick_tile(2) == K.WINDOW - 2 * K.RUN == 1888
    assert K.pick_tile(6) == K.WINDOW - 2 * 48 == 1824
    assert K.pick_tile(K.MAX_NREP) == K.WINDOW - 2 * 112 == 1696
    for n_rep in range(1, K.MAX_NREP + 1):
        tile = K.pick_tile(n_rep)
        assert tile % K.RUN == 0 and tile + 2 * K.margin(n_rep) == K.WINDOW
        assert K.margin(n_rep) >= K.halo(n_rep) and 2 * K.smem_bytes(tile, n_rep) <= SMEM_BYTES
    with pytest.raises(ValueError, match=rf"n_rep in \[1, {K.MAX_NREP}\]"):
        K.pick_tile(K.MAX_NREP + 1)


def test_profiler_cpu_smoke(capsys):
    PT.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "stage smoke ok: (1, 512, 24)" in out and "act smoke ok: (1, 24, 512)" in out


def test_profiler_rows_match_jax_tool(jax_tool, monkeypatch, capsys):
    """The same rows, derived lines and text as the JAX tool's profile_shape
    when both are fed the same times (their launches stubbed out)."""
    times = [104.6, 52.1, 17.3, 36.0, 107.9, 104.7, 0.54, 1.42]
    feed = lambda: iter(times).__next__
    jax_next, port_next = feed(), feed()
    monkeypatch.setattr(jax_tool, "stage_fn", lambda *a, **k: None)
    monkeypatch.setattr(jax_tool, "act_only_fn", lambda *a, **k: None)
    monkeypatch.setattr(jax_tool, "timeit", lambda fn, x, iters=None: jax_next())
    jax_tool.profile_shape(8, 256, 128, b=1)
    jax_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(PT, "event_ms", lambda fn, iters: port_next())
    res = PT.profile_shape(8, 256, "cpu", batch=1)
    port_lines = capsys.readouterr().out.splitlines()
    assert port_lines[1:] == jax_lines[1:]  # all but the header (tiles, iters differ)
    assert port_lines[0].startswith("=== C=8 T=256 tile=") and jax_lines[0].startswith(
        "=== C=8 T=256 tile=128 b=1")
    assert [k for k, _ in PT.ROWS] == list(res["ms"]) and list(res["ms"].values()) == times
    assert math.isclose(res["act_split"]["unit_ms"], (1.42 - 0.54) / 4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device "
                    "(run: python -m pytest -m gpu tests/test_torch_act_chain.py)")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("c,t", [(6, 1000), (48, 79872 - 77), (24, 159744)])
def test_kernel_matches_plain_on_card(cuda_device, c, t):
    """The sm_90a kernel against the plain version on the card at the
    profiler's alpha 0.3 and beta 1: f32 atol 1e-4 (sums in another order)
    over the whole output and its first and last halo(n_rep) samples, and
    in bf16 no worse than the plain bf16 chain x1.02; n_rep 1, 2, 6 and
    (at C=48) the longest chain the wrapper takes."""
    x = torch.from_numpy(_x(7, 2, t, c)).to(cuda_device)
    a = torch.full((c,), PT.ALPHA, device=cuda_device).bfloat16()
    b = torch.full((c,), PT.BETA, device=cuda_device)
    for n_rep in (1, 2, 6) + ((K.MAX_NREP,) if c == 48 else ()):
        for fast in (False, True):
            plain = K.act_chain_plain(x, a, b, n_rep, fast)
            before = obs.counters().get("act_chain", 0)
            out = K.act_chain(x, a, b, n_rep, fast)
            torch.cuda.synchronize()
            assert obs.counters().get("act_chain", 0) == before + 1
            err, h = (out - plain).abs(), K.halo(n_rep)
            assert err.max().item() < 1e-4
            assert max(err[..., :h].max().item(), err[..., -h:].max().item()) < 1e-4
            kb = K.act_chain(x.bfloat16(), a, b, n_rep, fast).float()
            pb = K.act_chain_plain(x.bfloat16(), a, b, n_rep, fast).float()
            assert (kb - plain).abs().mean() <= (pb - plain).abs().mean() * 1.02

"""Port parity: the full-width BigVGAN (shipped 16 kHz config) against
audiolcm_tpu.models.bigvgan on a (1, 16, 80) mel, f32 CPU. One JAX golden
serves every case: JAX at pallas_stage_max_channels=96, which on this mel
fuses the C=96, 48 and 24 stages (its Pallas kernel in interpret mode) and
so holds the port's fused stage (C=24 at knob 24) and its unfused one. Mirrors test_pallas_amp_stage.py:206-225: JAX init
weights' scale, non-zero biases and snake parameters, all from a numpy
seed; atol 2e-5. The fused-stage knob above C=64 follows JAX: JAX fuses
every stage whose length admits a tile, the port every stage whose route
has a tile (`amp_stage.route_takes`), and both run the others unfused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch import obs
from audiolcm_torch.convert import assign_state_dict, vocoder_from_jax
from audiolcm_torch.models.bigvgan import BigVGAN as TorchBigVGAN
from audiolcm_torch.models.bigvgan import BigVGANConfig as TConfig
from audiolcm_torch.nn import amp_stage
from audiolcm_tpu.models.bigvgan import BigVGAN as JaxBigVGAN
from audiolcm_tpu.models.bigvgan import BigVGANConfig as JConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)


@pytest.fixture(scope="module")
def vocoder_case():
    rng = np.random.default_rng(11)
    mel = (rng.standard_normal((1, 16, 80)) * 0.3).astype(np.float32)
    jmodel = JaxBigVGAN(JConfig(), pallas_stage_max_channels=96, pallas_interpret=True)
    shapes = jax.eval_shape(
        lambda: JaxBigVGAN(JConfig()).init(jax.random.PRNGKey(0), jnp.asarray(mel)))["params"]
    # the JAX init's weight scale (normal 0.01); biases and snakes 0.1 * N
    params = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * (0.01 if len(a.shape) > 1 else 0.1)
                   ).astype(np.float32), shapes)
    golden = np.asarray(jax.jit(lambda p, m: jmodel.apply({"params": p}, m))(params, jnp.asarray(mel)))
    return mel, params, golden


@pytest.fixture(scope="module")
def knob96_golden(vocoder_case):
    """JAX at pallas_stage_max_channels=96: on this mel it fuses the C=96
    stage (T=1024, tile 512), C=48 and C=24, in interpret mode
    (`vocoder_case`'s golden)."""
    return vocoder_case[2]


def test_bigvgan_full_width_matches_jax_fused_stage(vocoder_case):
    mel, params, golden = vocoder_case
    port = assign_state_dict(TorchBigVGAN(TConfig(), pallas_stage_max_channels=24),
                             vocoder_from_jax(params))
    before = obs.counters()
    with torch.no_grad():
        wav = port(torch.from_numpy(mel))
    assert wav.shape == golden.shape == (1, 16 * 256)
    assert obs.counters() == before  # CPU: the wrapper ran the plain version
    np.testing.assert_allclose(wav.numpy(), golden, atol=2e-5)


def test_bigvgan_unfused_equals_fused_path(vocoder_case):
    """pallas_stage_max_channels=0 (every stage unfused) gives the same
    waveform: the knob changes the route, not the function."""
    mel, params, golden = vocoder_case
    port = assign_state_dict(TorchBigVGAN(TConfig()), vocoder_from_jax(params))
    with torch.no_grad():
        wav = port(torch.from_numpy(mel))
    np.testing.assert_allclose(wav.numpy(), golden, atol=2e-5)


@pytest.mark.parametrize("knob", [96, 1536])
def test_bigvgan_knob_above_route_widths_matches_jax(vocoder_case, knob96_golden, knob):
    """A knob above the widest C a kernel route takes returns the JAX
    waveform: the stages the route cannot take run unfused (on the CPU, f32:
    C=48 and 24 go through the fused stage's plain version, C>=96 unfused),
    decided before any launch."""
    mel, params, _ = vocoder_case
    port = assign_state_dict(TorchBigVGAN(TConfig(), pallas_stage_max_channels=knob),
                             vocoder_from_jax(params))
    widths = (768, 384, 192, 96, 48, 24)
    for dtype in (torch.float32, torch.bfloat16):
        assert [c for i, c in enumerate(widths)
                if port.stage_route(i, dtype, torch.device("cpu"), 16) == "fused"] == [48, 24]
    with torch.no_grad():
        wav = port(torch.from_numpy(mel))
    assert wav.shape == knob96_golden.shape == (1, 16 * 256)
    np.testing.assert_allclose(wav.numpy(), knob96_golden, atol=2e-5)


def test_route_takes_answers_without_raising():
    ks, ds = (3, 7, 11), (1, 3, 5)
    assert amp_stage.stage_radius(ks, ds) == 96
    assert not amp_stage.route_takes(torch.bfloat16, 96, ks, ds)
    assert amp_stage.route_takes(torch.bfloat16, 48, ks, ds)
    assert amp_stage.route_takes(torch.bfloat16, amp_stage.MMA_MAX_C, ks, ds)
    assert amp_stage.route_takes(torch.float32, 48, ks, ds)
    assert not amp_stage.route_takes(torch.float32, 96, ks, ds)
    assert not amp_stage.route_takes(torch.float16, 24, ks, ds)  # no kernel takes f16
    # the query agrees with the tile pickers wherever they find a tile
    for c in range(1, 100):
        for dtype, route in ((torch.bfloat16, "mma"), (torch.float32, "cuda_core")):
            try:
                amp_stage.route_tile(route, c, ks, ds, 8, 79872)
                fits = True
            except ValueError:
                fits = False
            assert amp_stage.route_takes(dtype, c, ks, ds) == fits, (c, dtype)


def test_fused_stage_packed_once_per_weight_version(monkeypatch):
    """K1's packed stage parameters (`BigVGAN.fused_params`) follow the
    weights as K6's do: `pack_stage_weights` packs the fused stages (C = 48
    and 24 at knob 48); a forward after it packs nothing; an in-place weight
    update (a checkpoint load) packs that stage again, and only it; a dtype
    change packs anew; inference tensors keep no version and are packed by
    storage; a forward under autograd packs each fused stage anew (the
    plain version differentiates the packing's params) and leaves the
    packings kept for forwards without autograd. The packed tensors are
    those of the current weights, for the kernel of the module's dtype."""
    from audiolcm_torch.models import bigvgan as tb

    packs = []
    real = tb.pack_stage

    def logged(sp, ks, ds, dtype, device):
        packs.append((sp[0]["sub"][0]["w1"].shape[0], dtype))
        return real(sp, ks, ds, dtype, device)

    monkeypatch.setattr(tb, "pack_stage", logged)
    torch.manual_seed(0)
    voc = TorchBigVGAN(TConfig(), pallas_stage_max_channels=48)
    mel = torch.randn(1, 4, 80) * 0.3
    f32, bf16, cpu = torch.float32, torch.bfloat16, torch.device("cpu")
    voc.pack_stage_weights()
    assert packs == [(48, f32), (24, f32)]
    with torch.no_grad():
        voc(mel)
        first = voc.fused_params(5, f32, cpu)
        assert voc.fused_params(5, f32, cpu) is first
    assert packs == [(48, f32), (24, f32)]  # nothing packed inside the forward
    blocks = voc.resblocks[15:18]  # stage 5, C = 24
    with torch.no_grad():
        blocks[1].convs2[0].weight.mul_(2.0)
        voc(mel)
        again = voc.fused_params(5, f32, cpu)
    assert packs == [(48, f32), (24, f32), (24, f32)] and again is not first
    want = amp_stage.pack_stage_params([b.stage_params(f32) for b in blocks], cpu)
    assert torch.equal(again.weights, want[0]) and torch.equal(again.vectors, want[1])
    voc(mel)  # autograd on
    assert packs[3:] == [(48, f32), (24, f32)]
    with torch.no_grad():
        assert voc.fused_params(5, f32, cpu) is again
    voc = voc.to(bf16)
    voc.pack_stage_weights()
    assert packs[5:] == [(48, bf16), (24, bf16)]
    with torch.no_grad():
        packed = voc.fused_params(5, bf16, cpu)
    want = amp_stage.pack_stage_params_mma([b.stage_params(bf16) for b in voc.resblocks[15:18]],
                                           cpu)
    assert torch.equal(packed.weights, want[0]) and torch.equal(packed.vectors, want[1])
    with torch.inference_mode():  # inference tensors keep no version: packed by storage
        voc = voc.to(f32)
        assert voc.fused_params(4, f32, cpu) is voc.fused_params(4, f32, cpu)
    assert len(packs) == 8

"""Port parity: the serving knobs of the batch-1 vocoder (the overlap-discard
fold, nn/fold.py) and the dynamic-int8 resblock convs (nn/int8_conv.py)
against audiolcm_tpu, f32 CPU; and the captured-generate registry
(aot.py, api.prewarm_buckets) as far as the CPU can hold it: the bucket
keys, the refusal on a CPU pipeline, and generate preferring a registered
entry.

Tolerances: the fold moves no number (atol 2e-5, the f32 module bar, also
against the unfolded port); int8's quantised values and scales equal JAX's
exactly and its conv output agrees at atol 1e-5; the int8 vocoder is held
relative to int8's own error (see its test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch import aot as t_aot
from audiolcm_torch import api as t_api
from audiolcm_torch.convert import assign_state_dict, vocoder_from_jax
from audiolcm_torch.data.buckets import DEFAULT_MEL_BUCKETS as T_BUCKETS
from audiolcm_torch.models import bigvgan as t_voc
from audiolcm_torch.models import clap_text as t_clap
from audiolcm_torch.models import dit as t_dit
from audiolcm_torch.models import t5_encoder as t_t5
from audiolcm_torch.models import vae1d as t_vae
from audiolcm_torch.nn import fold as t_fold
from audiolcm_torch.nn import int8_conv as t_int8
from audiolcm_torch.pipeline import AudioLCMPipeline, PipelineModules
from audiolcm_tpu.data.buckets import DEFAULT_MEL_BUCKETS as J_BUCKETS
from audiolcm_tpu.models import bigvgan as j_voc
from audiolcm_tpu.nn import fold as j_fold
from audiolcm_tpu.nn import int8_conv as j_int8
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

# the JAX fold test's vocoder (tests/test_bigvgan_fold.py): C=16 then C=8
FOLD_CFG = dict(num_mels=8, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                upsample_initial_channel=32)
# C=32 then C=16: both take the int8 product (K, N multiples of 8)
INT8_CFG = dict(num_mels=8, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                upsample_initial_channel=64)


def _vocoder_params(cfg, mel, seed):
    """JAX-init-shaped parameters from a numpy seed: convs 0.1 / sqrt(fan
    in) (a signal that neither vanishes nor saturates over the stages),
    biases and log-scale snakes 0.1 * N."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: j_voc.BigVGAN(cfg).init(jax.random.PRNGKey(0), jnp.asarray(mel)))["params"]

    def draw(a):
        if len(a.shape) > 1:
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.standard_normal(a.shape) * fan_in ** -0.5).astype(np.float32)
        return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)

    return jax.tree.map(draw, shapes)


def _jax_wav(model, params, mel):
    return np.asarray(jax.jit(lambda p, m: model.apply({"params": p}, m))(params, jnp.asarray(mel)))


def _port(cfg, params, **kw):
    return assign_state_dict(t_voc.BigVGAN(t_voc.BigVGANConfig(**cfg), **kw),
                             vocoder_from_jax(params)).eval()


def test_fold_round_trip_and_halo_match_jax(rng):
    """fold_time on (1, C, T) is JAX's fold_time on (1, T, C) transposed,
    unfold_time inverts it exactly, and the halo and legality rules are
    JAX's."""
    x = rng.standard_normal((1, 64, 3)).astype(np.float32)
    xt = torch.from_numpy(x).transpose(1, 2)
    for fold, halo in [(4, 5), (2, 8), (8, 4)]:
        y = t_fold.fold_time(xt, fold, halo)
        assert y.shape == (fold, 3, 64 // fold + 2 * halo)
        np.testing.assert_array_equal(y.transpose(1, 2).numpy(),
                                      np.asarray(j_fold.fold_time(jnp.asarray(x), fold, halo)))
        back = t_fold.unfold_time(y, fold, halo, 64 // fold)
        assert torch.equal(back, xt)
    with pytest.raises(ValueError, match="batch of 1"):
        t_fold.fold_time(torch.zeros(2, 3, 64), 4, 5)
    for u, k in [(4, 8), (2, 4), (8, 16)]:
        for ks, ds in [((3, 7, 11), ((1, 3, 5),) * 3), ((3,), ((1, 3),))]:
            assert (t_fold.stage_fold_halo(u, k, ks, ds)
                    == j_fold.stage_fold_halo(u, k, ks, ds))
    assert t_fold.stage_fold_halo(4, 8, (3, 7, 11), ((1, 3, 5),) * 3) == 29
    for t in (250, 256, 512, 1024):
        for fold in (1, 2, 4, 8):
            for halo in (4, 29, 53):
                assert t_fold.fold_legal(t, fold, halo) == j_fold.fold_legal(t, fold, halo)


@pytest.mark.parametrize("cf_max,knob", [(48, 8), (0, 0)])
def test_bigvgan_fold8_batch1_matches_jax(cf_max, knob):
    """Batch 1, fold 8, on a 512-frame mel: (48, 8) folds the C=16 stage in
    the polyphase channels-first form and fuses C=8 (JAX's Pallas kernel in
    interpret mode, the port's plain version); (0, 0) folds both stages in
    the channels-last form. The folded port matches JAX's folded vocoder
    and its own unfolded waveform at atol 2e-5."""
    cfg = j_voc.BigVGANConfig(**FOLD_CFG)
    mel = (np.random.default_rng(3).standard_normal((1, 512, 8)) * 0.5).astype(np.float32)
    params = _vocoder_params(cfg, mel, seed=4)
    golden = _jax_wav(j_voc.BigVGAN(cfg, cf_max_channels=cf_max, fold_t_segments=8,
                                    pallas_stage_max_channels=knob, pallas_interpret=True),
                      params, mel)
    with torch.no_grad():
        wavs = {fold: _port(FOLD_CFG, params, cf_max_channels=cf_max, fold_t_segments=fold,
                            pallas_stage_max_channels=knob)(torch.from_numpy(mel)).numpy()
                for fold in (8, 0)}
    assert wavs[8].shape == golden.shape == (1, 512 * 8)
    assert np.abs(golden).max() > 1e-2  # a signal, not a flat line
    np.testing.assert_allclose(wavs[8], golden, atol=2e-5)
    np.testing.assert_allclose(wavs[8], wavs[0], atol=2e-5)


@pytest.mark.parametrize("dilation", [1, 3])
def test_int8_conv1d_cl_matches_jax(rng, dilation):
    """The JAX test's shape (B 2, T 96, C 64, k 11): the quantised
    activations, weights and both scales equal JAX's exactly; the conv
    output agrees at atol 1e-5."""
    b, t, c, k = 2, 96, 64, 11
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w = (rng.standard_normal((c, c, k)) / np.sqrt(c * k)).astype(np.float32)  # torch layout
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    wj = jnp.asarray(np.transpose(w, (2, 1, 0)))  # JAX layout (k, C_in, C_out)
    q, s = t_int8.quantize_per_tensor(torch.from_numpy(x))
    qj, sj = j_int8.quantize_per_tensor(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(qj))
    assert s.item() == float(sj)
    wq, ws = t_int8.quantize_weight_per_cout(torch.from_numpy(w))
    wqj, wsj = j_int8.quantize_weight_per_cout(wj)
    assert np.array_equal(wq.permute(2, 1, 0).numpy(), np.asarray(wqj))
    assert np.array_equal(ws.numpy(), np.asarray(wsj))
    out = t_int8.int8_conv1d_cl(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                                dilation)
    golden = np.asarray(j_int8.int8_conv1d_cl(jnp.asarray(x), wj, jnp.asarray(bias), dilation))
    assert out.shape == (b, t, c) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), golden, atol=1e-5)


def test_int8_product_shape_rule_raises():
    """cuBLASLt's int8 GEMM takes M > 16 and K, N multiples of 8; any other
    shape raises on every device rather than running another path."""
    t_int8.check_int_mm_shape(17, 8, 16)
    for m, k, n in [(16, 8, 8), (32, 6, 8), (32, 8, 12)]:
        with pytest.raises(ValueError, match="multiples of 8"):
            t_int8.check_int_mm_shape(m, k, n)
    with pytest.raises(ValueError, match="C_in"):
        t_int8.int8_conv1d_cl(torch.zeros(1, 32, 6), torch.zeros(8, 6, 3), torch.zeros(8), 1)


def test_bigvgan_int8_knob_matches_jax():
    """int8_min_channels=32 with every stage channels-last (cf_max 0): the
    C=32 stage's resblock convs take the int8 product on both sides, C=16
    stays exact. Quantisation is discontinuous: a float difference of 1e-7
    upstream (torch's and XLA's convs sum in other orders) can move an
    activation across a rounding boundary, and one step of 1/127 of the
    tensor's range then moves the waveform by ~1e-4 there. So the bar is
    relative to int8's own error against the exact vocoder: the port's int8
    waveform differs from JAX's int8 waveform by a mean under 1 % of that
    error (measured 0.45 %), and its error against JAX's exact waveform is
    within 2 % of JAX's int8 waveform's (measured 0.1 %)."""
    cfg = j_voc.BigVGANConfig(**INT8_CFG)
    mel = (np.random.default_rng(6).standard_normal((2, 16, 8)) * 0.5).astype(np.float32)
    params = _vocoder_params(cfg, mel, seed=7)
    golden8 = _jax_wav(j_voc.BigVGAN(cfg, cf_max_channels=0, int8_min_channels=32), params, mel)
    golden = _jax_wav(j_voc.BigVGAN(cfg, cf_max_channels=0), params, mel)
    with torch.no_grad():
        wav = _port(INT8_CFG, params, cf_max_channels=0, int8_min_channels=32)(
            torch.from_numpy(mel)).numpy()
    assert wav.shape == golden8.shape == (2, 16 * 8)
    int8_err = np.abs(golden8 - golden).mean()
    assert int8_err > 1e-3  # the knob took effect
    assert np.abs(wav - golden8).mean() < 0.01 * int8_err
    assert abs(np.abs(wav - golden).mean() / int8_err - 1.0) < 0.02


def _tiny_pipeline():
    """A CPU pipeline at tiny widths with torch's default init (no JAX)."""
    torch.manual_seed(0)
    mods = PipelineModules(
        dit=t_dit.ConcatDiT2MLP(in_channels=4, context_dim=16, hidden_size=32, depth=1,
                                num_heads=4, max_len=64),
        vae=t_vae.AutoencoderKL1D(t_vae.VAEConfig(
            in_channels=8, out_ch=8, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_layers=(),
            down_layers=(0,), kernel_size=5, z_channels=4, embed_dim=4)),
        vocoder=t_voc.BigVGAN(t_voc.BigVGANConfig(**FOLD_CFG)),
        clap_text=t_clap.ClapTextEncoder(t_clap.BertConfig(
            vocab_size=30, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
            max_position_embeddings=16), 16),
        t5=t_t5.T5Encoder(t_t5.T5Config(vocab_size=30, d_model=16, d_kv=8, d_ff=24,
                                        num_layers=1, num_heads=2)))
    return AudioLCMPipeline(mods, device="cpu", default_latent_len=8)


def test_prewarm_buckets_raises_on_cpu_pipeline():
    pipe = _tiny_pipeline()
    with pytest.raises(ValueError, match="CUDA"):
        t_api.prewarm_buckets(pipe, batch_sizes=(1,), mel_buckets=(16,))
    with pytest.raises(ValueError, match="CUDA"):
        t_aot.CapturedGenerate(pipe, 1, 8)
    assert pipe._graphs == {}  # no eager stand-in was registered


def test_bucket_keys_match_jax():
    """The serving points are JAX's prewarm keys over the same lattice
    ((batch, mel // 2) for each batch and mel bucket), and the registry key
    of a (batch, 77) id pair is the tuple JAX's generate_jit builds."""
    assert T_BUCKETS == J_BUCKETS
    points = t_api.serving_points((1, 8))
    assert points == [(b, mel // 2) for b in (1, 8) for mel in J_BUCKETS]
    assert t_api.serving_points((8,), (312, 624)) == [(8, 156), (8, 312)]
    for dtype, jdtype in ((torch.int32, jnp.int32), (torch.int64, np.int64)):
        ids, jids = torch.zeros((8, 77), dtype=dtype), np.zeros((8, 77), jdtype)
        jids = jnp.asarray(jids) if jdtype is jnp.int32 else jids
        jax_key = (jids.shape, jids.shape, str(jids.dtype), str(jids.dtype), 312)
        assert t_aot.graph_key(ids, ids, 312) == jax_key


def test_generate_prefers_registered_entry():
    """A registered entry answers generate for its key, with the caller's
    generator (seed 0 when None); another latent length, another id dtype
    or injected draws run the eager path."""
    pipe = _tiny_pipeline()
    ids = torch.zeros((1, 7), dtype=torch.int64)
    calls = []

    class Entry:
        def replay(self, clap_ids, t5_ids, generator):
            calls.append(generator)
            return "wav", "mel"

    pipe._graphs[t_aot.graph_key(ids, ids, 8)] = Entry()
    gen = torch.Generator().manual_seed(3)
    assert pipe.generate(ids, ids, 8, generator=gen) == ("wav", "mel")
    assert calls == [gen]
    assert pipe.generate(ids, ids) == ("wav", "mel")  # default latent 8, default generator
    assert isinstance(calls[-1], torch.Generator) and calls[-1].initial_seed() == 0
    n = len(calls)
    wav, mel = pipe.generate(ids, ids, 4)
    assert wav.shape == (1, 8 * 8) and mel.shape == (1, 8, 8)
    pipe.generate(ids.int(), ids.int(), 8)
    pipe.generate(ids, ids, 8, x_T=torch.zeros(1, 8, 4), noise=torch.zeros(1, 1, 8, 4))
    assert len(calls) == n

"""The Flag-DiT teacher (TxtFlagLargeDiT) on the port's normal serving path,
at tiny widths on the CPU: `api.build_pipeline` from a YAML naming the
Flag target and a checkpoint in the port's key names, `generate_teacher`
against the plain reference (`benchmark/reference/flag_dit.py`) with the
reference DDIM on the same weights and draws, the bf16 serving route's
error against the parity route's, and the registry's serving knobs.

Weights are drawn as the benchmark draws them (`benchmark/drivers/
generate_flagdit.py`): fan-in normal, norm scales ~1, the attention gates
at std 0.5 so that the caption branch reaches the output.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from audiolcm_torch import config as registry
from audiolcm_torch import native_ckpt
from audiolcm_torch.api import build_pipeline
from audiolcm_torch.models.flag_dit import TxtFlagLargeDiT
from benchmark.drivers.generate import empty_ids
from benchmark.drivers.generate_flagdit import build_modules, make_state_dicts
from benchmark.harness.rehearsal import tiny
from benchmark.reference import flag_dit as ref
from benchmark.reference import ops, samplers
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

ROOT = Path(__file__).resolve().parents[1]
FLAG = "ldm.modules.diffusionmodules.flag_large_dit.TxtFlagLargeDiT"
REL_L2 = 1e-4  # f32 against f32: reassociation only, as the benchmark's rehearsal
BF16_BAR = 1.02  # chip_smoke's bar for a bf16 route against the plain bf16 path


def _config(steps: int = 4) -> dict:
    """The benchmark's Flag configuration at the rehearsal's tiny widths, two
    blocks, f32, `steps` DDIM steps."""
    c = json.loads((ROOT / "benchmark/configs/flagdit_2b_teacher.json").read_text())
    t = json.loads((ROOT / "benchmark/traffic/b8_10s_flagdit.json").read_text())
    c = tiny(c, t)[0]
    c["dit"]["depth"] = 2
    c["sampler"]["num_steps"] = steps
    return c


def _yaml(c: dict) -> dict:
    """The reference YAML (configs/teacher.yaml schema) of configuration c."""
    fields = lambda d, keys: {k: d[k] for k in keys if k in d}
    bert = fields(c["clap_text"], ("vocab_size", "hidden_size", "num_layers", "num_heads",
                                   "intermediate_size", "max_position_embeddings",
                                   "type_vocab_size", "layer_norm_eps"))
    t5 = {k: v for k, v in c["t5"].items()}
    dd = {k: v for k, v in c["vae"].items() if k != "embed_dim"}
    s = c["schedule"]
    return {"model": {"params": {
        "timesteps": s["timesteps"], "linear_start": s["linear_start"],
        "linear_end": s["linear_end"], "mel_length": 312,
        "unet_config": {"target": FLAG,
                        "params": {k: v for k, v in c["dit"].items() if k != "target"}},
        "first_stage_config": {"target": "ldm.models.autoencoder1d.AutoencoderKL",
                               "params": {"embed_dim": c["vae"]["embed_dim"], "ddconfig": dd}},
        "cond_stage_config": {"target": "ldm.modules.encoders.modules.FrozenCLAPFLANEmbedder",
                              "params": {"bert_config": bert, "t5_config": t5,
                                         "d_proj": c["clap_text"]["d_proj"]}}}}}


def _write_checkpoint(tmp: Path, c: dict, sds: dict):
    """(yaml path, checkpoint path, vocoder dir) of configuration c with the
    state dicts sds under the Lightning prefixes split_lcm_state_dict reads."""
    prefixes = {"dit": "model.diffusion_model.", "vae": "first_stage_model.",
                "clap_text": "cond_stage_model.caption_encoder.",
                "t5": "cond_stage_model.t5_transformer."}
    sd = {p + k: v.clone() for m, p in prefixes.items() for k, v in sds[m].items()}
    sd["scale_factor"] = torch.tensor(c["scale_factor"])
    torch.save({"state_dict": sd}, tmp / "flag.ckpt")
    voc = tmp / "vocoder"
    voc.mkdir()
    torch.save({"generator": {k: v.clone() for k, v in sds["vocoder"].items()}},
               voc / "best_netG.pt")
    (voc / "args.yml").write_text(yaml.safe_dump(c["vocoder"]))
    (tmp / "flag.yaml").write_text(yaml.safe_dump(_yaml(c)))
    return str(tmp / "flag.yaml"), str(tmp / "flag.ckpt"), str(voc)


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double().flatten(1), want.double().flatten(1)
    return float(((g - w).norm(dim=1) / w.norm(dim=1)).max())


@pytest.mark.parametrize("use_flash", [False, True], ids=["parity-route", "serving-route"])
def test_build_pipeline_serves_the_flag_teacher_like_the_plain_reference(tmp_path, use_flash):
    """api.build_pipeline builds TxtFlagLargeDiT from the YAML's unet target
    and generate_teacher (4 DDIM steps, guidance 5 by batch doubling) equals
    the plain reference's DDIM over the same weights, ids and x_T: mel and
    waveform within 1e-4 relative L2, on either route of the DiT."""
    c = _config()
    sds = make_state_dicts(c, 2 ** 31 + 17, torch.device("cpu"), torch.float32)
    pipe = build_pipeline(*_write_checkpoint(tmp_path, c, sds), device="cpu",
                          compute_dtype=torch.float32, use_flash=use_flash)
    assert type(pipe.modules.dit) is TxtFlagLargeDiT and pipe.modules.dit.use_flash == use_flash
    gen = lambda: torch.Generator().manual_seed(123)
    ids = [torch.randint(0, c[t]["vocab_size"], (2, 77), generator=torch.Generator()
                         .manual_seed(i)) for i, t in enumerate(("clap_text", "t5"))]
    uncond = empty_ids(c, 77)
    latent = 10
    wav, mel = pipe.generate_teacher(pipe.encode_text_ids(*ids), pipe.encode_text_ids(*uncond),
                                     latent, num_steps=4, guidance_scale=5.0, generator=gen())
    x_t, _ = samplers.draws(gen(), (2, latent, c["dit"]["in_channels"]), 0, "cpu")
    with torch.no_grad():
        ref_wav, ref_mel = ref.generate(sds, c, *ids, x_t, uncond, ops.F32)
    assert mel.shape == ref_mel.shape and wav.shape == ref_wav.shape
    assert _rel_l2(mel, ref_mel) <= REL_L2
    assert _rel_l2(wav, ref_wav) <= REL_L2


def _flag_pair(seed: int):
    """A TxtFlagLargeDiT (hidden 64, 8 heads, 2 blocks, qk-norm) with the
    benchmark's weight draws, its state dict, and inputs at batch 32 over
    96 latent tokens and 20 caption tokens."""
    c = copy.deepcopy(_config())
    c["dit"].update(hidden_size=64, num_heads=8, context_dim=32, in_channels=8)
    sds = make_state_dicts(c, seed, torch.device("cpu"), torch.float32)
    kw = {k: v for k, v in c["dit"].items() if k != "target"}
    rng = torch.Generator().manual_seed(seed)
    x = torch.randn(32, 96, 8, generator=rng)
    t = torch.randint(0, 1000, (32,), generator=rng)
    ctx = torch.randn(32, 20, 32, generator=rng)
    return c, kw, sds["dit"], (x, t, ctx)


def _dit(kw, sd, use_flash, dtype):
    m = TxtFlagLargeDiT(**kw, use_flash=use_flash)
    m.load_state_dict(sd)
    return m.to(dtype).eval()


def test_bf16_serving_route_error_within_the_parity_route_bar():
    """Against the plain f32 reference's eps, the bf16 serving route
    (qk-norm and rotary in f32 rounded once, both attentions through the
    flash path, the gated sum in one rounding) has a mean error at most
    1.02x the bf16 parity route's (f32 rotary and attention, one rounding at
    the output projection's input), summed over three draws; in f32 the two
    routes agree to 1e-5."""
    err_serving = err_parity = 0.0
    for seed in (1, 2, 3):
        c, kw, sd, (x, t, ctx) = _flag_pair(seed)
        with torch.no_grad():
            want = ref.dit(sd, c["dit"], x, t, ctx)
            f32 = [_dit(kw, sd, f, torch.float32)(x, t, ctx) for f in (False, True)]
            np.testing.assert_allclose(f32[1].numpy(), f32[0].numpy(), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(f32[0].numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
            bf = lambda f: _dit(kw, sd, f, torch.bfloat16)(
                x.bfloat16(), t, ctx.bfloat16()).float()
            err_parity += (bf(False) - want).abs().mean().item()
            err_serving += (bf(True) - want).abs().mean().item()
    assert err_serving <= BF16_BAR * err_parity, (err_serving, err_parity)


@pytest.mark.parametrize("use_flash", [False, True])
def test_caption_memo_reuses_the_caption_bit_for_bit_and_only_while_open(use_flash):
    """Inside `caption_memo` a second forward over the same context tensor
    reads the caption once computed (the blocks' caption projections run
    once) and gives the memo-less eps bit for bit, in bf16; another context
    tensor is computed afresh; closing the memo drops what it held."""
    _, kw, sd, (x, t, ctx) = _flag_pair(4)
    m = _dit(kw, sd, use_flash, torch.bfloat16)
    x, ctx = x[:4].bfloat16(), ctx[:4].bfloat16()
    t, other = t[:4], torch.flip(ctx, dims=[0])
    calls = []
    m.blocks[0].attention_y_norm.register_forward_hook(lambda *_: calls.append(1))
    with torch.inference_mode():
        want = [m(x, t, c) for c in (ctx, other)]
        calls.clear()
        with m.caption_memo():
            got = [m(x, t, ctx), m(x, t, ctx), m(x, t, other)]
            assert m._memo["context"] is other
        assert m._memo is None
    assert len(calls) == 2
    for g, w in zip(got, (want[0], want[0], want[1])):
        assert torch.equal(g, w)


def test_registry_takes_the_flash_knob_and_refuses_what_the_flag_dit_cannot_take():
    """The registry builds TxtFlagLargeDiT with use_flash, drops fuse_qkv
    when off, refuses it when on and refuses names that are no serving
    knob, each with a message; it reads ffn_dim_multiplier and norm_eps."""
    params = dict(in_channels=4, context_dim=16, hidden_size=32, depth=1, num_heads=4,
                  max_len=64, qk_norm=True, ffn_dim_multiplier=1.5, norm_eps=1e-6)
    spec = registry.REGISTRY[FLAG](params)
    served = spec.build(use_flash=True, fuse_qkv=False)
    assert served.use_flash and served.blocks[0].attention.use_flash
    assert not spec.build().use_flash
    with pytest.raises(TypeError, match="TxtFlagLargeDiT does not take .*fuse_qkv"):
        spec.build(use_flash=True, fuse_qkv=True)
    with pytest.raises(TypeError, match="not serving knobs"):
        spec.build(use_flsh=True)
    # SwiGLU hidden: int(1.5 * int(2 * 128 / 3)) = 127 -> 256; RMSNorm eps 1e-6
    assert served.blocks[0].feed_forward.w1.out_features == 256
    assert served.blocks[0].attention_norm.eps == 1e-6
    concat = registry.REGISTRY["ldm.modules.diffusionmodules.concatDiT.ConcatDiT2MLP"](params)
    assert concat.build(use_flash=True, fuse_qkv=True).fuse_qkv


def test_flag_pipeline_saves_and_loads_its_native_checkpoint(tmp_path):
    """A pipeline whose denoiser is TxtFlagLargeDiT (no fuse_qkv knob) goes
    through native_ckpt: saved, loaded into modules built the same way, the
    same teacher output bit for bit."""
    c = _config(steps=2)
    sds = make_state_dicts(c, 5, torch.device("cpu"), torch.float32)
    pipe = build_pipeline(*_write_checkpoint(tmp_path, c, sds), device="cpu",
                          compute_dtype=torch.float32, use_flash=True, fast_snake=True,
                          pallas_stage_max_channels=c["serving"]["pallas_stage_max_channels"])
    native_ckpt.save_pipeline(str(tmp_path / "native"), pipe)
    loaded = native_ckpt.load_pipeline(str(tmp_path / "native"), build_modules(c, "cpu"),
                                       device="cpu")
    ids = [torch.randint(0, 30, (1, 77), generator=torch.Generator().manual_seed(i))
           for i in range(2)]
    uncond = empty_ids(c, 77)
    outs = [p.generate_teacher(p.encode_text_ids(*ids), p.encode_text_ids(*uncond), 6,
                               num_steps=2, generator=torch.Generator().manual_seed(9))
            for p in (pipe, loaded)]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])

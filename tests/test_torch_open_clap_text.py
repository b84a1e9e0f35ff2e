"""Port parity: the LAION open_clap text side against
`audiolcm_tpu.models.open_clap` at tiny widths on the CPU: the RoBERTa,
CLIP and BART towers with padded masks, every text branch of `OpenClap`,
the CLIP BPE tokenizer, the two LAION embedders and their registry
targets. JAX's OpenClap always builds the published roberta / bert / bart
presets, so its tests patch those config names to tiny ones (the port takes
`OpenClapConfig.text_config`). Parameters come from a numpy seed
(`random_params`) and reach the port through `convert.open_clap_from_jax`.
Bars: atol 2e-5; the tokenizer's ids equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch import config as t_cfg
from audiolcm_torch.convert import open_clap_from_jax
from audiolcm_torch.models import clap_text as t_clap
from audiolcm_torch.models.open_clap import embedders as t_emb
from audiolcm_torch.models.open_clap import factory as t_factory
from audiolcm_torch.models.open_clap import htsat as t_htsat
from audiolcm_torch.models.open_clap import model as t_model
from audiolcm_torch.models.open_clap import text_towers as t_text
from audiolcm_torch.models.open_clap import tokenizer as t_tok
from audiolcm_tpu import config as j_cfg
from audiolcm_tpu.models import clap_text as j_clap
from audiolcm_tpu.models.open_clap import embedders as j_emb
from audiolcm_tpu.models.open_clap import htsat as j_htsat
from audiolcm_tpu.models.open_clap import model as j_model
from audiolcm_tpu.models.open_clap import text_towers as j_text
from audiolcm_tpu.models.open_clap import tokenizer as j_tok
from test_torch_open_clap import HTSAT_TINY, _audio_inputs
from test_torch_text import random_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

ROBERTA = dict(vocab_size=60, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
               max_position_embeddings=514)
BERT = dict(vocab_size=60, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
            max_position_embeddings=40)
BART = dict(vocab_size=60, d_model=16, num_layers=2, num_heads=2, ffn_dim=32,
            max_position_embeddings=40)
CLIP = dict(text_width=16, text_layers=2, text_heads=2, text_vocab=50)
TINY = {"roberta": (j_text.RobertaConfig, t_text.RobertaConfig, ROBERTA),
        "bert": (j_clap.BertConfig, t_clap.BertConfig, BERT),
        "bart": (j_text.BartConfig, t_text.BartConfig, BART)}
CAPTIONS = ["A dog barks loudly in the park!", "water flowing over rocks, then a splash...",
            "Hello world's 3 cats & dogs (2024)", "Café naïve — 東京の雨 🎵 résumé",
            "thunderstorm with heavy rain and WIND", "", "the quick brown fox, " * 20]


def _ids(seed: int, b: int, t: int, vocab: int = 60, pad: int = 1):
    """Ids in [3, vocab) with ragged padded tails (row 0 full), and the mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (b, t)).astype(np.int32)
    for row in range(1, b):
        ids[row, int(rng.integers(2, t)):] = pad
    return ids, (ids != pad).astype(np.int32)


def _init(module, seed: int, *args, method=None) -> dict:
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *map(jnp.asarray, args), method=method))
    return random_params(dict(shapes), seed)


def _patch_text_preset(monkeypatch, kind: str) -> dict:
    """Point JAX's OpenClap at a tiny tower; the port's text_config kwarg."""
    if kind not in TINY:
        return {}
    j_cls, t_cls, kw = TINY[kind]
    name = {"roberta": "RobertaConfig", "bert": "BertConfig", "bart": "BartConfig"}[kind]
    monkeypatch.setattr(j_model, name, lambda: j_cls(**kw))
    return {"text_config": t_cls(**kw)}


def _clap_cfgs(monkeypatch, kind: str, audio: bool, context_length: int = 12,
               text_vocab: int = 50):
    text = dict(CLIP, text_model_type=kind, context_length=context_length, joint_embed_shape=24,
                text_vocab=text_vocab)
    extra = _patch_text_preset(monkeypatch, kind)
    kw = dict(HTSAT_TINY, enable_fusion=True, fusion_type="aff_2d")
    return (j_model.OpenClapConfig(embed_dim=64, audio=j_htsat.HTSATConfig(**kw) if audio
                                   else None, **text),
            t_model.OpenClapConfig(embed_dim=64, audio=t_htsat.HTSATConfig(**kw) if audio
                                   else None, **text, **extra))


def _text_variables(jm, seed: int, ids, mask) -> dict:
    """Every text-side leaf of a JAX OpenClap: the tower, the projections,
    the transforms and the logit scales."""
    def touch(m, i, a):
        m.audio_transform(m.audio_projection(jnp.zeros((1, m.config.embed_dim))))
        return m.text_transform(m.encode_text(i, a))

    return _init(jm, seed, ids, mask, method=touch)


def test_roberta_encoder_padded():
    """RoBERTa's padding-aware positions and the mask bias: last hidden
    state and pooler."""
    ids, mask = _ids(0, 3, 16)
    jm = j_text.RobertaEncoder(j_text.RobertaConfig(**ROBERTA))
    v = _init(jm, 1, ids, mask)
    hidden, pooled = jm.apply(v, jnp.asarray(ids), jnp.asarray(mask))
    sd = {k[len("text_branch."):]: t for k, t in open_clap_from_jax(
        {"params": {"text_branch": v["params"]}}, t_model.OpenClapConfig()).items()}
    port = t_text.RobertaEncoder(t_text.RobertaConfig(**ROBERTA))
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        th, tp = port(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(th.numpy(), np.asarray(hidden), atol=2e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(pooled), atol=2e-5)


def test_clip_text_transformer():
    """The causal pre-LN tower and its EOT pooling; quick GELU too."""
    for quick in (False, True):
        ids = np.random.default_rng(2).integers(0, 50, (3, 12)).astype(np.int32)
        jm = j_text.ClipTextTransformer(width=16, layers=2, heads=2, vocab_size=50,
                                        context_length=12, quick_gelu=quick)
        v = _init(jm, 3, ids)
        golden = jm.apply(v, jnp.asarray(ids))
        cfg = t_model.OpenClapConfig(text_model_type="transformer")
        sd = {k[len("text_branch."):]: t for k, t in open_clap_from_jax(
            {"params": {"text_branch": v["params"]}}, cfg).items()}
        port = t_text.ClipTextTransformer(16, 2, 2, 50, 12, quick)
        port.load_state_dict(sd, strict=True)
        with torch.no_grad():
            out = port(torch.from_numpy(ids).long())
        np.testing.assert_allclose(out.numpy(), np.asarray(golden), atol=2e-5)
        np.testing.assert_allclose(
            t_text.clip_eot_features(out, torch.from_numpy(ids).long()).numpy(),
            np.asarray(j_text.clip_eot_features(golden, jnp.asarray(ids))), atol=2e-5)
    with pytest.raises(ValueError, match="context_length"):
        port(torch.zeros((1, 13), dtype=torch.long))


def test_bart_encoder_padded():
    ids, mask = _ids(4, 3, 12)
    jm = j_text.BartEncoder(j_text.BartConfig(**BART))
    v = _init(jm, 5, ids, mask)
    golden = jm.apply(v, jnp.asarray(ids), jnp.asarray(mask))
    cfg = t_model.OpenClapConfig(text_model_type="bart")
    sd = {k[len("text_branch."):]: t for k, t in open_clap_from_jax(
        {"params": {"text_branch": v["params"]}}, cfg).items()}
    port = t_text.BartEncoder(t_text.BartConfig(**BART))
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(golden), atol=2e-5)


@pytest.mark.parametrize("kind", ["roberta", "bert", "bart", "transformer"])
def test_open_clap_encode_text(monkeypatch, kind):
    """Each text branch of OpenClap with padded masks: the projected pooled
    feature (roberta's pooler, bert's CLS, bart's unmasked mean, the CLIP
    EOT), the unit text embedding and the per-token projection."""
    jcfg, tcfg = _clap_cfgs(monkeypatch, kind, audio=False)
    ids, mask = _ids(6, 3, 12, vocab=50)
    jm = j_model.OpenClap(jcfg)
    v = _text_variables(jm, 7, ids, mask)
    port = t_model.OpenClap(tcfg)
    port.load_state_dict(open_clap_from_jax(v, tcfg), strict=True)
    ji, jmask = jnp.asarray(ids), jnp.asarray(mask)
    ti, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    golden = [jm.apply(v, ji, jmask, method=jm.encode_text),
              jm.apply(v, ji, jmask, method=jm.get_text_embedding),
              jm.apply(v, jm.apply(v, ji, jmask, project=False, method=jm.encode_text),
                       method=jm.project_token_features)]
    with torch.no_grad():
        out = [port.encode_text(ti, tmask), port.get_text_embedding(ti, tmask),
               port.project_token_features(port.encode_text(ti, tmask, project=False))]
    for got, want in zip(out, golden):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_tokenizer_matches_jax():
    """Unicode, punctuation, an empty caption and one past 77 tokens."""
    ours = t_tok.tokenize(CAPTIONS, 77)
    assert ours.dtype == torch.long and ours.shape == (len(CAPTIONS), 77)
    np.testing.assert_array_equal(ours.numpy(), j_tok.tokenize(CAPTIONS, 77))
    assert ours[-1, -1] != 0  # truncated
    tk = t_tok.ClipBpeTokenizer()
    assert tk.vocab_size == 49408 and (tk.sot_id, tk.eot_id) == (49406, 49407)
    assert tk.decode(tk.encode("A dog barks loudly")).strip() == "a dog barks loudly"
    assert t_tok._VOCAB_GZ != j_tok._VOCAB_GZ  # the port's own copy


def _embedder_pair(monkeypatch, tmp_path, kind: str, seed: int) -> dict:
    """Patched create_model on both sides at tiny widths (context 77): JAX's
    returns the module; the port's loads the same variables, for roberta as
    a reference-layout checkpoint through the factory's strict loader (a
    transformer-branch checkpoint has no loader). -> JAX's variables
    without the audio side, for the JAX embedder's `params`."""
    # the transformer branch reads the BPE tokenizer's ids: CLIP's whole vocab
    jcfg, tcfg = _clap_cfgs(monkeypatch, kind, audio=True, context_length=77,
                            text_vocab=49408 if kind == "transformer" else 50)
    jm = j_model.OpenClap(jcfg)
    ids, mask = _ids(seed, 1, 12, vocab=50)
    inputs = _audio_inputs(seed, 16, 101, b=1)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        **{k: jnp.asarray(a) for k, a in inputs.items()}))
    v = random_params(dict(shapes), seed)
    sd = open_clap_from_jax(v, tcfg)
    path = str(tmp_path / "clap.pt")
    torch.save({"state_dict": {f"module.{k}": t for k, t in sd.items()}}, path)

    def port_create_model(amodel, tmodel, pretrained="", **kw):
        assert (amodel, tmodel, kw) == ("HTSAT-tiny", kind, dict(enable_fusion=True,
                                                                 fusion_type="aff_2d"))
        model = t_model.OpenClap(tcfg)
        if kind == "transformer":
            model.load_state_dict(sd, strict=True)
        else:
            t_factory.load_checkpoint(model, pretrained)
        return model, tcfg

    monkeypatch.setattr(j_emb, "create_model", lambda *a, **k: (jm, jcfg, None))
    monkeypatch.setattr(t_emb, "create_model", port_create_model)
    return {"params": {k: p for k, p in v["params"].items() if not k.startswith("audio")}}, path


def _laion_node(sentence_cls: bool, path: str, **params) -> dict:
    name = "FrozenLAIONCLAPSetenceEmbedder" if sentence_cls else "FrozenLAIONCLAPEmbedder"
    return {"target": f"ldm.modules.encoders.modules.{name}",
            "params": dict(weights_path=path, tokenizer_path="unused", **params)}


@pytest.mark.parametrize("sentence_cls,sentence,length", [(False, False, 77), (False, True, 77),
                                                          (True, True, 512)])
def test_laion_embedders_via_registry(monkeypatch, tmp_path, sentence_cls, sentence, length):
    """Both LAION targets through build_from_target (on the CPU, the audio
    side dropped), against JAX's `_build_laion_clap` embedders carried
    across: per-token (B, 77, 24) features and the unit sentence vector
    (B, 1, 24), the 512-token one through the mask with ragged tails; and
    `encode(texts)` through an assigned tokenizer hook."""
    v, path = _embedder_pair(monkeypatch, tmp_path, "roberta", seed=8)
    params = {} if sentence_cls else {"sentence": sentence, "max_length": length}
    node = _laion_node(sentence_cls, path, **params)
    ref, port = j_cfg.build_from_target(node), t_cfg.build_from_target(node)
    assert type(port).__name__ == type(ref).__name__
    assert port.model.audio_branch is None and port.model.audio_projection is None
    assert port.model.logit_scale_t.device.type == "cpu" and not port.model.training
    assert (port.sentence, port.max_length) == (ref.sentence, ref.max_length) == (sentence,
                                                                                    length)
    ref.params = v
    ids, mask = _ids(9, 3, length)
    golden = ref.encode_ids(jnp.asarray(ids), jnp.asarray(mask))
    out = port.encode_ids(torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.shape == golden.shape == ((3, 1, 24) if sentence else (3, length, 24))
    np.testing.assert_allclose(out.numpy(), np.asarray(golden), atol=2e-5)
    if sentence:
        np.testing.assert_allclose(np.linalg.norm(out.numpy()[:, 0], axis=-1), 1.0, atol=1e-5)

    ref._tokenizer = lambda texts, **kw: {"input_ids": ids[:len(texts)],
                                          "attention_mask": mask[:len(texts)]}
    port.tokenizer = lambda texts: (torch.from_numpy(ids[:len(texts)]),
                                    torch.from_numpy(mask[:len(texts)]))
    np.testing.assert_allclose(port.encode(CAPTIONS[:2]).numpy(),
                               np.asarray(ref.encode(CAPTIONS[:2])), atol=2e-5)


def test_laion_embedder_transformer_branch_encodes_texts(monkeypatch, tmp_path):
    """tmodel "transformer": `encode(texts)` tokenizes with the CLIP BPE
    tokenizer and passes no mask, end to end against JAX."""
    v, _ = _embedder_pair(monkeypatch, tmp_path, "transformer", seed=10)
    ref = j_emb.FrozenLAIONCLAPEmbedder(tmodel="transformer")
    ref.params = v
    port = t_emb.FrozenLAIONCLAPEmbedder(tmodel="transformer", device="cpu")
    out = port.encode(CAPTIONS)
    assert out.shape == (len(CAPTIONS), 77, 24)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.encode(CAPTIONS)), atol=2e-5)


def test_registry_laion_cond(monkeypatch, tmp_path):
    """parse_diffusion_config takes a LAION cond_stage_config: its spec
    builds the embedder; the CLAP-BERT and T5 towers raise ValueError."""
    _embedder_pair(monkeypatch, tmp_path, "roberta", seed=11)
    cfg = {"model": {"params": {
        "unet_config": {"target": "ldm.modules.diffusionmodules.concatDiT.ConcatDiT2MLP",
                        "params": {"in_channels": 4, "context_dim": 24, "hidden_size": 16,
                                   "depth": 1, "num_heads": 2}},
        "first_stage_config": {"target": "ldm.models.autoencoder1d.AutoencoderKL", "params": {
            "embed_dim": 4, "ddconfig": {"in_channels": 8, "out_ch": 8, "ch": 16,
                                         "ch_mult": [1], "num_res_blocks": 1,
                                         "z_channels": 4}}},
        "cond_stage_config": _laion_node(False, str(tmp_path / "clap.pt"), sentence=True)}}}
    sys_cfg = t_cfg.parse_diffusion_config(cfg)
    assert isinstance(sys_cfg.cond, t_cfg.LaionSpec)
    emb = sys_cfg.cond.build()
    assert isinstance(emb, t_emb.FrozenLAIONCLAPEmbedder) and emb.sentence
    assert emb.encode_ids(torch.from_numpy(_ids(12, 2, 77)[0])).shape == (2, 1, 24)
    for build in (sys_cfg.build_clap_text, sys_cfg.build_t5):
        with pytest.raises(ValueError, match="LAION"):
            build()

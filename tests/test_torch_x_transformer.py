"""Port parity: the lucidrains x_transformer zoo (audiolcm_torch.models.
x_transformer_zoo) against audiolcm_tpu.models.x_transformer_zoo, one case
per knob, f32 on the CPU.

Every parameter of the JAX wrapper is drawn from a numpy seed
(`random_params`: ReZero gates, memory keys and talking-heads mixes
included) and reaches the port through `xtransformer_from_jax`, in the
reference `TransformerWrapper` layout. atol 2e-5 (ROADMAP f32 bar), at
rtol 1e-5 where the output is logits (their scale is the vocabulary's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch.convert import assign_state_dict, xtransformer_from_jax
from audiolcm_torch.models import x_transformer_zoo as t_zoo
from audiolcm_tpu.models import x_transformer_zoo as j_zoo
from tests.test_torch_text import random_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

DIM, DEPTH, HEADS, DIM_HEAD = 32, 2, 4, 8
VOCAB, MAXLEN, B, N = 50, 12, 2, 9

# (id, encoder knobs, wrapper knobs, padding mask)
CASES = [
    ("vanilla", {}, {}, False),
    ("padding_mask", {}, {}, True),
    ("scalenorm", {"use_scalenorm": True}, {}, False),
    ("rmsnorm", {"use_rmsnorm": True}, {}, False),
    ("rezero", {"use_rezero": True}, {}, False),
    ("macaron", {"macaron": True}, {}, False),
    ("sandwich", {"sandwich_coef": 1}, {}, False),
    ("post_norm", {"pre_norm": False}, {}, False),
    ("custom_layers", {"custom_layers": ("a", "f", "f")}, {}, False),
    ("par_ratio", {"depth": 4, "par_ratio": 4}, {}, False),
    ("gate_residual", {"gate_residual": True}, {}, False),
    ("residual_attn", {"residual_attn": True}, {}, False),
    ("position_infused_attn", {"position_infused_attn": True}, {}, False),
    ("talking_heads", {"talking_heads": True}, {}, True),
    ("sparse_topk", {"sparse_topk": 4}, {}, False),
    ("mem_kv", {"num_mem_kv": 3}, {}, True),
    ("on_attn", {"on_attn": True}, {}, False),
    ("geglu", {"ff_glu": True}, {}, False),
    ("causal", {"causal": True}, {}, True),
    ("memory_tokens", {}, {"num_memory_tokens": 2}, True),
    ("emb_dim", {}, {"emb_dim": 24}, False),
    ("logits", {}, {"return_embeddings": False}, False),
    ("tied_logits", {}, {"return_embeddings": False, "tie_embedding": True}, False),
    ("combined", {"use_rmsnorm": True, "ff_glu": True, "talking_heads": True, "num_mem_kv": 2,
                  "gate_residual": True, "residual_attn": True, "causal": True}, {}, True),
]


def _mask() -> np.ndarray:
    mask = np.ones((B, N), dtype=bool)
    mask[0, 5:] = False
    mask[1, 7:] = False
    return mask


@pytest.mark.parametrize("enc_kw,wrap_kw,masked", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_wrapper_matches_jax(enc_kw, wrap_kw, masked):
    enc_kw = {"depth": DEPTH, **enc_kw}
    ids = np.random.default_rng(1).integers(0, VOCAB, (B, N)).astype(np.int32)
    mask = _mask() if masked else None
    jenc = j_zoo.XTransformerEncoder(dim=DIM, heads=HEADS, dim_head=DIM_HEAD, **enc_kw)
    jm = j_zoo.XTransformerWrapper(num_tokens=VOCAB, max_seq_len=MAXLEN, encoder=jenc, **wrap_kw)
    jmask = None if mask is None else jnp.asarray(mask)
    params = random_params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), mask=jmask))["params"], 2)
    golden = np.asarray(jm.apply({"params": params}, jnp.asarray(ids), mask=jmask))

    tenc = t_zoo.XTransformerEncoder(dim=DIM, heads=HEADS, dim_head=DIM_HEAD, **enc_kw)
    assert tenc.layer_types == jenc.layer_types
    port = assign_state_dict(
        t_zoo.XTransformerWrapper(VOCAB, MAXLEN, tenc, **wrap_kw).eval(),
        xtransformer_from_jax(params, tenc))
    with torch.no_grad():
        out = port(torch.from_numpy(ids), None if mask is None else torch.from_numpy(mask))
    assert out.shape == golden.shape and np.isfinite(golden).all()
    np.testing.assert_allclose(out.numpy(), golden, atol=2e-5,
                               rtol=1e-5 if not wrap_kw.get("return_embeddings", True) else 0)


@pytest.mark.parametrize("context_mask", [False, True])
def test_cross_attention_encoder_matches_jax(context_mask):
    """cross_attend with a context (and its padding mask) and
    cross_residual_attn, on the encoder alone (the wrapper passes no
    context)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, N, DIM)).astype(np.float32)
    ctx = rng.standard_normal((B, 5, DIM)).astype(np.float32)
    cmask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool) if context_mask else None
    kw = dict(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DIM_HEAD, cross_attend=True,
              cross_residual_attn=True)
    jenc = j_zoo.XTransformerEncoder(**kw)
    jargs = dict(context=jnp.asarray(ctx),
                 context_mask=None if cmask is None else jnp.asarray(cmask))
    params = random_params(jax.eval_shape(
        lambda: jenc.init(jax.random.PRNGKey(0), jnp.asarray(x), **jargs))["params"], 4)
    golden = jenc.apply({"params": params}, jnp.asarray(x), **jargs)
    tenc = t_zoo.XTransformerEncoder(**kw)
    wrapped = {"token_emb": np.zeros((1, DIM), np.float32), "encoder": params,
               "final_norm": {"scale": np.ones(DIM, np.float32),
                              "bias": np.zeros(DIM, np.float32)}}
    sd = {k[len("attn_layers."):]: v for k, v in xtransformer_from_jax(wrapped, tenc).items()
          if k.startswith("attn_layers.")}
    assign_state_dict(tenc, sd)
    with torch.no_grad():
        out = tenc(torch.from_numpy(x), context=torch.from_numpy(ctx),
                   context_mask=None if cmask is None else torch.from_numpy(cmask))
    assert tenc.layer_types == ("a", "c", "f") * DEPTH
    np.testing.assert_allclose(out.numpy(), np.asarray(golden), atol=2e-5)


def test_layer_types_match_jax():
    for kw in (dict(par_ratio=4), dict(par_ratio=3, cross_attend=True),
               dict(sandwich_coef=2, macaron=True), dict(cross_attend=True, only_cross=True)):
        assert t_zoo.compute_layer_types(6, **kw) == j_zoo.compute_layer_types(6, **kw)

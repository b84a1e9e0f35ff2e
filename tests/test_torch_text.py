"""Port parity: the CLAP-BERT + projection tower and the T5 encoder against
audiolcm_tpu.models (f32 CPU), with fuse_proj off and on. Parameters come
from a numpy seed, reach JAX directly (fused with the JAX package's
fuse_*_params when fuse_proj is on) and the port through convert.from_jax.
atol 2e-5 (ROADMAP f32 bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch.convert import assign_state_dict, clap_text_from_jax, t5_from_jax
from audiolcm_torch.models import clap_text as t_clap
from audiolcm_torch.models import t5_encoder as t_t5
from audiolcm_tpu.models import clap_text as j_clap
from audiolcm_tpu.models import t5_encoder as j_t5
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

BERT = dict(vocab_size=30, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
            max_position_embeddings=16)
T5 = dict(vocab_size=30, d_model=16, d_kv=8, d_ff=24, num_layers=2, num_heads=2)


def random_params(shapes, seed):
    """Matrices N(0, 1/fan_in), fan_in = all dims but the last (Dense
    (in, out), Conv (k, in, out)); vectors 1 + 0.1 N (norm scales, biases,
    log-scale snake parameters)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1])) if len(a.shape) > 1
                   else 1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), shapes)


def _ids(seed, b=2, t=11):
    return np.random.default_rng(seed).integers(0, 30, (b, t)).astype(np.int32)


@pytest.mark.parametrize("fuse", [False, True])
def test_clap_text_encoder(fuse):
    ids = _ids(0)
    jm = j_clap.ClapTextEncoder(j_clap.BertConfig(**BERT), d_proj=24)
    params = random_params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(ids)))["params"], 1)
    sd = clap_text_from_jax(params)
    if fuse:
        params = dict(params, bert=j_clap.fuse_bert_params(params["bert"]))
        jm = jm.clone(fuse_proj=True)
        sd = t_clap.fuse_bert_state_dict(clap_text_from_jax(params))
    golden = jm.apply({"params": params}, jnp.asarray(ids))
    port = assign_state_dict(t_clap.ClapTextEncoder(t_clap.BertConfig(**BERT), 24, fuse), sd)
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long())
    assert out.shape == (2, 11, 24)
    np.testing.assert_allclose(out.numpy(), np.asarray(golden), atol=2e-5)


@pytest.mark.parametrize("fuse", [False, True])
def test_t5_encoder(fuse):
    ids = _ids(2, t=40)  # > 16: exercises the logarithmic position buckets
    jm = j_t5.T5Encoder(j_t5.T5Config(**T5))
    params = random_params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(ids)))["params"], 3)
    sd = t5_from_jax(params)
    if fuse:
        params = j_t5.fuse_t5_params(params)
        jm = jm.clone(fuse_proj=True)
        sd = t_t5.fuse_t5_state_dict(t5_from_jax(params))
    golden = jm.apply({"params": params}, jnp.asarray(ids))
    port = assign_state_dict(t_t5.T5Encoder(t_t5.T5Config(**T5), fuse), sd)
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(golden), atol=2e-5)


def test_relative_position_buckets():
    np.testing.assert_array_equal(t_t5.relative_position_buckets(77, 77),
                                  j_t5.relative_position_buckets(77, 77))

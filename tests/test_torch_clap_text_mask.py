"""The attention mask of the port's text towers (`models/clap_text.py`
BertEncoder / ClapTextEncoder, `models/t5_encoder.py` T5Encoder), against
`audiolcm_tpu.models` with padded masks (f32 CPU, atol 2e-5), with fuse_proj
off and on. Without a mask the towers compute what they computed before
the mask existed, bit for bit: an all-ones mask adds -0.0 to every logit,
and `dot_product_attention` without a bias is the unmasked formula.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolcm_torch.convert import assign_state_dict, clap_text_from_jax, t5_from_jax
from audiolcm_torch.models import clap_text as t_clap
from audiolcm_torch.models import t5_encoder as t_t5
from audiolcm_torch.nn.attention import dot_product_attention, padding_bias
from audiolcm_tpu.models import clap_text as j_clap
from audiolcm_tpu.models import t5_encoder as j_t5
from test_torch_text import BERT, T5, random_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)


def _padded(seed: int, b: int = 3, t: int = 13):
    """Ids with ragged zero-padded tails (row 0 full) and their 1/0 mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 30, (b, t)).astype(np.int32)
    lengths = [t] + [int(n) for n in rng.integers(3, t, b - 1)]
    mask = (np.arange(t)[None] < np.array(lengths)[:, None]).astype(np.int32)
    return ids * mask, mask, lengths


def _clap_pair(fuse: bool, seed: int):
    ids = _padded(0)[0]
    jm = j_clap.ClapTextEncoder(j_clap.BertConfig(**BERT), d_proj=24)
    params = random_params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(ids)))["params"], seed)
    sd = clap_text_from_jax(params)
    if fuse:
        params = dict(params, bert=j_clap.fuse_bert_params(params["bert"]))
        jm = jm.clone(fuse_proj=True)
        sd = t_clap.fuse_bert_state_dict(sd)
    port = assign_state_dict(t_clap.ClapTextEncoder(t_clap.BertConfig(**BERT), 24, fuse), sd)
    return jm, params, port


def _t5_pair(fuse: bool, seed: int):
    ids = _padded(0)[0]
    jm = j_t5.T5Encoder(j_t5.T5Config(**T5))
    params = random_params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(ids)))["params"], seed)
    sd = t5_from_jax(params)
    if fuse:
        params = j_t5.fuse_t5_params(params)
        jm = jm.clone(fuse_proj=True)
        sd = t_t5.fuse_t5_state_dict(sd)
    return jm, params, assign_state_dict(t_t5.T5Encoder(t_t5.T5Config(**T5), fuse), sd)


def _towers(fuse: bool):
    """(name, JAX module, its params, port module, port callable) for the
    three masked towers: BertEncoder (the CLAP tower's base), ClapTextEncoder
    and T5Encoder."""
    jc, pc, tc = _clap_pair(fuse, 1)
    jt, pt, tt = _t5_pair(fuse, 2)
    bert_j = j_clap.BertEncoder(j_clap.BertConfig(**BERT), fuse_proj=fuse)
    return [("bert", bert_j, pc["bert"], tc.base), ("clap", jc, pc, tc), ("t5", jt, pt, tt)]


@pytest.mark.parametrize("fuse", [False, True])
def test_padded_mask_matches_jax(fuse):
    ids, mask, _ = _padded(3)
    for name, jm, params, port in _towers(fuse):
        golden = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
        with torch.no_grad():
            out = port(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        np.testing.assert_allclose(out.numpy(), np.asarray(golden), atol=2e-5, err_msg=name)
        unmasked = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)))
        assert np.abs(unmasked - np.asarray(golden)).max() > 1e-3, name  # the mask matters


@pytest.mark.parametrize("fuse", [False, True])
def test_mask_hides_the_padding(fuse):
    """A padded row's tokens encode as the row cut to its length alone."""
    ids, mask, lengths = _padded(4)
    for name, _, _, port in _towers(fuse):
        with torch.no_grad():
            out = port(torch.from_numpy(ids).long(), torch.from_numpy(mask))
            for row, n in enumerate(lengths):
                alone = port(torch.from_numpy(ids[row:row + 1, :n]).long())
                np.testing.assert_allclose(out[row, :n].numpy(), alone[0].numpy(), atol=1e-5,
                                           err_msg=name)


@pytest.mark.parametrize("fuse", [False, True])
def test_no_mask_is_bit_identical(fuse):
    ids = _padded(5)[0]
    for name, _, _, port in _towers(fuse):
        with torch.no_grad():
            bare = port(torch.from_numpy(ids).long())
            ones = port(torch.from_numpy(ids).long(), torch.ones(ids.shape, dtype=torch.long))
        assert torch.equal(bare, ones), name
    q, k, v = torch.randn((3, 2, 2, 7, 8), generator=torch.Generator().manual_seed(6))
    before = torch.matmul(torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * 0.35, -1), v)
    assert torch.equal(dot_product_attention(q, k, v, 0.35), before)
    assert torch.equal(dot_product_attention(q, k, v, 0.35, padding_bias(None)), before)

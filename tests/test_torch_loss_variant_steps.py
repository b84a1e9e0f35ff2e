"""Port parity of the PatchGAN-only VAE loss variants' steps (mask, vq) and
of a step with LPAPS as the perceptual term, against audiolcm_tpu: the
cases of `test_torch_loss_variants.py:check_variant_step` that do not fit
beside the multi-window ones in one file's time (JAX traces each variant's
double-grad step for ~10 s). Same sizes, draws and bars as there.
"""

import pytest

from test_torch_loss_variants import check_variant_step, vae_init  # noqa: F401  (fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)


@pytest.mark.parametrize("variant,step0,perceptual", [
    (v, s, False) for v in ("mask", "vq") for s in (0, 5)] + [("vq", 5, True)])
def test_variant_steps_match_jax(vae_init, monkeypatch, variant, step0, perceptual):  # noqa: F811
    """mask (padded frames put back to pad_value before the PatchGAN) and
    vq (mean L1, no KL, a codebook loss), each before and past disc_start;
    then vq with LPAPS at perceptual_weight 0.5 past disc_start."""
    check_variant_step(vae_init, monkeypatch, variant, step0, perceptual)

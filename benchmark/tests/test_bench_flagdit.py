"""The Flag-DiT teacher's yardstick and layout on the CPU: the FLOP of a
TxtFlagLargeDiT forward against torch's FLOP counter over the plain
reference, K3's bound for one self and one cross shape by hand, the
roofline reader over a stand-in trace, and the reference layout against
the port's module."""

import copy
import json

import pytest
import torch

from benchmark import run
from benchmark.harness import spec, work_flagdit
from benchmark.harness.rehearsal import tiny
from benchmark.harness.trace import Trace
from benchmark.reference import flag_dit

CELL = "flagdit2b_b8_ddim100"


def _config() -> dict:
    cell = spec.load_cell(CELL)
    return tiny(cell.config, cell.traffic)[0]


def _dit_config(**change) -> dict:
    c = copy.deepcopy(_config()["dit"])
    c.update(depth=2, **change)
    return c


def _draw(c: dict, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=g) * 0.2 for k, s in flag_dit.layout(c)}


@pytest.mark.parametrize("change", [{}, {"n_kv_heads": 2}, {"qk_norm": False}],
                         ids=["full-heads", "grouped-kv", "no-qk-norm"])
def test_flag_dit_flop_match_the_flop_counter_over_the_reference(change):
    from torch.utils.flop_counter import FlopCounterMode

    c = _dit_config(**change)
    b, latent, ctx_tokens = 3, 11, 7
    x = torch.randn(b, latent, c["in_channels"])
    t = torch.tensor([1, 500, 999])
    ctx = torch.randn(b, ctx_tokens, c["context_dim"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        flag_dit.dit(_draw(c), c, x, t, ctx)
    assert counter.get_total_flops() == work_flagdit.flag_dit_flop(c, b, latent, ctx_tokens)


def test_request_flop_is_the_shared_models_and_the_guided_flag_forwards():
    from benchmark.harness import work

    config = spec.load_cell(CELL).config
    dit = (100 * work_flagdit.flag_dit_flop(config["dit"], 16, 312, 154)
           - 99 * work_flagdit.caption_flop(config["dit"], 16, 154))
    shared = (work.text_flop(config, 8, 77) + work.text_flop(config, 1, 77)
              + work.vae_decode_flop(config["vae"], 8, 312)
              + work.vocoder_flop(config["vocoder"], 8, 624))
    assert work_flagdit.request_flop(config, 8, 624, 77) == dit + shared
    # the published widths: ~16.4-17 TFLOP per guided forward, of which ~0.56 the
    # caption's; the DiT > 90 % of the request
    forward = work_flagdit.flag_dit_flop(config["dit"], 16, 312, 154)
    assert 16e12 < forward < 17.5e12 and dit > 0.9 * (dit + shared)
    assert 0.5e12 < work_flagdit.caption_flop(config["dit"], 16, 154) < 0.6e12


@pytest.mark.parametrize("change", [{}, {"n_kv_heads": 2}], ids=["full-heads", "grouped-kv"])
def test_caption_flop_is_what_the_ports_caption_memo_saves(change):
    """Inside `caption_memo` the port's second forward over the same caption
    counts flag_dit_flop less caption_flop; the first counts flag_dit_flop."""
    from torch.utils.flop_counter import FlopCounterMode

    from audiolcm_torch.models.flag_dit import TxtFlagLargeDiT

    c = _dit_config(**change)
    b, latent, ctx_tokens = 3, 11, 7
    m = TxtFlagLargeDiT(**{k: v for k, v in c.items() if k != "target"}, use_flash=True).eval()
    x, t = torch.randn(b, latent, c["in_channels"]), torch.tensor([1, 500, 999])
    ctx = torch.randn(b, ctx_tokens, c["context_dim"])
    counts = []
    with torch.no_grad(), m.caption_memo():
        for _ in range(2):
            with FlopCounterMode(display=False) as counter:
                m(x, t, ctx)
            counts.append(counter.get_total_flops())
    full = work_flagdit.flag_dit_flop(c, b, latent, ctx_tokens)
    assert counts[0] == full
    assert counts[1] == full - work_flagdit.caption_flop(c, b, ctx_tokens)


def test_k3_bound_for_a_self_and_a_cross_shape_by_hand():
    """(16, 32, 312 -> 312, 72) and (16, 32, 312 -> 154, 72) in bf16: both
    bound by their bytes (q, out at T = 312; k, v at Tk), not by 4 B H T Tk D
    FLOP at 989 TFLOP/s."""
    self_bytes = 2 * 16 * 32 * 72 * (312 + 312 + 312 + 312)
    cross_bytes = 2 * 16 * 32 * 72 * (312 + 154 + 154 + 312)
    assert self_bytes / 3.35e12 > 4 * 16 * 32 * 312 * 312 * 72 / 989e12
    assert cross_bytes / 3.35e12 > 4 * 16 * 32 * 312 * 154 * 72 / 989e12
    assert work_flagdit.k3_bound_s(16, 32, 312, 312, 72) == self_bytes / 3.35e12
    assert work_flagdit.k3_bound_s(16, 32, 312, 154, 72) == cross_bytes / 3.35e12
    config = spec.load_cell(CELL).config
    assert work_flagdit.attention_bound_s(config, 8, 624, 77) == pytest.approx(
        100 * 24 * (self_bytes + cross_bytes) / 3.35e12)


def test_k3_roofline_reads_the_bound_over_the_flash_kernels_time():
    cell = spec.load_cell(CELL)
    traffic = json.loads(json.dumps(cell.traffic))
    from benchmark.harness.traffic import request

    traced = [request(traffic, cell.config, 3, i) for i in range(2)]
    trace = Trace(requests=2, window_s=10.0, busy_s=9.0, gaps=[],
                  ops=[("void flash_attention_tc_kernel<9, true>(FlashArgs)", 0.0, 0.4),
                       ("gemm", 0.4, 5.0), ("void flash_attention_tc_kernel<9, true>", 5.0, 5.6)])
    r = run.Readings(cell.config, traffic, 1.0, 1.0, [], [], trace=trace, traced=traced)
    reader = spec.load_metric("k3_roofline.flag")
    bound = 2 * work_flagdit.attention_bound_s(cell.config, 8, 624, 77)
    assert reader.read(r) == pytest.approx(100 * bound / 1.0)
    assert reader.read(run.Readings(cell.config, traffic, 1.0, 1.0, [], [])) is None


@pytest.mark.parametrize("change", [{}, {"n_kv_heads": 2}, {"qk_norm": False}],
                         ids=["full-heads", "grouped-kv", "no-qk-norm"])
def test_reference_layout_is_what_the_port_builds(change):
    from audiolcm_torch.models.flag_dit import TxtFlagLargeDiT

    c = _dit_config(**change)
    port = TxtFlagLargeDiT(**{k: v for k, v in c.items() if k != "target"})
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == dict(flag_dit.layout(c))


def test_ffn_hidden_at_the_published_width():
    """8d/3 at d = 2304 is 6144, already a multiple of 256 (the 2B preset's)."""
    assert flag_dit.ffn_hidden(spec.load_cell(CELL).config["dit"]) == 6144

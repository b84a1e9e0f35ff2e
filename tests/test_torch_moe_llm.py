"""The caption LLM (a DeepSeek-V3-family MoE decoder, `models/moe_llm.py`)
and its expert kernel K7 (`nn/moe_experts.py`), against the benchmark's
plain reference (`benchmark/reference/moe_llm.py`) in f32 on the CPU, at
tiny widths: one dense and one expert layer, 8 experts top-2, one shared.

- the port's tower (built on the meta device, the reference layout
  assigned) against the reference's forward;
- the graph-safe dispatch and K7's walk over it against the plain
  per-expert loop, with an expert that gets no token and one that gets all;
- the three-tower LCM generate through `AudioLCMPipeline.generate` against
  the reference's, on the benchmark's weights, ids and draws;
- the reference layout loading into the port.

On the card (`-m gpu`): K7 against the plain loop at the published widths
(2048 / 1408, 64 experts, 128 and 1024 tokens), its mean error against the
f32 walk at most 1.02x the plain bf16 loop's, and a captured replay equal
to the eager call.
"""

import json
from pathlib import Path

import pytest
import torch

from audiolcm_torch import obs
from audiolcm_torch.aot import graph_key
from audiolcm_torch.models.dit import ConcatDiT2MLP
from audiolcm_torch.models.moe_llm import MoELLM, MoELLMConfig
from audiolcm_torch.nn import moe_experts
from benchmark.drivers import generate_moonlight as drv
from benchmark.harness.rehearsal import tiny
from benchmark.reference import moe_llm as ref
from benchmark.reference import samplers
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

ROOT = Path(__file__).resolve().parents[1]
STATES_ATOL = 1e-5  # f32 against f32: reassociation only, states of unit scale
REL_L2 = 1e-4  # the whole generate in f32: the benchmark rehearsal's scale
BF16_BAR = 1.02  # a bf16 kernel's mean error against f32, over the plain bf16 path's


def _full_config() -> dict:
    return json.loads((ROOT / "benchmark/configs/audiolcm_moonlight16b.json").read_text())


def _tiny_config() -> dict:
    """The benchmark's configuration at the rehearsal's widths, the tower at
    the driver's TINY_LLM (2 layers: one dense, one of 8 experts top-2)."""
    c = _full_config()
    t = json.loads((ROOT / "benchmark/traffic/b1_10s_moonlight.json").read_text())
    return drv.tiny_llm(tiny(c, t)[0])


def _draw(layout, seed: int = 0, scale: float = 0.3) -> dict:
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, s in layout:
        t = torch.randn(s, generator=g) * scale
        out[k] = t + 1.0 if k.endswith("norm.weight") or "layernorm" in k else t
    return out


def _tower(c: dict, sd: dict) -> MoELLM:
    with torch.device("meta"):
        m = MoELLM(MoELLMConfig.from_dict(c))
    m.load_state_dict(sd, strict=True, assign=True)
    return m.eval()


@pytest.mark.parametrize("change", [{}, {"n_group": 2, "topk_group": 1}, {"num_hidden_layers": 3}],
                         ids=["moonlight", "group-limited", "two-expert-layers"])
def test_tower_states_match_the_reference_in_f32(change):
    c = dict(_tiny_config(), **change)
    sd = _draw(ref.layout(c))
    ids = torch.randint(0, c["vocab_size"], (2, 11), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = _tower(c, sd)(ids)
        routes = []
        want = ref.forward(sd, c, ids, routes=routes)
    assert got.shape == (2, 11, c["hidden_size"])
    torch.testing.assert_close(got, want, atol=STATES_ATOL, rtol=0)
    assert len(routes) == sum(ref.is_moe(c, i) for i in range(c["num_hidden_layers"]))


def test_reference_layout_is_what_the_port_loads():
    c = _tiny_config()
    with torch.device("meta"):
        m = MoELLM(MoELLMConfig.from_dict(c))
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == dict(ref.layout(c))
    dc = c["dit"]
    dit = ConcatDiT2MLP(**{k: dc[k] for k in ("in_channels", "context_dim", "hidden_size",
                                              "depth", "num_heads", "max_len",
                                              "llm_context_dim")})
    assert {k: tuple(v.shape) for k, v in dit.state_dict().items()} == dict(ref.dit_layout(dc))


def test_published_widths_count_15_62_billion_parameters():
    c = _full_config()
    n = sum(torch.Size(s).numel() for _, s in ref.layout(c))
    with torch.device("meta"):
        assert n == sum(p.numel() for p in MoELLM(MoELLMConfig.from_dict(c)).state_dict().values())
    assert 15.61e9 < n < 15.63e9


def _routing(t: int, k: int, e: int, seed: int):
    """idx (t, k) with expert 0 chosen by every token, expert e-1 by none,
    the rest drawn; weights > 0."""
    g = torch.Generator().manual_seed(seed)
    rest = torch.stack([torch.randperm(e - 2, generator=g)[:k - 1] + 1 for _ in range(t)])
    idx = torch.cat([torch.zeros(t, 1, dtype=torch.int64), rest], dim=1)
    return idx, torch.rand(t, k, generator=g) + 0.1


def test_dispatch_sorts_every_assignment_by_expert_in_token_order():
    t, k, e = 9, 3, 6
    idx, _ = _routing(t, k, e, 0)
    tok, pos, offsets = moe_experts.dispatch(idx, e)
    assert offsets.tolist()[0] == 0 and offsets.tolist()[-1] == t * k
    assert offsets[1] - offsets[0] == t and offsets[e] - offsets[e - 1] == 0
    assert sorted(pos.reshape(-1).tolist()) == list(range(t * k))  # every row, none dropped
    order = torch.empty(t * k, dtype=torch.int64).scatter_(0, pos.reshape(-1).long(),
                                                           torch.arange(t * k))
    flat = idx.reshape(-1)
    for x in range(e):
        rows = order[offsets[x]:offsets[x + 1]]
        assert (flat[rows] == x).all()
        assert rows.tolist() == sorted(rows.tolist())  # stable: in token order
    assert (tok == order // k).all()


@pytest.mark.parametrize("t", [1, 7], ids=["one-token", "seven-tokens"])
def test_k7_walk_over_the_dispatch_matches_the_plain_loop(t):
    k, e, d, inter = 2, 8, 32, 16
    g = torch.Generator().manual_seed(t)
    x, res, shared = (torch.randn(t, d, generator=g) for _ in range(3))
    stacked = (torch.randn(e, inter, d, generator=g) * d ** -0.5,
               torch.randn(e, inter, d, generator=g) * d ** -0.5,
               torch.randn(e, d, inter, generator=g) * inter ** -0.5)
    idx, w = _routing(t, k, e, t)
    got = moe_experts.routed_experts_walk(x, idx, w, stacked, res, shared)
    plain = moe_experts.routed_experts_plain(x, idx, w, list(zip(*stacked)))
    torch.testing.assert_close(got, res + shared + plain, atol=1e-5, rtol=1e-5)


def test_stack_is_a_view_of_back_to_back_weights_and_one_copy_otherwise():
    flat = torch.randn(3 * 4 * 5)
    lins = [torch.nn.Linear(5, 4, bias=False) for _ in range(3)]
    for i, m in enumerate(lins):
        m.weight = torch.nn.Parameter(flat[i * 20:(i + 1) * 20].view(4, 5))
    view = moe_experts.stack(lins)
    assert view.data_ptr() == flat.data_ptr() and view.shape == (3, 4, 5)
    apart = [torch.nn.Linear(5, 4, bias=False) for _ in range(3)]
    copy_ = moe_experts.stack(apart)
    assert all(m.weight.data_ptr() == copy_[i].data_ptr() for i, m in enumerate(apart))


def _pipeline(c: dict, seed: int = 3):
    sds = drv.make_state_dicts(c, seed, torch.device("cpu"), torch.float32)
    modules = drv.build_modules(c, torch.device("cpu"))
    return drv.build_pipeline(c, modules, sds, torch.device("cpu")), sds


def test_three_tower_generate_matches_the_reference_in_f32():
    c = _tiny_config()
    pipe, sds = _pipeline(c)
    g = torch.Generator().manual_seed(4)
    clap = torch.randint(0, c["clap_text"]["vocab_size"], (1, 77), generator=g)
    t5 = torch.randint(0, c["t5"]["vocab_size"], (1, 77), generator=g)
    llm = torch.randint(0, c["vocab_size"], (1, 128), generator=g)
    latent = 20
    x_t, noise = samplers.draws(torch.Generator().manual_seed(5), (1, latent, 20), 1, "cpu")
    wav, mel = pipe.generate(clap, t5, latent, x_T=x_t, noise=torch.stack(noise), llm_ids=llm)
    with torch.no_grad():
        ref_wav, ref_mel = ref.generate(sds, c, clap, t5, llm, x_t, noise)
    rel = lambda a, b: float((a - b).norm() / b.norm())
    assert rel(mel, ref_mel) < REL_L2 and rel(wav, ref_wav) < REL_L2
    # the tower's states reach the mel: other LLM ids, another mel
    other, _ = pipe.generate(clap, t5, latent, x_T=x_t, noise=torch.stack(noise),
                             llm_ids=(llm + 1) % c["vocab_size"])
    assert rel(other, wav) > 1e-3


def test_pipeline_without_the_tower_keeps_its_graph_key_and_refuses_llm_ids():
    clap, t5 = torch.zeros(8, 77, dtype=torch.int64), torch.zeros(8, 77, dtype=torch.int64)
    assert graph_key(clap, t5, 312) == ((8, 77), (8, 77), "int64", "int64", 312)
    assert graph_key(clap, t5, 312, torch.zeros(8, 128, dtype=torch.int64))[5:] == \
        ((8, 128), "int64")
    c = _tiny_config()
    pipe, _ = _pipeline(c)
    with pytest.raises(ValueError, match="llm_ids"):
        pipe.generate(clap[:1], t5[:1], 8)
    pipe.modules.llm = None
    with pytest.raises(ValueError, match="llm_ids"):
        pipe.generate(clap[:1], t5[:1], 8, llm_ids=torch.zeros(1, 4, dtype=torch.int64))


# ----------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest -m gpu tests/test_torch_moe_llm.py)")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("tokens", [128, 1024])
def test_k7_matches_the_plain_loop_and_replays_on_card(cuda_device, tokens):
    """Moonlight's widths: 64 experts of 2048 -> 1408, top 6."""
    e, k, d, inter = 64, 6, 2048, 1408
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(tokens)
    x, res, shared = (torch.randn(tokens, d, generator=g, device=dev).bfloat16()
                      for _ in range(3))
    stacked = tuple(t.bfloat16().contiguous() for t in (
        torch.randn(e, inter, d, generator=g, device=dev) * d ** -0.5,
        torch.randn(e, inter, d, generator=g, device=dev) * d ** -0.5,
        torch.randn(e, d, inter, generator=g, device=dev) * inter ** -0.5))
    scores = torch.rand(tokens, e, generator=g, device=dev)
    idx = scores.topk(k, dim=-1)[1]
    w = scores.gather(1, idx)
    before = obs.counters().get(moe_experts.COUNTER, 0)
    with torch.inference_mode():
        got = moe_experts.routed_experts(x, idx, w, stacked, res, shared)
        torch.cuda.synchronize()
        assert obs.counters().get(moe_experts.COUNTER, 0) - before == 4
        for want, have in zip(moe_experts.dispatch(idx, e), moe_experts.dispatch_on_card(idx, e)):
            assert torch.equal(want.int(), have)
        gold = moe_experts.routed_experts_walk(x.float(), idx, w, tuple(t.float() for t in stacked),
                                               res.float(), shared.float())
        plain = res + (moe_experts.routed_experts_plain(x, idx, w, list(zip(*stacked)))
                       .bfloat16() + shared)
        err = (got.float() - gold).abs().mean().item()
        err_plain = (plain.float() - gold).abs().mean().item()
        assert err <= BF16_BAR * err_plain, (err, err_plain)
        # a captured replay gives the eager result, bit for bit
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            moe_experts.routed_experts(x, idx, w, stacked, res, shared)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = moe_experts.routed_experts(x, idx, w, stacked, res, shared)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, got)


def test_chip_smoke_k7_phases_rehearse_on_the_cpu():
    """chip_smoke's K7 phases in their CPU rehearsal: K7's walk against the
    plain loop in f32 under even and uneven routing, and the three-tower
    generate at tiny widths with no kernel launched."""
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    cpu = torch.device("cpu")
    card = chip_smoke.card_phase(cpu)
    rows = chip_smoke.moe_kernel_phase(cpu, True, card)
    assert {(r["tokens"], r["skew"]) for r in rows} == {
        (t, s) for t in (9, 40) for s in (0.0, chip_smoke.MOE_SKEW)}
    row = chip_smoke.moonlight_generate_phase(cpu, False, card)
    assert row["wav_shape"] == [1, 256 * row["mel"]]
    assert chip_smoke.moe_row(rows, row)["launches"] == "not measured"

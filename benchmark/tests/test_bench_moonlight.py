"""The caption-LLM configuration's yardstick and readers on the CPU: the
FLOP of the Moonlight tower and of the three-embedder DiT against torch's
FLOP counter over the plain reference, K7's bound by hand, the per-layer
readers over stand-in readings, the draw's alignment, and the rehearsal's
tower widths.

On the card (`-m card`), at the published widths on the benchmark's
weights:
- the bf16 tower through the port (K7) against the f32 reference, under
  the cell's fan-in init and under HF's `initializer_range` 0.02: the final
  states' relative L2 distance and the share of top-6 choices that differ,
  printed (PERF.md section 6 has them);
- each layer of the port against the reference's same layer on the port's
  own input to it: attention, router and MLP apart, the routed experts
  (K7) on the reference's routes, each held to bf16's rounding, and two
  planted faults of the expert layer shown to break that bar;
- the cell's own check (`harness/check.py`) on a few requests: it passes
  the port; printed, how it reads a port whose router drops
  `routed_scaling_factor` and a reference whose tower alone runs in the
  fp8 control's arithmetic."""

import json

import pytest
import torch

from benchmark import run
from benchmark.drivers import generate_moonlight as drv
from benchmark.harness import spec, work, work_moe
from benchmark.harness.rehearsal import tiny
from benchmark.harness.trace import Trace
from benchmark.harness.traffic import request
from benchmark.reference import moe_llm

CELL = "moonlight_lcm_b1_10s"


def _cell():
    return spec.load_cell(CELL)


def _tiny() -> dict:
    cell = _cell()
    return drv.tiny_llm(tiny(cell.config, cell.traffic)[0])


def _draw(layout, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=g) * 0.2 for k, s in layout}


def test_llm_flop_by_hand_at_the_published_widths():
    """Per token and layer: MLA's projections 2048 x (3072 + 576) + 512 x
    4096 + 2048 x 2048, scores and values 128 x 16 x (192 + 128); layer 0's
    SwiGLU 3 x 2048 x 11264; 26 expert layers of router 2048 x 64 and
    (6 + 2) SwiGLUs 3 x 2048 x 1408."""
    c = _cell().config
    attn = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048 + 128 * 16 * 320
    macs = 27 * attn + 3 * 2048 * 11264 + 26 * (2048 * 64 + 8 * 3 * 2048 * 1408)
    assert work_moe.llm_flop(c, 1, 128) == 2.0 * 128 * macs
    assert 0.55e12 < work_moe.llm_flop(c, 1, 128) < 0.6e12


@pytest.mark.parametrize("change", [{}, {"num_hidden_layers": 3, "first_k_dense_replace": 2}],
                         ids=["dense-then-moe", "two-dense"])
def test_llm_flop_match_the_flop_counter_over_the_reference(change):
    from torch.utils.flop_counter import FlopCounterMode

    c = dict(_tiny(), **change)
    ids = torch.randint(0, c["vocab_size"], (2, 9))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        moe_llm.forward(_draw(moe_llm.layout(c)), c, ids)
    # the counter counts each routed expert's products over the tokens it got:
    # num_experts_per_tok per token in all
    assert counter.get_total_flops() == work_moe.llm_flop(c, 2, 9)


def test_dit_flop_match_the_flop_counter_over_the_reference():
    from torch.utils.flop_counter import FlopCounterMode

    c = _tiny()
    dc = c["dit"]
    b, latent, tok, llm_tok = 2, 11, 5, 7
    x = torch.randn(b, latent, dc["in_channels"])
    ctx, llm = torch.randn(b, 2 * tok, dc["context_dim"]), torch.randn(b, llm_tok,
                                                                        dc["llm_context_dim"])
    w_emb = torch.randn(b, 256)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        moe_llm.dit(_draw(moe_llm.dit_layout(dc)), dc, x, torch.tensor([1, 999]), ctx, llm, w_emb)
    assert counter.get_total_flops() == work_moe.dit_flop(dc, b, latent, tok, llm_tok)


def test_request_flop_is_the_shared_models_the_tower_and_two_dit_steps():
    c = _cell().config
    shared = (work.text_flop(c, 1, 77) + work.vae_decode_flop(c["vae"], 1, 312)
              + work.vocoder_flop(c["vocoder"], 1, 624))
    dit = 2 * work_moe.dit_flop(c["dit"], 1, 312, 77, 128)
    assert work_moe.request_flop(c, 1, 624, 77, 128) == (
        shared + dit + work_moe.llm_flop(c, 1, 128))


def test_k7_bound_by_hand():
    """128 tokens: 26 layers x (64 x 3 x 2048 x 1408 weights + 4 x 128 x
    2048 activations) x 2 bytes at 3.35 TB/s, ~8.6 ms; the FLOP, 26 x 2 x
    768 x 3 x 2048 x 1408, take ~0.35 ms at 989 TFLOP/s."""
    c = _cell().config
    byts = 26 * 2 * (64 * 3 * 2048 * 1408 + 4 * 128 * 2048)
    assert work_moe.k7_bytes(c, 128) == byts
    assert work_moe.k7_flop(c, 128) == 26 * 2.0 * 768 * 3 * 2048 * 1408
    assert work_moe.k7_bound_s(c, 128) == byts / 3.35e12
    assert 8.5e-3 < work_moe.k7_bound_s(c, 128) < 8.7e-3


def test_the_draw_aligns_every_tensor_and_keeps_each_layers_experts_back_to_back():
    """Each tensor of the draw starts at a multiple of 64 elements, as a
    loaded checkpoint's do, and a layer's experts of one projection lie back
    to back, so that K7 stacks them as views."""
    from audiolcm_torch.nn import moe_experts

    c = _tiny()
    sds = drv.make_state_dicts(c, 3, torch.device("cpu"), torch.bfloat16)
    assert all(t.storage_offset() % drv.ALIGN == 0 for sd in sds.values() for t in sd.values())
    m = "model.layers.1.mlp.experts"
    for proj in ("gate_proj", "up_proj", "down_proj"):
        assert moe_experts._back_to_back([sds["llm"][f"{m}.{e}.{proj}.weight"]
                                          for e in range(c["n_routed_experts"])])


def _readings(trace=None, n=2):
    cell = _cell()
    traced = [request(cell.traffic, cell.config, 3, i) for i in range(n)]
    return run.Readings(cell.config, cell.traffic, 1.0, 2.0,
                        [(q, 0.03) for q in traced], [], trace=trace, traced=traced)


def test_k7_roofline_reads_the_bound_over_k7s_kernels_time():
    """Every kernel whose name starts with k7_ counts, the dispatch too; a
    kernel that only holds k7_ elsewhere in its name does not."""
    trace = Trace(requests=2, window_s=1.0, busy_s=0.9, gaps=[],
                  ops=[("k7_dispatch", 0.0, 0.002), ("k7_gate_up", 0.002, 0.012),
                       ("nvjet_gemm", 0.012, 0.02), ("conv_k7_stride1", 0.02, 0.021),
                       ("k7_down", 0.021, 0.025), ("k7_combine", 0.025, 0.026)])
    cfg = _cell().config
    got = spec.load_metric("k7_roofline.moon").read(_readings(trace))
    assert got == pytest.approx(100 * 2 * work_moe.k7_bound_s(cfg, 128) / 0.017)
    assert spec.load_metric("k7_roofline.moon").read(_readings()) is None


def test_gen_mfu_reads_the_windows_flop_at_the_peak():
    cfg = _cell().config
    r = _readings()
    want = 100 * 2 * work_moe.request_flop(cfg, 1, 624, 77, 128) / 2.0 / 989e12
    assert spec.load_metric("gen_mfu.moon").read(r) == pytest.approx(want)


def test_span_readers_find_nothing_without_the_windows_requests():
    """Run after other runs in one process: the recorder's requests are not
    this stand-in window's, so the readers return None and do not raise."""
    from audiolcm_torch import obs

    obs.reset()
    for name in ("llm_dev_ms.moon", "k7_launches.moon"):
        assert spec.load_metric(name).read(_readings()) is None


def test_the_mix_and_the_cell_at_the_published_widths():
    cell = _cell()
    assert (cell.traffic["batch"], cell.traffic["mel_lens"], cell.traffic["tokens"],
            cell.traffic["llm_tokens"]) == (1, [624], 77, 128)
    assert (cell.check["sample"], cell.check["trace_requests"]) == (8, 24)
    catalog = {"hidden_size": 2048, "num_hidden_layers": 27, "n_routed_experts": 64,
               "num_experts_per_tok": 6, "moe_intermediate_size": 1408, "vocab_size": 163840}
    assert all(cell.config[k] == v for k, v in catalog.items())
    # 1 + 77 + 77 + 128 + 312 positions fit the DiT's max_len
    assert 1 + 2 * 77 + 128 + 312 <= cell.config["dit"]["max_len"]


# ----------------------------------------------------------------- on the card

def _card_tower(c: dict, sd: dict):
    from audiolcm_torch.models.moe_llm import MoELLM, MoELLMConfig

    with torch.device("meta"):
        tower = MoELLM(MoELLMConfig.from_dict(c))
    tower.load_state_dict(sd, strict=True, assign=True)
    tower.eval().requires_grad_(False)
    tower.pack_expert_weights()
    return tower


def _card_ids(c: dict, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(9)
    return torch.randint(0, c["vocab_size"], (1, 128), generator=g).to(device)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _differ(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of the (T, k) choices of a that b's rows lack."""
    same = (a.sort(-1)[0][:, :, None] == b.sort(-1)[0][:, None, :]).any(-1).float()
    return 1.0 - float(same.mean())


WEIGHT_SEED = 2 ** 31 + 7


@pytest.mark.card
@pytest.mark.parametrize("init", ["fan_in", "hf_0.02"])
def test_bf16_tower_states_near_the_f32_reference_on_card(card, capsys, init):
    """Prints the final states' distance, each layer's and the top-6 choices
    that differ per expert layer, under the cell's fan-in init and under
    HF's (every matrix N(0, 0.02^2), `initializer_range`). Held: every
    state finite, 26 expert layers routed, and layer 0 (MLA and the dense
    SwiGLU, no routing) within 2 % of the f32 reference: bf16's own
    rounding. Past the first routed layer a random tower's states part
    more (a choice that flips on rounding changes a sixth of a token's
    routed sum); each layer is held tightly on its own by
    test_each_bf16_tower_layer_against_the_reference_layer_on_card."""
    from audiolcm_torch.models.moe_llm import DecoderLayer, TopkRouter
    from benchmark.reference import ops

    c = _cell().config
    sd = drv.make_state_dicts(c, WEIGHT_SEED, card, torch.bfloat16)["llm"]
    if init == "hf_0.02":
        with torch.no_grad():
            for t in sd.values():
                if t.dim() >= 2:
                    t.mul_(0.02 * t[0].numel() ** 0.5)
    tower = _card_tower(c, sd)
    chosen, outs = [], []
    for m in tower.modules():
        if isinstance(m, TopkRouter):
            m.register_forward_hook(lambda mod, args, out: chosen.append(out[0]))
        if isinstance(m, DecoderLayer):
            m.register_forward_hook(lambda mod, args, out: outs.append(out.float()))
    ids = _card_ids(c, card)
    with torch.inference_mode():
        got = tower(ids).float()
    routes, layers = [], []
    with torch.no_grad(), ops.strict_f32():
        want = moe_llm.forward(sd, c, ids, routes=routes, layers=layers)
    differ = [round(_differ(a, b), 4) for a, b in zip(chosen, routes)]
    line = {"init": init, "states_rel_l2": _rel(got, want),
            "layer_rel_l2": [round(_rel(a, b), 4) for a, b in zip(outs, layers)],
            "top6_differ": differ, "top6_differ_mean": sum(differ) / len(differ),
            "device": torch.cuda.get_device_name(0)}
    with capsys.disabled():
        print(json.dumps(line))
    assert len(chosen) == len(routes) == 26 and len(outs) == 27
    assert bool(torch.isfinite(got).all())
    assert line["layer_rel_l2"][0] < 0.02


# each layer's bf16 parts against f32 on the same input: <= 0.49 % and 0.39 % read on the
# card (PERF.md section 6), so 2x room; the planted faults read >= 27 %
ATTN_REL = 0.01  # MLA
MLP_REL = 0.01  # the dense SwiGLU, and shared + routed experts on the same routes
ROUTES_DIFFER = 0.01  # the router's top-6 on the same input: f32 logits, near-ties only


@pytest.mark.card
def test_each_bf16_tower_layer_against_the_reference_layer_on_card(card, capsys):
    """Every layer of the bf16 port on its own input, against the f32
    reference's same layer on that input (so no error carries from layer to
    layer): the attention on the port's normed input; the router's top-6
    choices; the MLP on the port's normed input, the expert layers' routed
    experts run through K7 on the reference's own routes and weights. Each
    held to bf16's rounding. Two planted faults of an expert layer, the
    routing weights without `routed_scaling_factor` and each token's last
    chosen expert dropped, read far above the MLP's bar in every layer."""
    from audiolcm_torch.models.moe_llm import MoE, rotary_tables
    from audiolcm_torch.nn import moe_experts
    from benchmark.reference import ops

    c = _cell().config
    sd = drv.make_state_dicts(c, WEIGHT_SEED, card, torch.bfloat16)["llm"]
    tower = _card_tower(c, sd)
    ids = _card_ids(c, card)
    d, factor = c["hidden_size"], c["routed_scaling_factor"]
    rows = []
    with torch.inference_mode(), ops.strict_f32():
        cos, sin = rotary_tables(ids.shape[1], c["qk_rope_head_dim"], c["rope_theta"], card)
        x = tower.model.embed_tokens(ids)
        for i, layer in enumerate(tower.model.layers):
            pre = f"model.layers.{i}"
            xn = layer.input_layernorm(x)
            attn = layer.self_attn(xn, cos, sin)
            row = {"layer": i, "attn": _rel(attn, moe_llm._attention(
                ops.F32, sd, f"{pre}.self_attn", c, xn.float()))}
            h = x + attn
            z = layer.post_attention_layernorm(h)
            if isinstance(layer.mlp, MoE):
                z2 = z.reshape(-1, d)
                idx, w = moe_llm.route(sd, f"{pre}.mlp", c, z2.float())
                row["routes_differ"] = _differ(layer.mlp.gate(z2)[0], idx)
                want = moe_llm._moe(ops.F32, sd, f"{pre}.mlp", c, z.float(), None).reshape(-1, d)
                shared, zero = layer.mlp.shared_experts(z2), torch.zeros_like(z2)
                k7 = lambda wk: moe_experts.routed_experts(  # noqa: E731
                    z2, idx, wk, layer.mlp.stacked_weights(), zero, shared)
                row["mlp"] = _rel(k7(w), want)
                row["fault_no_scaling"] = _rel(k7(w / factor), want)
                row["fault_last_slot_dropped"] = _rel(k7(torch.cat(
                    [w[:, :-1], torch.zeros_like(w[:, -1:])], dim=1)), want)
            else:
                row["mlp"] = _rel(layer.mlp(z), moe_llm._swiglu_forward(
                    ops.F32, sd, f"{pre}.mlp", z.float()))
            rows.append(row)
            x = layer(x, cos, sin)
    worst = {k: max(r[k] for r in rows if k in r) for k in rows[-1] if k != "layer"}
    least = {k: min(r[k] for r in rows if k in r) for k in rows[-1] if k.startswith("fault")}
    with capsys.disabled():
        print(json.dumps({"worst": worst, "least_fault": least,
                          "rows": [{k: round(v, 5) for k, v in r.items()} for r in rows],
                          "device": torch.cuda.get_device_name(0)}))
    assert len(rows) == 27
    assert worst["attn"] <= ATTN_REL and worst["mlp"] <= MLP_REL, worst
    assert worst["routes_differ"] <= ROUTES_DIFFER, worst
    assert min(least.values()) > 3 * MLP_REL, least


SEES = 2.0  # the unscaled router's mel distance over the port's own: 3.3x read on the card


@pytest.mark.card
def test_the_cells_check_reads_tower_faults_on_card(card, capsys, monkeypatch):
    """The cell's check (`check.compare`, `check.judge` against the cell's
    limits) on three requests of a run, printed: the port, the port with a
    planted tower fault (the router's weights without
    `routed_scaling_factor`, run eagerly), and the reference with its tower
    alone in the fp8 control's arithmetic (`ops.computed_in`), the rest in
    f32. Held: the port passes, and the unscaled router reads at least SEES
    times the port's mel distance. The fp8 tower's reading, and where each
    fault reads against the limits, are printed, not held: the random DiT listens to the tower's states only so
    far (other LLM ids move the mel ~0.25), so the limits, set between the
    port and the whole fp8 control, need not reject a fault of the tower
    alone (PERF.md section 6); the tower's own card test holds each layer
    at bf16's rounding."""
    from audiolcm_torch.models import moe_llm as port_llm
    from benchmark.harness import check
    from benchmark.reference import ops

    cell = _cell()
    seed = 2 ** 31 + 21
    d = drv.Driver(cell, seed, card)
    d.setup([request(cell.traffic, cell.config, seed, -1)])
    sample = [request(cell.traffic, cell.config, seed, i) for i in range(3)]
    served = [(q, 0.0, d.run(q)) for q in sample]
    d.pipe._graphs.clear()  # eager from here, so that the planted fault runs
    route = port_llm.TopkRouter.forward
    factor = cell.config["routed_scaling_factor"]

    def unscaled(self, x):
        idx, w = route(self, x)
        return idx, w / factor

    monkeypatch.setattr(port_llm.TopkRouter, "forward", unscaled)
    faulty = [(q, 0.0, d.run(q)) for q in sample]
    monkeypatch.setattr(port_llm.TopkRouter, "forward", route)
    d.free_program()
    refs = {q.index: d.reference(q, ops.F32) for q in sample}
    forward = moe_llm.forward

    def fp8_tower(sd, c, ids, p=ops.F32, **kw):
        with ops.computed_in(ops.Precision("fp8")):
            return forward(sd, c, ids, ops.Precision("fp8"), **kw)

    monkeypatch.setattr(moe_llm, "forward", fp8_tower)
    fp8 = [(q, 0.0, d.reference(q, ops.F32)) for q in sample]
    monkeypatch.setattr(moe_llm, "forward", forward)
    limits = cell.check["limits"]
    numbers = {name: check.compare(outs, lambda q: refs[q.index])
               for name, outs in (("port", served), ("port_unscaled_router", faulty),
                                  ("reference_fp8_tower", fp8))}
    with capsys.disabled():
        print(json.dumps({"limits": limits, **numbers,
                          "device": torch.cuda.get_device_name(0)}))
    assert check.judge(numbers["port"], limits)
    assert (numbers["port_unscaled_router"]["mel_rel_l2"]
            >= SEES * numbers["port"]["mel_rel_l2"]), numbers

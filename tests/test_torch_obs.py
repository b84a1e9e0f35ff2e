"""The recorder (`audiolcm_torch/obs.py`): one request per generate with its
stages under it, one `ddim.step` per teacher step, the span ring's bound,
host stamps on torch.profiler's clock, launches counted per replay of a
capture, and the bookkeeping of the stages' device stamps, here with the
host clock standing in for the card's timer (`HostStamps`). On the card
(`-m gpu`): a replay's stage times sum to the replay, and K1, K3 and K5 count
as many launches per replay as per eager call."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from audiolcm_torch import aot, obs
from audiolcm_torch.models import bigvgan, clap_text, dit, t5_encoder, vae1d
from audiolcm_torch.pipeline import AudioLCMPipeline, PipelineModules
from torch_threads import one_torch_thread  # noqa: F401  (autouse; tests/ is on sys.path)

STAGES = ("text", "dit", "vae", "vocoder")
TINY_VOCODER = dict(num_mels=8, upsample_rates=(4, 4, 4), upsample_kernel_sizes=(8, 8, 8),
                    upsample_initial_channel=32)  # stages C = 16, 8, 4


def tiny_modules(use_flash: bool = False, vocoder=TINY_VOCODER, fused_max: int = 8):
    """Tiny text towers, DiT and VAE with torch's default init; the vocoder
    fuses its stages with C <= fused_max."""
    torch.manual_seed(0)
    return PipelineModules(
        dit=dit.ConcatDiT2MLP(in_channels=4, context_dim=16, hidden_size=32, depth=1,
                              num_heads=4, max_len=256, use_flash=use_flash),
        vae=vae1d.AutoencoderKL1D(vae1d.VAEConfig(
            in_channels=8, out_ch=8, ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_layers=(),
            down_layers=(0,), kernel_size=5, z_channels=4, embed_dim=4)),
        vocoder=bigvgan.BigVGAN(bigvgan.BigVGANConfig(**vocoder),
                                pallas_stage_max_channels=fused_max),
        clap_text=clap_text.ClapTextEncoder(clap_text.BertConfig(
            vocab_size=30, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
            max_position_embeddings=80), 16),
        t5=t5_encoder.T5Encoder(t5_encoder.T5Config(vocab_size=30, d_model=16, d_kv=8, d_ff=24,
                                                    num_layers=1, num_heads=2)))


def tiny_pipeline():
    return AudioLCMPipeline(tiny_modules(), device="cpu", default_latent_len=8)


def requests(snap):
    return [s for s in snap["spans"] if s["name"] == "request"]


def spans_of(snap, req):
    """{name: span} of the other spans of request `req`."""
    return {s["name"]: s for s in snap["spans"]
            if s["request"] == req["request"] and s["id"] != req["id"]}


def check_nesting(by: dict, req: dict, n_stages: int) -> None:
    assert set(by) >= set(STAGES) | {f"vocoder.stage{i}" for i in range(n_stages)}
    assert all(by[n]["parent"] == req["id"] for n in STAGES)
    assert all(by[f"vocoder.stage{i}"]["parent"] == by["vocoder"]["id"]
               for i in range(n_stages))


@pytest.fixture(autouse=True)
def fresh_recorder():
    obs.reset()
    yield
    obs.reset()


def test_a_generate_is_one_request_with_its_stages_under_it():
    pipe = tiny_pipeline()
    ids = torch.zeros((2, 7), dtype=torch.int64)
    pipe.generate(ids, ids, 8)
    pipe.generate(ids, ids, 8)
    snap = obs.snapshot()
    reqs = requests(snap)
    assert [r["request"] for r in reqs] == [0, 1] and snap["requests"] == 2
    assert [r["kind"] for r in reqs] == ["eager", "eager"]
    assert all(r["counts"] == {} for r in reqs)  # the CPU launches no kernel
    (init,) = [s for s in snap["spans"] if s["name"] == "init"]
    assert init["request"] is None and init["end_ns"] <= reqs[0]["start_ns"]
    for r in reqs:
        by = spans_of(snap, r)
        assert set(by) == set(STAGES) | {"vocoder.stage0", "vocoder.stage1", "vocoder.stage2"}
        check_nesting(by, r, 3)
        assert [(by[f"vocoder.stage{i}"]["C"], by[f"vocoder.stage{i}"]["fused"])
                for i in range(3)] == [(16, False), (8, True), (4, True)]
        for s in by.values():
            assert r["start_ns"] <= s["start_ns"] <= s["end_ns"] <= r["end_ns"]
            assert s["device_ms"] is None  # the CPU: host spans only


def test_a_teacher_request_has_one_ddim_step_span_per_step():
    pipe = tiny_pipeline()
    ids = torch.zeros((2, 7), dtype=torch.int64)
    ctx = pipe.encode_text_ids(ids, ids)
    for steps in (5, 10):
        pipe.generate_teacher(ctx, ctx[:1], 8, num_steps=steps)
    snap = obs.snapshot()
    reqs = requests(snap)
    assert [r["kind"] for r in reqs] == ["teacher", "teacher"]
    for r, steps in zip(reqs, (5, 10)):
        dit_span = spans_of(snap, r)["dit"]
        ddim = [s for s in snap["spans"]
                if s["name"] == "ddim.step" and s["request"] == r["request"]]
        assert len(ddim) == steps and all(s["parent"] == dit_span["id"] for s in ddim)
        assert all(dit_span["start_ns"] <= s["start_ns"] <= s["end_ns"] <= dit_span["end_ns"]
                   for s in ddim)


def test_the_span_ring_is_bounded_and_counts_what_it_drops():
    for _ in range(obs.RING_SPANS + 10):
        with obs.span("ddim.step"):
            pass
    snap = obs.snapshot()
    assert len(snap["spans"]) == obs.RING_SPANS and snap["dropped"] == 10
    ids = [s["id"] for s in snap["spans"]]
    assert ids == sorted(ids) and ids[-1] - ids[0] == obs.RING_SPANS - 1  # the newest kept


def test_host_stamps_fall_inside_a_profiler_range_around_the_same_call():
    """The recorder stamps on the profiler's host clock: the request span of
    a generate lies inside a record_function range opened around it, to
    within 100 us."""
    pipe = tiny_pipeline()
    ids = torch.zeros((1, 7), dtype=torch.int64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("probe.generate"):
                pipe.generate(ids, ids, 8)
    ranges = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
              if e.name() == "probe.generate"]
    reqs = requests(obs.snapshot())
    assert len(ranges) == len(reqs) == 3
    for (start, end), r in zip(sorted(ranges), reqs):
        assert start - 100_000 <= r["start_ns"] <= r["end_ns"] <= end + 100_000


def test_launches_during_a_capture_go_to_its_tally_and_count_once_per_replay():
    with obs.capture(torch.device("cpu")) as tally:
        obs.count("amp_stage.mma", 2)
        obs.count("flash_attention.tc")
    assert obs.counters() == {} and tally.counts == {"amp_stage.mma": 2, "flash_attention.tc": 1}
    obs.count("act_chain")  # outside a capture: to the totals at once
    for _ in range(3):
        with obs.request("replay"):
            with obs.launch(tally):
                pass
    snap = obs.snapshot()
    assert snap["counters"] == {"amp_stage.mma": 6, "flash_attention.tc": 3, "act_chain": 1}
    for r in requests(snap):
        assert r["counts"] == tally.counts
        assert spans_of(snap, r)["replay.launch"]["parent"] == r["id"]


class HostStamps:
    """Stands in for a card's stamp ring (`obs._Stamps`) on the CPU: a stamp
    issued outside a capture runs at once, on the host clock; the stamps a
    capture issued run when the test's graph replays."""

    def __init__(self, size: int):
        self.size, self.issued, self.head, self.ring = size, 0, 0, [0] * size

    def run(self) -> None:
        self.ring[self.head % self.size] = time.perf_counter_ns()
        self.head += 1

    def stamp(self) -> int:
        if obs._capture is None:
            self.run()
        self.issued += 1
        return self.issued - 1

    def times(self) -> list:
        return list(self.ring)


class HostGraph:
    """A captured graph's replay, as far as the recorder sees it: the
    stamps its capture issued run."""

    def __init__(self, tally, stamps):
        self.tally, self.stamps = tally, stamps

    def replay(self) -> None:
        for _ in range(self.tally.n_stamps):
            self.stamps.run()


def host_captured(pipe, batch: int, latent: int, stamps) -> aot.CapturedGenerate:
    """A CapturedGenerate on the CPU: the generate run under `obs.capture`
    as `CapturedGenerate.__init__` captures it, and a HostGraph in place of
    the CUDA graph."""
    g = object.__new__(aot.CapturedGenerate)
    g.pipeline, g.latent_len = pipe, latent
    g.clap_ids = torch.zeros((batch, 7), dtype=torch.int64)
    g.t5_ids = torch.zeros((batch, 7), dtype=torch.int64)
    g.shape = (batch, latent, pipe.modules.dit.in_channels)
    g.x_T, g.noise = torch.zeros(g.shape), torch.zeros((1,) + g.shape)
    with obs.capture(pipe.device) as g.tally:
        g.wav, g.mel = g._run()
    g.graph = HostGraph(g.tally, stamps)
    return g


def test_eager_and_replayed_stages_read_their_device_stamps(monkeypatch):
    stamps = HostStamps(obs.RING_STAMPS)
    monkeypatch.setattr(obs, "_stamps_for", lambda device: stamps)
    pipe = tiny_pipeline()
    ids = torch.zeros((1, 7), dtype=torch.int64)
    pipe.generate(ids, ids, 8)  # eager: 7 stages, 9 stamps (siblings share one)
    assert stamps.issued == 9
    g = host_captured(pipe, 1, 8, stamps)
    assert g.tally.n_stamps == 9 and stamps.issued == stamps.head == 9  # not run yet
    assert [s[0] for s in g.tally.stages] == ["text", "dit", "vae", "vocoder", "vocoder.stage0",
                                              "vocoder.stage1", "vocoder.stage2"]
    assert g.tally.slots == [(0, 1), (1, 2), (2, 3), (3, 8), (4, 5), (5, 6), (6, 7)]
    pipe._graphs[g.key] = g
    pipe.generate(ids, ids, 8)
    pipe.generate(ids, ids, 8)
    assert stamps.issued == stamps.head == 27
    snap = obs.snapshot()
    reqs = requests(snap)
    assert [r["kind"] for r in reqs] == ["eager", "replay", "replay"] and snap["lost"] == 0
    for r in reqs:
        by = spans_of(snap, r)
        check_nesting(by, r, 3)
        stages = [s for n, s in by.items() if n != "replay.launch"]
        assert len(stages) == 7 and all(s["device_ms"] >= 0 for s in stages)
        assert sum(by[n]["device_ms"] for n in STAGES) <= 1e-6 * (r["end_ns"] - r["start_ns"])
        if r["kind"] == "replay":  # no host work per stage: no host stamps
            assert all(s["start_ns"] is None for s in stages)
            assert by["replay.launch"]["parent"] == r["id"]


def test_stages_whose_stamps_the_ring_reused_are_lost(monkeypatch):
    monkeypatch.setattr(obs, "RING_STAMPS", 16)
    stamps = HostStamps(16)
    monkeypatch.setattr(obs, "_stamps_for", lambda device: stamps)
    pipe = tiny_pipeline()
    ids = torch.zeros((1, 7), dtype=torch.int64)
    for _ in range(3):  # 9 stamps each; stamps 16-26 overwrite slots 0-10
        pipe.generate(ids, ids, 8)
    snap = obs.snapshot()
    lost = [[n for n, s in spans_of(snap, r).items() if s["device_ms"] is None]
            for r in requests(snap)]
    assert len(lost[0]) == 7 and sorted(lost[1]) == ["dit", "text"] and lost[2] == []
    assert snap["lost"] == 9


# ----------------------------------------------------------------- on the card

@pytest.fixture(scope="module")
def card_pipeline():
    """bf16 on the card, the DiT on K3, the vocoder at its published widths
    with K1 on C = 48 and 24; one graph captured at batch 2, latent 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest -m gpu tests/test_torch_obs.py)")
    mods = tiny_modules(use_flash=True, vocoder=dict(num_mels=8), fused_max=48)
    pipe = AudioLCMPipeline(mods, compute_dtype=torch.bfloat16, device="cuda:0",
                            default_latent_len=64)
    g = aot.CapturedGenerate(pipe, 2, 64)
    pipe._graphs[g.key] = g
    return pipe, g


@pytest.mark.gpu
def test_replay_stage_times_sum_to_the_replay_on_card(card_pipeline):
    pipe, g = card_pipeline
    ids = torch.randint(0, 30, (2, 77), generator=torch.Generator().manual_seed(1))
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    graph = g.graph

    class Timed:  # CUDA events around the graph's replay
        def replay(self):
            e0.record()
            graph.replay()
            e1.record()

    g.graph = Timed()
    try:
        for _ in range(3):
            pipe.generate(ids, ids, 64)
        torch.cuda.synchronize()
    finally:
        g.graph = graph
    snap = obs.snapshot()
    last = requests(snap)[-1]
    by = spans_of(snap, last)
    check_nesting(by, last, 6)
    replay_ms = e0.elapsed_time(e1)
    stages_ms = sum(by[n]["device_ms"] for n in STAGES)
    assert abs(stages_ms - replay_ms) <= 0.03 * replay_ms, (stages_ms, replay_ms)
    assert sum(by[f"vocoder.stage{i}"]["device_ms"] for i in range(6)) <= by["vocoder"]["device_ms"]


@pytest.mark.gpu
def test_k1_and_k3_count_as_many_launches_per_replay_as_per_eager_call(card_pipeline):
    pipe, g = card_pipeline
    ids = torch.randint(0, 30, (2, 77), generator=torch.Generator().manual_seed(2))
    pipe.generate(ids, ids, 64)
    pipe.generate(ids, ids, 64, x_T=torch.zeros(g.shape, device=g.x_T.device),
                  noise=torch.zeros(g.noise.shape, device=g.x_T.device))
    replay, eager = requests(obs.snapshot())
    assert (replay["kind"], eager["kind"]) == ("replay", "eager")
    n_flash = 2 * 2 * len(pipe.modules.dit.blocks)  # 2 LCM steps, 2 self-attentions a block
    # K5: 18 activations in each of the four unfused stages, and activation_post;
    # K6: the 18 resblock convs of each of those stages
    assert replay["counts"] == eager["counts"] == {"amp_stage.mma": 2,
                                                    "flash_attention.tc": n_flash,
                                                    "alias_free_act": 73, "wide_conv": 72}

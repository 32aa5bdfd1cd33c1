"""The port's spans and counters (msfno_torch/utils/observability.py): off
they record nothing and never reach the profiler; on they nest, carry the
request (a training step, a forecast and its step), keep a bounded ring,
and stand on the profiler's host clock; the net's, the FiLM generator's,
the rollout's and the trainer's spans are recorded once per unit of work,
and the pageable uploads are counted at their sites.  Marked `cuda`: a
span's kernels on its timeline and its device time against CUDA events,
and the benchmark's CUDA-only profiler seeing none of the spans."""

import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msfno_torch import config as tcfg
from msfno_torch.models.registry import get_model
from msfno_torch.ops.kernels import launch_counts
from msfno_torch.training.trainer import Trainer
from msfno_torch.utils import observability as obs

torch.set_num_threads(2)

FILM = tcfg.FilmConfig(model_depth=2, embed_dim=16, mlp_dim=16, num_film_features=16,
                       sst_shape=(8, 16), temporal_step=4)
CFG = tcfg.SFNOConfig(img_size=(16, 32), scale_factor=2, in_chans=4, out_chans=4,
                      embed_dim=16, num_layers=3, spectral_layers=1, film=FILM)
TRAINER_SPANS = ("trainer.forward", "trainer.backward", "trainer.optimizer")


@pytest.fixture(autouse=True)
def clean():
    obs.reset_tracing()
    yield
    obs.reset_tracing()


@pytest.fixture
def profiler_imports(monkeypatch):
    """Starting a torch.profiler imports torch._dynamo, which looks modules
    of its skip list (`xarray` among them) up by their spec; the stub
    `xarray` that the reference tests leave in sys.modules has none, so it
    is set aside for the test."""
    stub = sys.modules.get("xarray")
    if stub is not None and getattr(stub, "__spec__", None) is None:
        monkeypatch.delitem(sys.modules, "xarray")


def _inputs(batch=1, steps=1, seed=0):
    rng = np.random.default_rng(seed)
    h, w = CFG.img_size
    x0 = rng.standard_normal((batch, h, w, CFG.in_chans)).astype(np.float32)
    sst = rng.standard_normal((steps, batch, FILM.temporal_step, *FILM.sst_shape))
    return x0, sst.astype(np.float32)


def test_off_records_nothing_and_never_enters_the_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    x = torch.ones(3)
    with obs.span("off.site", x, 2) as rec:
        y = x + 1
    assert rec is None and float(y.sum()) == 6.0
    # the off context is one shared object per name
    assert obs.span("off.site") is obs.span("off.site", x, 5)

    @obs.span("off.decorated")
    def f(a):
        return a * 2

    assert f(3) == 6
    assert obs.span_totals() == {} and obs.raw_spans() == []


def test_spans_record_under_the_profilers_flag(profiler_imports):
    """The flag the spans read is torch.autograd.profiler's own: set while a
    torch.profiler records, clear otherwise."""
    import torch.autograd.profiler as ap

    assert not ap._is_profiler_enabled
    with obs.span("before.profiler"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert ap._is_profiler_enabled
        with obs.span("under.profiler"):
            obs.count("under.profiler")
    assert not ap._is_profiler_enabled
    with obs.span("after.profiler"):
        pass
    assert list(obs.span_totals()) == ["under.profiler"]
    assert obs.counters(traced=True) == {"under.profiler": 1}


def test_nesting_requests_and_decorator():
    @obs.span("outer.fn")
    def work(k):
        obs.set_request(("forecast", k))
        with obs.span("inner", torch.device("cpu"), k):
            with obs.span("innermost"):
                pass

    with obs.tracing():
        work(0)
        work(1)
    raw = obs.raw_spans()
    assert [r["name"] for r in raw] == ["innermost", "inner", "outer.fn"] * 2
    by_id = {r["id"]: r for r in raw}
    for r in raw:
        parent = by_id.get(r["parent"])
        want = {"innermost": "inner", "inner": "outer.fn", "outer.fn": None}[r["name"]]
        assert (parent and parent["name"]) == want
        assert r["start_ns"] <= r["end_ns"]
    assert [r["request"] for r in raw if r["name"] == "inner"] == [("forecast", 0),
                                                                   ("forecast", 1)]
    assert [r["index"] for r in raw if r["name"] == "inner"] == [0, 1]
    tot = obs.span_totals()
    assert {k: v["count"] for k, v in tot.items()} == {"outer.fn": 2, "inner": 2,
                                                       "innermost": 2}
    # a CPU device's time is the host time; no device, no device time
    assert tot["inner"]["device_s"] == pytest.approx(tot["inner"]["host_s"])
    assert tot["outer.fn"]["device_s"] is None
    assert tot["outer.fn"]["host_s"] >= tot["inner"]["host_s"] > 0


def test_ring_is_bounded(monkeypatch):
    monkeypatch.setattr(obs, "RING", 8)
    with obs.tracing():
        for _ in range(50):
            with obs.span("ring.site", torch.device("cpu")):
                pass
    assert len(obs.raw_spans()) == 8
    assert obs.span_totals()["ring.site"]["count"] == 50


def test_counters_hold_the_launch_counts_and_the_traced_tallies():
    obs.count("probe.events", 2)
    with obs.tracing():
        obs.count("probe.events")
    obs.count("probe.events")
    c = obs.counters()
    assert c["probe.events"] == 4
    for k, n in launch_counts().items():
        assert c[f"launches/{k}"] == n
    assert obs.counters(traced=True) == {"probe.events": 1}
    obs.reset_tracing()
    assert "probe.events" not in obs.counters() and obs.counters(traced=True) == {}


def test_threads_lose_no_span_or_count():
    """Spans and counts from more threads than cores, with the interpreter
    switching threads often: every span and every count is kept, and each
    thread's spans nest under its own."""
    import sys
    import threading

    threads, per = 16, 200

    def work():
        for _ in range(per):
            with obs.span("stress.outer"):
                with obs.span("stress.inner"):
                    obs.count("stress.count")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with obs.tracing():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    tot = obs.span_totals()
    assert tot["stress.outer"]["count"] == tot["stress.inner"]["count"] == threads * per
    assert obs.counters()["stress.count"] == threads * per
    raw = obs.raw_spans()
    by_id = {r["id"]: r for r in raw}
    for r in raw:
        if r["name"] == "stress.inner":
            parent = by_id[r["parent"]]
            assert parent["name"] == "stress.outer" and parent["thread"] == r["thread"]


def test_uploads_count_host_arrays_only():
    obs.upload(np.zeros(3, np.float32), "cpu")
    obs.upload(torch.zeros(3), "cpu")
    assert obs.counters()["uploads.pageable"] == 2
    assert obs.upload(np.arange(2), "cpu", torch.float64).dtype == torch.float64
    assert obs.counters()["uploads.pageable"] == 3


def test_running_records_each_span_per_step():
    """`ModelWrapper.running` on a tiny filmed net: a generator, an encoder,
    a decoder and `num_layers` blocks a step, one fetch wait a field, the
    inputs once a step and once for x0, the outputs once a step; the
    uploads: x0 and its normalization once, then each step's SST, its
    denormalization and the channel index."""
    steps = 3
    wrapper = get_model("sfno", "film", cfg=CFG, device="cpu")
    x0, sst = _inputs(batch=2, steps=steps)
    with obs.tracing():
        fields = list(wrapper.running(x0, lead_time_h=6 * steps, sst_seq=sst,
                                      collect_channels=[0, 2]))
    assert len(fields) == steps and fields[0].shape == (2, 16, 32, 2)
    counts = {k: v["count"] for k, v in obs.span_totals().items()}
    assert counts == {"film.generator": steps, "net.encoder": steps,
                      "net.block": steps * CFG.num_layers, "net.decoder": steps,
                      "rollout.inputs": steps + 1, "rollout.outputs": steps,
                      "rollout.fetch_wait": steps}
    raw = obs.raw_spans()
    blocks = [r for r in raw if r["name"] == "net.block"]
    assert [r["index"] for r in blocks] == list(range(CFG.num_layers)) * steps
    forecast = blocks[0]["request"][0]
    assert [r["request"] for r in blocks] == [(forecast, i) for i in range(steps)
                                              for _ in range(CFG.num_layers)]
    assert obs.counters(traced=True)["uploads.pageable"] == 3 + 4 * steps
    # the same forecast untraced counts the same uploads and records nothing
    obs.reset_tracing()
    list(wrapper.running(x0, lead_time_h=6 * steps, sst_seq=sst, collect_channels=[0, 2]))
    assert obs.span_totals() == {} and obs.counters()["uploads.pageable"] == 3 + 4 * steps


def test_train_steps_record_the_trainer_phases_and_count_uploads():
    """`Trainer.train_steps` (K = 1, ms = 1): the three phases once a step
    and the net twice a step, request ids the step numbers; each step
    uploads the normalizer's means and stds for the input and both targets
    and the loss's quadrature weights twice."""
    ms = 1
    tr = Trainer(CFG, tcfg.finetune_train_config(multi_step_training=ms), device="cpu")
    state = tr.init_state()
    rng = np.random.default_rng(1)
    h, w = CFG.img_size
    era5 = torch.from_numpy(rng.standard_normal((1, ms + 2, 1, h, w, CFG.in_chans))
                            .astype(np.float32))
    sst = torch.from_numpy(rng.standard_normal((1, ms + 2, 1, FILM.temporal_step,
                                                *FILM.sst_shape)).astype(np.float32))
    steps = 2
    with obs.tracing():
        for _ in range(steps):
            state, _ = tr.train_steps(state, era5, sst)
    tot = obs.span_totals()
    for name in TRAINER_SPANS:
        assert tot[name]["count"] == steps and tot[name]["device_s"] is None
    assert tot["film.generator"]["count"] == steps * (ms + 1)
    assert tot["net.block"]["count"] == steps * (ms + 1) * CFG.num_layers
    raw = obs.raw_spans()
    assert [r["request"] for r in raw if r["name"] == "trainer.optimizer"] == [0, 1]
    ids = {r["id"]: r["name"] for r in raw}
    assert {ids.get(r["parent"]) for r in raw if r["name"] == "net.encoder"} == {
        "trainer.forward"}
    per_step = 2 * (ms + 2) + (ms + 1)
    assert obs.counters(traced=True)["uploads.pageable"] == steps * per_step


def test_span_stands_on_the_profilers_host_clock(profiler_imports):
    """Under a CPU profiler a span's own start and end agree with Kineto's
    range of the same name within 100 us.  The process's first range pays
    a one-off setup inside `record_function` (up to ~1 ms), so the first
    span is a warm-up and is not compared."""
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            with obs.span("clock.probe", x) as rec:
                for _ in range(20):
                    x = torch.tanh(x @ x * 1e-2)
    kin = sorted((ev for ev in prof.profiler.kineto_results.events()
                  if ev.name() == "clock.probe"), key=lambda ev: ev.start_ns())
    mine = [r for r in obs.raw_spans() if r["name"] == "clock.probe"]
    assert len(kin) == len(mine) == 4
    assert mine[-1]["id"] == rec.id
    for ev, r in list(zip(kin, mine))[1:]:
        assert abs(ev.start_ns() - r["start_ns"]) < 100_000
        assert abs(ev.start_ns() + ev.duration_ns() - r["end_ns"]) < 100_000


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


@pytest.mark.cuda
def test_card_span_holds_its_kernels_and_times_them(profiler_imports):
    """On the card: the GEMMs launched inside a span have their launch
    records inside the span's host interval and their kernel records after
    its start, on the same clock; the span's device time is within 10% of
    CUDA events recorded around the same launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(4096, 4096, device="cuda")
    y = x @ x
    torch.cuda.synchronize()
    obs.reset_tracing()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with obs.span("card.probe", x) as rec:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                y = torch.tanh(y @ x * 1e-3)
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    launches = {ev.correlation_id(): ev for ev in events
                if ev.device_type() != cuda and ev.name() in LAUNCH_CALLS}
    inside = {c: ev for c, ev in launches.items()
              if rec.start_ns <= ev.start_ns() <= rec.end_ns}
    kernels = [ev for ev in events if ev.device_type() == cuda
               and ev.correlation_id() in inside and not ev.name().startswith("Memcpy")]
    assert len(inside) >= 20 and len(kernels) >= 20
    assert all(k.start_ns() >= rec.start_ns for k in kernels)
    dev_s = obs.span_totals()["card.probe"]["device_s"]
    ref_s = e0.elapsed_time(e1) * 1e-3
    assert abs(dev_s - ref_s) <= 0.1 * ref_s, (dev_s, ref_s)


@pytest.mark.cuda
def test_card_cuda_only_profiler_sees_no_span(profiler_imports):
    """Under the benchmark's CUDA-only profiler (`port_bench/harness/
    trace.py:DeviceTrace`) the spans' ranges are not among the host events,
    so the breakdown's idle gaps are labelled by CUDA calls alone; the
    spans still record their totals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from port_bench.harness.trace import DeviceTrace

    x = torch.randn(2048, 2048, device="cuda")
    with DeviceTrace(True) as tr:
        for i in range(5):
            with obs.span("probe.outer", x, i):
                with obs.span("probe.inner", x):
                    x = torch.tanh(x @ x * 1e-3)
        torch.cuda.synchronize()
        tr.window_s = 1.0
    names = {ev.name() for ev in tr.prof.profiler.kineto_results.events()
             if ev.device_type() != torch.autograd.DeviceType.CUDA}
    assert not names & {"probe.outer", "probe.inner"}, sorted(names)
    rec = tr.record()
    labels = {label for label, _ in rec["breakdown"]["idle_gaps"]}
    assert not labels & {"probe.outer", "probe.inner"}, labels
    tot = obs.span_totals()
    assert tot["probe.outer"]["count"] == 5 and tot["probe.inner"]["device_s"] > 0


def test_reset_clears_totals_ring_and_counters():
    with obs.tracing():
        with obs.span("reset.probe"):
            obs.count("reset.count")
    assert obs.span_totals() and obs.raw_spans()
    obs.reset_tracing()
    assert obs.span_totals() == {} and obs.raw_spans() == []
    assert "reset.count" not in obs.counters()


def test_net_spans_on_a_tiny_afno():
    """FourCastNet's encoder (patch embed and pos-embed), each block and its
    head are spans, the block's index kept."""
    from msfno_torch.models.afno import AFNONet

    net = AFNONet(img_size=(16, 32), patch_size=(4, 4), in_chans=3, out_chans=3,
                  embed_dim=16, depth=2, device="cpu")
    with obs.tracing(), torch.no_grad():
        net(torch.randn(1, 16, 32, 3))
    raw = obs.raw_spans()
    assert [(r["name"], r["index"]) for r in raw] == [
        ("net.encoder", None), ("net.block", 0), ("net.block", 1), ("net.decoder", None)]
    assert all(r["device_s"] is not None for r in raw)


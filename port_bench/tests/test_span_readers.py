"""The readers of the program's spans and counters: each on a record with
the program's recorder filled (spans on the CPU, whose device time is the
host time), None with nothing recorded and with a program that has no
recorder."""

from __future__ import annotations

import json

import pytest
import torch
from conftest import ROOT

from port_bench.harness import common

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
PER_LAYER = {m["name"]: m for m in MANIFEST["per_layer"]}
REC = {"steps": 4, "units_traced": 16}
CPU = torch.device("cpu")
# each program-side reader: the spans it sums, whether it reads their
# device time (else host time), and the record's unit it divides by
SPANS = {
    "trainer_forward_host_ms.finetune": (("trainer.forward",), False, "steps"),
    "trainer_backward_host_ms.finetune": (("trainer.backward",), False, "steps"),
    "trainer_optimizer_host_ms.finetune": (("trainer.optimizer",), False, "steps"),
    "film_gen_span_ms.rollout": (("film.generator",), True, "units_traced"),
    "net_encoder_decoder_ms.rollout": (("net.encoder", "net.decoder"), True, "units_traced"),
    "net_blocks_ms.rollout": (("net.block",), True, "units_traced"),
    "rollout_io_ms.rollout": (("rollout.inputs", "rollout.outputs"), True, "units_traced"),
    "fetch_wait_ms.rollout": (("rollout.fetch_wait",), False, "units_traced"),
}
COUNTERS = {"pageable_uploads.finetune": "steps", "pageable_uploads.rollout": "steps"}
READERS = sorted(set(SPANS) | set(COUNTERS))


@pytest.fixture
def obs():
    from msfno_torch.utils import observability

    observability.reset_tracing()
    yield observability
    observability.reset_tracing()


def _read(name, rec=REC):
    return common.load_module("metrics", name).read(rec)


def _fill(obs):
    """Every span the readers read, three times each (a block at three
    indices), and five uploads counted under tracing, two outside it."""
    obs.count("uploads.pageable", 2)
    x = torch.randn(64, 64)
    names = {n for spans, _, _ in SPANS.values() for n in spans}
    with obs.tracing():
        for k in range(3):
            for n in sorted(names):
                with obs.span(n, CPU if n.startswith(("net.", "film.", "rollout.i",
                                                      "rollout.o")) else None, k):
                    x = torch.tanh(x @ x * 1e-2)
        obs.count("uploads.pageable", 5)


def test_readers_are_the_manifests():
    for name in SPANS:
        assert PER_LAYER[name]["source"] == "program_span"
    for name in COUNTERS:
        assert PER_LAYER[name]["source"] == "program_counter"


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader_on_a_filled_recorder(obs, name):
    _fill(obs)
    spans, device, unit = SPANS[name]
    totals = obs.span_totals()
    want = sum(totals[n]["device_s" if device else "host_s"] for n in spans)
    assert want > 0
    assert _read(name) == pytest.approx(want / REC[unit] * 1e3)


@pytest.mark.parametrize("name", sorted(COUNTERS))
def test_counter_reader_on_a_filled_recorder(obs, name):
    _fill(obs)
    assert _read(name) == pytest.approx(5 / REC[COUNTERS[name]])


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_with_nothing_recorded(obs, name):
    obs.count("uploads.pageable", 3)  # counted, but not while tracing
    assert _read(name) is None
    _fill(obs)
    assert _read(name, {"steps": 0, "units_traced": 0}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_a_recorder(monkeypatch, obs, name):
    """A program without the recorder (the commit before it) reads None."""
    _fill(obs)
    monkeypatch.delattr(obs, "span_totals")
    assert _read(name) is None


def test_uploads_read_zero_once_spans_were_recorded(obs):
    with obs.tracing():
        with obs.span("trainer.forward"):
            pass
    assert _read("pageable_uploads.finetune") == 0.0

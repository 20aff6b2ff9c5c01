"""The port's recorder (`utils/profiling.py`) on the CPU: spans nest into
calls, counts land on the open call, nothing is recorded when it is off or
under torch.profiler, an overwritten ring is reported, the device's idle
time is summed by span, the clocks' offset and drift are fitted; and the
spans and counts of `Denoiser`, `MultiStreamDenoiser` and `TrainStep`.
Device intervals and the capture spans need a card (tests/test_torch_cuda.py).
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tinyrecurrentunet_torch.config import load_config
from tinyrecurrentunet_torch.infer.denoise import Denoiser
from tinyrecurrentunet_torch.infer.multistream import MultiStreamDenoiser
from tinyrecurrentunet_torch.utils import profiling
from tinyrecurrentunet_torch.weights import load_pretrained

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "proc16k.json")
ARTIFACT = os.path.join(REPO, "artifacts", "TRUNet-proc")


@pytest.fixture
def recorder():
    """The process's recorder, emptied and on."""
    profiling.reset()
    profiling.enable(True)
    yield profiling.RECORDER
    profiling.enable(True)
    profiling.reset()


@pytest.fixture(scope="module")
def flagship():
    cfg = load_config(CONFIG)
    return cfg, load_pretrained(ARTIFACT, cfg)


def test_spans_nest_into_calls_with_their_parents(recorder):
    for _ in range(2):
        with profiling.span("outer"):
            with profiling.span("a"):
                with profiling.span("b"):
                    pass
            with profiling.span("c"):
                pass
    with profiling.span("other"):
        pass
    calls = profiling.calls()
    assert [c.id for c in calls] == [0, 1, 2] and [c.name for c in calls] == ["outer", "outer", "other"]
    first = calls[0]
    assert [(s.name, s.parent) for s in first.spans] == [("outer", -1), ("a", 0), ("b", 1), ("c", 0)]
    assert all(first.start <= s.start <= s.end <= first.end for s in first.spans)
    assert first.spans[2].end <= first.spans[1].end <= first.spans[3].start
    assert calls[0].end <= calls[1].start and calls[1].end <= calls[2].start
    assert [c.id for c in profiling.calls("outer", last=1)] == [1]
    assert len(profiling.spans("b")) == 2 and profiling.spans("b")[0] == first.spans[2][1:3]


def test_an_open_call_is_not_read(recorder):
    with profiling.span("done"):
        pass
    with profiling.span("open"):
        assert [c.name for c in profiling.calls()] == ["done"]
        assert profiling.spans("open") == []


def test_enable_false_records_nothing(recorder):
    profiling.enable(False)
    with profiling.span("call"):
        profiling.count("samples", 3)
        with profiling.span("child"):
            pass
    assert profiling.calls() == [] and profiling.spans("child") == []
    profiling.enable(True)
    with profiling.span("call"):
        pass
    assert len(profiling.calls()) == 1


def test_counts_land_on_the_open_call(recorder):
    profiling.count("samples", 7)  # no call open: dropped
    with profiling.span("call"):
        profiling.count("samples", 5)
        with profiling.span("child"):
            profiling.count("samples", 2)
            profiling.count("padded", 1)
    with profiling.span("call"):
        pass
    with profiling.span("call"):
        profiling.count("padded", 4)
    assert [c.counts for c in profiling.calls()] == [{"samples": 7, "padded": 1}, {}, {"padded": 4}]


def test_profiled_calls_reach_the_trace_and_not_the_ring(recorder, flagship):
    """The benchmark reads the ring's last calls as its window: the calls of
    a profiled slice after it must not enter the ring."""
    cfg, sd = flagship
    den = MultiStreamDenoiser(cfg, sd, num_streams=2, device="cpu")
    state = den.init_state()
    blocks = np.zeros((2, den.hop), np.float32)
    _, state = den.process_block(state, blocks)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            _, state = den.process_block(state, blocks)
    names = [e.name for e in prof.events()]
    assert names.count("trunet.stream.call") == 2 and names.count("trunet.stream.stage") == 2
    assert [c.name for c in profiling.calls()] == ["trunet.stream.call"]


def test_an_overwritten_ring_is_reported():
    rec = profiling.Recorder(calls=4, spans=16)
    for _ in range(6):
        rec.end(rec.begin("call"))
    assert [c.id for c in rec.calls("call", last=4)] == [2, 3, 4, 5]
    with pytest.raises(profiling.Overflow):
        rec.calls("call", last=5)
    with pytest.raises(profiling.Overflow):
        rec.calls()
    rec = profiling.Recorder(calls=4, spans=16)
    for _ in range(3):  # 3 calls of 6 spans: the first call's spans are overwritten
        root = rec.begin("call")
        for _ in range(5):
            rec.end(rec.begin("child"))
        rec.end(root)
    assert [len(c.spans) for c in rec.calls(last=2)] == [6, 6]
    with pytest.raises(profiling.Overflow):
        rec.calls(last=3)
    with pytest.raises(profiling.Overflow):
        rec.spans("child")
    rec.reset()
    rec.end(rec.begin("call"))
    assert [c.id for c in rec.calls()] == [0] and rec.spans("call") != []


class _Event:
    """A timing event on a made-up card timer (`_Event.now`, ns); counts
    the elapsed times read."""

    now = 0
    reads = 0

    def record(self, stream):
        self.t = _Event.now

    def elapsed_time(self, other):
        _Event.reads += 1
        return (other.t - self.t) / 1e6


def test_device_intervals_are_read_only_when_the_ring_is_read(monkeypatch):
    """The pool holds a pair a call slot: the hot path reads no event,
    calls that took a pair again are gone from the ring, and the pairs
    still held are settled in order, on one chain, when the ring is read."""
    monkeypatch.setattr(torch._C, "_cuda_isCurrentStreamCapturing", lambda: False, raising=False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda *a: contextlib.nullcontext())
    monkeypatch.setattr(_Event, "reads", 0)
    monkeypatch.setattr(profiling, "_now", lambda: _Event.now + 10**9)  # the host clock, 1 s ahead
    rec = profiling.Recorder(calls=8, spans=64)
    rec._events, rec._device = ([_Event() for _ in range(8)], [_Event() for _ in range(8)]), 0
    monkeypatch.setattr(rec, "_current_stream", lambda: "stream")

    def timed(i, untimed=False):
        root = rec.begin("call")
        if not untimed:
            _Event.now = 1_000_000 * i + 7_000  # the card starts the call 7 us in
            rec.device_begin()
            _Event.now += 300_000 + i
            rec.device_end()
        rec.end(root)

    for i in range(5):
        timed(i)
    assert _Event.reads == 0
    assert [c.device[1] - c.device[0] for c in rec.calls()] == pytest.approx([300_000 + i for i in range(5)], abs=2)
    assert _Event.reads == 2 * 5 - 1  # a duration a call, a link of the chain between two
    for i in range(5, 23):
        timed(i, untimed=i == 20)
    assert _Event.reads == 9
    calls = rec.calls(last=8)
    assert [c.id for c in calls] == list(range(15, 23)) and calls[5].device is None
    got = [c.device for c in calls if c.device is not None]
    assert [hi - lo for lo, hi in got] == pytest.approx([300_000 + i for i in (15, 16, 17, 18, 19, 21, 22)], abs=2)
    assert all(b[0] - a[0] >= 1_000_000 for a, b in zip(got, got[1:]))
    assert len({rec._chain_of[c.id & 7] for c in calls if c.device is not None}) == 1
    with pytest.raises(profiling.Overflow):
        rec.calls(last=9)


def _call(i, start, end, device, spans):
    """A call made by hand: `spans` (name, start, end, parent) after the call's own."""
    own = profiling.Span("call", start, end, -1)
    return profiling.Call(i, "call", start, end, {}, device, (own, *(profiling.Span(*s) for s in spans)))


def test_idle_by_span_against_hand_made_intervals():
    calls = [
        _call(0, 0, 100, (20, 90), [("stage", 0, 30, 0), ("copy_out", 60, 100, 0)]),
        _call(1, 120, 200, (150, 210), [("stage", 120, 160, 0)]),
    ]
    # idle: 0-20 (stage 20), 90-100 (copy_out 10), 100-120 (outside 20), 120-150 (stage 30)
    got = dict(profiling.idle_by_span(calls))
    assert got == pytest.approx({"stage": 50e-9, "copy_out": 10e-9, "outside the program's spans": 20e-9})
    assert profiling.idle_by_span([]) == []
    no_device = [_call(0, 0, 100, None, [("stage", 10, 40, 0)])]
    assert dict(profiling.idle_by_span(no_device)) == pytest.approx({"call": 70e-9, "stage": 30e-9})


@pytest.mark.parametrize("drift", [0.0, 40e-6, -25e-6])
def test_clock_fit_recovers_offset_and_drift(drift):
    """45 s of calls: most find the card idle (their start event timed 2-6 us
    after the host stamp), some find it busy (up to 2 ms later)."""
    rng = np.random.default_rng(3)
    n, offset = 20000, 3.7e12
    host = np.sort(rng.uniform(0, 45e9, n)) + 1e12
    latency = 2e3 + rng.exponential(1e3, n)
    busy = rng.random(n) < 0.3
    latency[busy] += rng.uniform(0, 2e6, busy.sum())
    device = host + offset + drift * (host - host[0]) + latency
    clock = profiling.fit_clock(host, device)
    assert abs(clock.drift - drift) < 0.2e-6
    for h, d in zip(host[~busy][::500], device[~busy][::500]):
        # the instant the card timed a start event, back on the host clock: a few us after the stamp
        assert -1e3 < clock.host(d) - h < 10e3
    assert profiling.fit_clock([5.0], [9.0]) == profiling.Clock(5.0, 4.0, 0.0)


def test_denoiser_counts_the_padding_of_each_bucket(recorder, flagship):
    cfg, sd = flagship
    den = Denoiser(cfg, sd, device="cpu")
    hop = cfg.featurizer.hop_length
    lengths = [500, 3000, 9001, 17000]
    for length in lengths:
        den(np.zeros(length, np.float32))
    calls = profiling.calls("trunet.denoise.call")
    assert len({den._bucket(n, hop) for n in lengths}) == 4
    assert [c.counts for c in calls] == [{"samples": n, "padded_samples": den._bucket(n, hop) - n} for n in lengths]
    assert [s.name for s in calls[0].spans] == ["trunet.denoise.call", "trunet.denoise.stage",
                                                "trunet.denoise.copy_out"]
    assert all(c.device is None for c in calls)


def test_multistream_leaves_one_call_span_a_call(recorder, flagship):
    cfg, sd = flagship
    den = MultiStreamDenoiser(cfg, sd, num_streams=3, device="cpu")
    state = den.init_state()
    for _ in range(4):
        _, state = den.process_block(state, np.zeros((3, den.hop), np.float32))
    calls = profiling.calls()
    assert [c.name for c in calls] == ["trunet.stream.call"] * 4
    assert all([(s.name, s.parent) for s in c.spans] == [
        ("trunet.stream.call", -1), ("trunet.stream.adopt", 0), ("trunet.stream.stage", 0),
        ("trunet.stream.copy_out", 0)] for c in calls)


def test_train_step_leaves_its_span(recorder):
    from test_torch_train import TINY

    from tinyrecurrentunet_torch.config import NetworkConfig
    from tinyrecurrentunet_torch.train.state import create_train_state
    from tinyrecurrentunet_torch.train.step import make_train_step

    cfg = dataclasses.replace(load_config(CONFIG), network=NetworkConfig(**TINY))
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg)
    clean = torch.zeros(2, 4000)  # 0.25 s
    for _ in range(2):
        state, _ = step(state, clean, clean + 0.01)
    calls = profiling.calls("trunet.train.step")
    assert len(calls) == 2 and all([s.name for s in c.spans] == ["trunet.train.step", "trunet.train.copy_in"]
                                   for c in calls)

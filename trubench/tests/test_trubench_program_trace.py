"""The readers of the program's own recorder (`metrics/untraced_idle_share.*`,
`hop_device_ms.p50`, `pad_share.denoise`, `capture_s`) against a recorder
filled by hand: they read the window's calls, the last of the ring, and
none of a profiled slice after it; nothing where the ring holds too few or
has overwritten one; and the padding share is the closed form over one
pass of the offline pool."""

from __future__ import annotations

import pytest
from torch.profiler import ProfilerActivity, profile

from trubench import harness
from tinyrecurrentunet_torch.infer.denoise import Denoiser
from tinyrecurrentunet_torch.utils import profiling


def metric(name: str):
    return harness.load_module("metrics", name)


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def _timed_call(rec, name: str, device_ns: int, counts: dict | None = None):
    """A closed call with a device interval of `device_ns` on its chain,
    as the recorder settles one its events timed."""
    with profiling.span(name):
        for key, n in (counts or {}).items():
            profiling.count(key, n)
        call = rec._open
    c = call & rec._cmask
    rec._pair_of[c], rec._chain_of[c], rec._marks[c] = 0, 0, 1000 * call
    rec._dev_start[c], rec._dev_end[c] = 1000 * call, 1000 * call + device_ns


def _reading(**facts):
    return {"facts": {"window_s": 1e-3, **facts}, "slice": None}


def test_the_window_is_the_rings_last_calls_and_not_the_slice(recorder):
    for _ in range(3):  # set-up: a capture's long call, then two more
        _timed_call(recorder, "trunet.stream.call", 500_000)
    for _ in range(4):  # the window: 4 calls of 0.1 ms in 1 ms
        _timed_call(recorder, "trunet.stream.call", 100_000)
    with profile(activities=[ProfilerActivity.CPU]):  # the traced slice after the window
        for _ in range(2):
            with profiling.span("trunet.stream.call"):
                pass
    reading = _reading(call_ms=[1.0] * 4)
    assert metric("hop_device_ms.p50").read(reading) == pytest.approx(0.1)
    assert metric("untraced_idle_share.stream").read(reading) == pytest.approx(60.0)
    assert metric("untraced_idle_share.stream").read(_reading(call_ms=[1.0] * 5)) == pytest.approx(
        100 * (1 - 0.9e-3 / 1e-3))


def test_nothing_is_read_from_too_few_calls_or_an_overwritten_ring(recorder, monkeypatch):
    for _ in range(3):
        _timed_call(recorder, "trunet.stream.call", 100_000)
    names = ("untraced_idle_share.stream", "hop_device_ms.p50")
    assert all(metric(m).read(_reading(call_ms=[1.0] * 4)) is None for m in names)
    assert all(metric(m).read(_reading(call_ms=[])) is None for m in names)
    small = profiling.Recorder(calls=4, spans=16)
    monkeypatch.setattr(profiling, "RECORDER", small)
    for _ in range(6):
        _timed_call(small, "trunet.denoise.call", 100_000, {"samples": 3, "padded_samples": 1})
    reading = _reading(ms_per_audio_s=[1.0] * 4)
    assert metric("pad_share.denoise").read(reading) == pytest.approx(25.0)
    assert metric("untraced_idle_share.denoise").read(reading) == pytest.approx(60.0)
    reading = _reading(ms_per_audio_s=[1.0] * 5)
    assert metric("pad_share.denoise").read(reading) is None
    assert metric("untraced_idle_share.denoise").read(reading) is None


def test_calls_without_a_device_interval_give_no_idle_share(recorder):
    for _ in range(2):
        with profiling.span("trunet.stream.call"):
            pass
    assert metric("untraced_idle_share.stream").read(_reading(call_ms=[1.0] * 2)) is None


def test_pad_share_is_the_closed_form_over_one_pass_of_the_pool(recorder):
    cell = harness.load_json("workloads", "large16k-denoise-mixed")
    config = harness.load_json("configs", cell["config"])
    p, sr, hop = cell["params"], config["featurizer"]["sample_rate"], config["featurizer"]["hop_length"]
    # the pool's lengths, as traffic/denoise.py's pool() makes them
    lengths = [int(round(sr * p["min_s"] * (p["max_s"] / p["min_s"]) ** ((i + 0.5) / p["pool"])))
               for i in range(p["pool"])]
    buckets = [Denoiser._bucket(n, hop) for n in lengths]
    for n, b in zip(lengths, buckets):
        _timed_call(recorder, "trunet.denoise.call", 1, {"samples": n, "padded_samples": b - n})
    got = metric("pad_share.denoise").read(_reading(ms_per_audio_s=[1.0] * len(lengths)))
    assert got == pytest.approx(100.0 * (sum(buckets) - sum(lengths)) / sum(buckets))
    assert 5.5 <= got <= 6.5 and len(set(buckets)) == 22


def test_capture_s_sums_every_capture_span(recorder):
    for seconds in (0.25, 0.5):
        seq = recorder.begin("trunet.graph.capture")
        recorder._starts[seq] -= int(seconds * 1e9)
        recorder.end(seq)
    with profiling.span("trunet.stream.call"):
        with profiling.span("trunet.graph.capture"):
            pass
    got = metric("capture_s").read(_reading())
    assert 0.75 <= got < 0.8
    assert metric("capture_s").read({"facts": {}, "slice": None}) is None
    recorder.reset()
    assert metric("capture_s").read(_reading()) is None

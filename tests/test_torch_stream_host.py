"""The port's native host runtime (its copy of the ctypes bindings, built
from `cpp/` into `build/trunet_host/`), the stream CLI and the soak, on the
CPU.

Tolerances: the native WAV reader against the port's Python reader 1e-6
(both scale 16-bit PCM to float32; measured 0); a WAV written by the native
writer read back 1e-4 (16-bit quantisation, 1/32767 = 3.1e-5 a step);
`stream_file`'s output against `StreamingDenoiser.process` 2/32767, the
16-bit PCM of the output file (measured 3.1e-5).
"""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch.config import Config, FeaturizerConfig, NetworkConfig
from tinyrecurrentunet_torch.data.audio_io import read_wav, write_wav
from tinyrecurrentunet_torch.infer import stream as tstream
from tinyrecurrentunet_torch.infer.denoise import random_state_dict
from tinyrecurrentunet_torch.infer.soak import run_soak
from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser
from tinyrecurrentunet_torch.runtime import native as tnative

torch.set_num_threads(2)  # beside JAX's pools under several test workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
TINY = dict(
    encoder=((8, 5, 2), (16, 3, 1), (16, 5, 2), (16, 3, 2)),
    fgru_hidden=8, fgru_out=8, tgru_hidden=16, tgru_out=8,
    decoder=((8, 3, 2), (8, 5, 2), (8, 3, 1), (8, 5, 2)),
)


@pytest.fixture(scope="module")
def native():
    if not tnative.native_available():
        pytest.skip("no C++ compiler: the native host runtime cannot be built")
    return tnative.NativeLib()


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(Config(), featurizer=FeaturizerConfig(sample_rate=SR),
                              network=NetworkConfig(**TINY))
    return cfg, random_state_dict(cfg)


def test_library_is_built_from_cpp_into_build(native):
    path = tnative.library_path()
    assert path.exists() and path.parent == tnative.REPO_ROOT / "build" / "trunet_host"
    assert tnative.build() == path  # built once, then reused


def test_ring_push_pop_order(native):
    rb = tnative.RingBuffer(1024)
    data = np.arange(100, dtype=np.float32)
    assert rb.push(data) == 100 and rb.available == 100
    np.testing.assert_array_equal(rb.pop(100), data)
    assert rb.available == 0


def test_ring_capacity_limit(native):
    rb = tnative.RingBuffer(128)
    assert rb.push(np.ones(200, np.float32)) == 128
    assert rb.space == 0
    assert rb.pop(300).shape == (128,)


def test_ring_wraparound(native):
    rb = tnative.RingBuffer(100)
    for i in range(10):
        data = np.arange(64, dtype=np.float32) + i * 64
        assert rb.push(data) == 64
        np.testing.assert_array_equal(rb.pop(64), data)


def test_ring_threaded_producer_consumer(native):
    rb = tnative.RingBuffer(256)
    total = 50_000
    src = np.arange(total, dtype=np.float32)
    received, got = [], 0

    def producer():
        sent = 0
        while sent < total:
            sent += rb.push(src[sent : sent + 128])

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    for _ in range(10_000_000):
        if got >= total:
            break
        chunk = rb.pop(128)
        if len(chunk):
            received.append(chunk)
            got += len(chunk)
    thread.join(timeout=10.0)
    assert not thread.is_alive()
    np.testing.assert_array_equal(np.concatenate(received), src)


def test_native_wav_matches_python_io(native, tmp_path):
    x = (np.random.default_rng(0).standard_normal(5000) * 0.2).astype(np.float32)
    p1 = str(tmp_path / "py.wav")
    write_wav(p1, x, SR)
    data, sr = native.wav_read(p1)
    assert sr == SR
    np.testing.assert_allclose(data, read_wav(p1)[0], rtol=0, atol=1e-6)
    p2 = str(tmp_path / "native.wav")
    native.wav_write(p2, x, SR)
    back, sr2 = read_wav(p2)
    assert sr2 == SR
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-4)


def test_stream_host_block_flow_and_stats(native):
    host = tnative.StreamHost(block_size=128, capacity_blocks=8)
    assert host.pull_block(starved=True) is None  # underrun recorded
    host.feed(np.arange(128, dtype=np.float32))
    block = host.pull_block()
    np.testing.assert_array_equal(block, np.arange(128, dtype=np.float32))
    assert host.push_block(block * 2)
    np.testing.assert_array_equal(host.collect(128), block * 2)
    host.add_busy(0.01)
    stats = host.stats()
    assert stats["blocks_processed"] == 1
    assert stats["input_underruns"] == 1
    assert stats["output_overruns"] == 0
    assert stats["busy_seconds"] == pytest.approx(0.01)
    with pytest.raises(ValueError, match="takes 128"):
        host.push_block(np.zeros(64, np.float32))


@pytest.mark.parametrize("samples,chunk_frames", [(8000, 1), (3000, 2)])
def test_stream_file_on_cpu(native, tiny, tmp_path, samples, chunk_frames):
    cfg, sd = tiny
    audio = (np.random.default_rng(1).standard_normal(samples) * 0.1).astype(np.float32)
    inp, outp = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    write_wav(inp, audio, SR)
    stats = tstream.stream_file(cfg, sd, inp, outp, chunk_frames=chunk_frames, device="cpu")
    hop = 128 * chunk_frames
    assert stats["blocks_processed"] == -(-samples // hop)
    assert stats["input_underruns"] == 0 and stats["output_overruns"] == 0
    enhanced, sr = read_wav(outp)
    assert sr == SR and len(enhanced) == samples and np.isfinite(enhanced).all()
    want, _ = StreamingDenoiser(cfg, sd, chunk_frames=chunk_frames, device="cpu").process(read_wav(inp)[0])
    np.testing.assert_allclose(enhanced, np.clip(want, -1, 1), rtol=0, atol=2 / 32767)


def test_soak_on_cpu(native, tiny):
    cfg, sd = tiny
    stats = run_soak(cfg, sd, duration_s=0.5, warmup_blocks=2, device="cpu")
    for key in ("seconds", "blocks", "sample_rate", "xruns", "deadline_misses", "median_ms",
                "p99_ms", "max_ms", "jitter_ms", "duty_cycle"):
        assert f"streaming_soak_{key}" in stats
    assert stats["streaming_soak_blocks"] > 0
    assert stats["streaming_soak_device"] == "cpu"
    assert stats["streaming_soak_median_ms"] > 0


def test_list_devices_without_sounddevice(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "sounddevice", None)  # import raises
    lines = tstream.list_devices()
    assert lines[0].startswith("sounddevice/PortAudio wheel not installed")
    assert any("ring:input" in line for line in lines)
    with pytest.raises(ImportError, match="sounddevice"):
        tstream.stream_microphone(None, {})


def test_stream_cli_random_init_on_cpu(native, tmp_path, capsys):
    inp, outp = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    write_wav(inp, (np.random.default_rng(2).standard_normal(4000) * 0.1).astype(np.float32), SR)
    tstream.main(["-c", os.path.join(REPO, "config", "tiny16k.json"), "--random_init", "--device", "cpu",
                  "--input", inp, "--output", outp])
    out, sr = read_wav(outp)
    assert sr == SR and out.shape == (4000,) and np.isfinite(out).all()
    assert "blocks_processed: 32" in capsys.readouterr().out
    tstream.main(["--list-devices"])
    assert "native host endpoints" in capsys.readouterr().out

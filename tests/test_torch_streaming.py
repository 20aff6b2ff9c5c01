"""The port's streaming path on the CPU: the step functions, the featurizer's
streaming step, `StreamingDenoiser` and `MultiStreamDenoiser`, against the
JAX package and against the port's own offline path.

Tolerances (absolute unless said otherwise; measured on this machine):
- unwrap_step against JAX: bit-equal on the same phases (measured 0).
  Against the port's offline `unwrap`: 1e-3. The streaming correction is a
  running sum taken one frame at a time, the offline one a blocked cumsum;
  at |unwrapped| ~480 rad (321 frames) one float32 step is 3e-5, and the
  two orders end 4.0e-4 apart (13 steps).
- pcen_step: 1e-5 against JAX (jnp.power vs torch.pow, measured 4.8e-7)
  and against the offline blocked smoother (measured 1.2e-6); outputs ~5.
- gru_step against JAX over 320 carried steps: 1e-6 (measured 1.3e-7).
- step_from_spec_frame against JAX on the same spectrum: 1e-5 on log-mag
  and PCEN (measured 4.8e-7), 2e-4 on the demod channels (measured 3.1e-5:
  jnp.angle and torch.angle differ in the last bit, and the ~480 rad
  unwrapped phase turns that into whole float32 steps of 3e-5); against the
  port's offline `features_from_spec`: 1e-5 / 1e-3 (measured 1.2e-6 /
  4.0e-4, the unwrap's summation order as above).
- process_spec_frame against the offline pipeline: rtol 1e-4, atol 1e-6,
  the JAX package's own bound (tests/test_infer.py; measured 3.1e-7).
- Block streaming against offline at the 3-hop shift after 60 blocks:
  < 5e-2 of the peak (measured 9.8e-4); one hop off: > 0.2 (measured 1.4).
- chunk_frames=4 against single steps, N streams against single streams:
  rtol 1e-4, atol 1e-6 (measured 3.0e-8 and 1.5e-8).
- The port's StreamingDenoiser / MultiStreamDenoiser against JAX's on the
  same weights (tiny width, 0.25 s / 0.125 s): 1e-5 (measured 6.0e-8). The
  slice as a whole, flagship with the shipped weights, 0.5 s: 1e-4
  (measured 1.8e-6, peak 0.27; the demod features differ as above, and over
  a longer clip more: the offline denoiser is 4.2e-5 from JAX at 4 s).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyrecurrentunet_torch.config import Config as TConfig
from tinyrecurrentunet_torch.config import FeaturizerConfig as TFeatCfg
from tinyrecurrentunet_torch.config import NetworkConfig as TNetCfg
from tinyrecurrentunet_torch.config import load_config as tload_config
from tinyrecurrentunet_torch.infer import StreamingDenoiser, StreamState
from tinyrecurrentunet_torch.infer.multistream import MultiStreamDenoiser
from tinyrecurrentunet_torch.models import TRUNet as TorchTRUNet
from tinyrecurrentunet_torch.models.phm import denoise_output_to_audio
from tinyrecurrentunet_torch.ops import gru as tgru
from tinyrecurrentunet_torch.signal import Featurizer as TFeaturizer
from tinyrecurrentunet_torch.signal import pcen as tpcen
from tinyrecurrentunet_torch.signal import phase as tphase
from tinyrecurrentunet_torch.weights import load_pretrained, state_dict_from_variables
from tinyrecurrentunet_tpu.config import Config as JConfig
from tinyrecurrentunet_tpu.config import FeaturizerConfig as JFeatCfg
from tinyrecurrentunet_tpu.config import NetworkConfig as JNetCfg
from tinyrecurrentunet_tpu.config import load_config as jload_config
from tinyrecurrentunet_tpu.infer.multistream import MultiStreamDenoiser as JMultiStream
from tinyrecurrentunet_tpu.infer.streaming import StreamingDenoiser as JStreaming
from tinyrecurrentunet_tpu.models import TRUNet as JaxTRUNet
from tinyrecurrentunet_tpu.ops.gru import gru_step as jgru_step
from tinyrecurrentunet_tpu.signal import Featurizer as JFeaturizer
from tinyrecurrentunet_tpu.signal.pcen import pcen_step as jpcen_step
from tinyrecurrentunet_tpu.signal.phase import unwrap_step as junwrap_step
from tinyrecurrentunet_tpu.train.checkpoint import load_pretrained_variables

torch.set_num_threads(2)  # beside JAX's pools under several test workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "config", "proc16k.json")
ARTIFACT = os.path.join(REPO, "artifacts", "TRUNet-proc")
SR = 16000
HOP = 128
TINY = dict(
    encoder=((8, 5, 2), (16, 3, 1), (16, 5, 2), (16, 3, 2)),
    fgru_hidden=8, fgru_out=8, tgru_hidden=16, tgru_out=8,
    decoder=((8, 3, 2), (8, 5, 2), (8, 3, 1), (8, 5, 2)),
)


def _audio(samples, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / SR
    return (0.2 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(samples)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX variables, port config, port state_dict) at the tests' tiny width."""
    jcfg = dataclasses.replace(JConfig(), featurizer=JFeatCfg(sample_rate=SR), network=JNetCfg(**TINY))
    tcfg = dataclasses.replace(TConfig(), featurizer=TFeatCfg(sample_rate=SR), network=TNetCfg(**TINY))
    variables = JaxTRUNet(jcfg.network).init(jax.random.PRNGKey(0), jnp.zeros((2, 33, 4)))
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32), variables)
    # non-trivial running statistics, so they must flow through the converter
    rng = np.random.default_rng(0)
    variables["batch_stats"] = jax.tree.map(
        lambda a: (a + rng.uniform(0.05, 0.5, a.shape)).astype(np.float32), variables["batch_stats"])
    return jcfg, variables, tcfg, state_dict_from_variables(variables)


@pytest.fixture(scope="module")
def spectrum():
    """The STFT (321, 257) of a 2.6 s tone in noise, from the port."""
    fz = TFeaturizer(TFeatCfg(sample_rate=SR))
    return fz.spectrogram(torch.from_numpy(_audio(320 * HOP)))


def _offline(tcfg, state_dict, audio):
    """The port's offline pipeline (no bucket padding) on the CPU."""
    model = TorchTRUNet(tcfg.network)
    model.load_state_dict(state_dict)
    fz = TFeaturizer(tcfg.featurizer)
    with torch.no_grad():
        spec = fz.spectrogram(torch.from_numpy(audio))
        out, _ = model.eval()(fz.features_from_spec(spec))
        wave = denoise_output_to_audio(out, fz, tcfg.network, length=len(audio), mixture_spec=spec)
    return spec, wave.numpy()


def test_unwrap_step_matches_jax_and_offline(spectrum):
    phase = spectrum.angle()
    prev, corr, got = phase[0], torch.zeros(phase.shape[-1]), []
    for t in range(phase.shape[0]):
        u, corr = tphase.unwrap_step(phase[t], prev, corr)
        prev = phase[t]
        got.append(u)
    got = torch.stack(got).numpy()

    def scan(carry, p):
        prev, corr, n = carry
        u, corr = junwrap_step(p, jnp.where(n > 0, prev, p), corr)
        return (p, corr, n + 1), u

    zeros = jnp.zeros(phase.shape[-1])
    _, want = jax.jit(lambda ph: jax.lax.scan(scan, (zeros, zeros, 0), ph))(jnp.asarray(phase.numpy()))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_allclose(got, tphase.unwrap(phase, dim=0).numpy(), rtol=0, atol=1e-3)


def test_pcen_step_matches_jax_and_offline(spectrum):
    mag = spectrum.abs()
    m, got = torch.zeros(mag.shape[-1]), []
    for t in range(mag.shape[0]):
        out, m = tpcen.pcen_step(mag[t], m)
        got.append(out)
    got = torch.stack(got).numpy()

    def scan(m, x):
        out, m = jpcen_step(x, m)
        return m, out

    _, want = jax.jit(lambda x: jax.lax.scan(scan, jnp.zeros(mag.shape[-1]), x))(jnp.asarray(mag.numpy()))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, tpcen.pcen(mag, dim=0).numpy(), rtol=0, atol=1e-5)


def test_gru_step_matches_jax():
    rng = np.random.default_rng(3)
    hidden, d, rows, steps = 16, 8, 5, 320
    weights = [rng.uniform(-0.25, 0.25, s).astype(np.float32)
               for s in ((d, 3 * hidden), (hidden, 3 * hidden), (3 * hidden,), (3 * hidden,))]
    xs = rng.standard_normal((steps, rows, d)).astype(np.float32)

    def scan(h, x):
        h = jgru_step(x, h, *weights)
        return h, h

    _, want = jax.jit(lambda x: jax.lax.scan(scan, jnp.zeros((rows, hidden)), x))(jnp.asarray(xs))
    tw = [torch.from_numpy(w) for w in weights]
    h, got = torch.zeros(rows, hidden), []
    for t in range(steps):
        h = tgru.gru_step(torch.from_numpy(xs[t]), h, *tw)
        got.append(h)
    np.testing.assert_allclose(torch.stack(got).numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_featurizer_step_matches_jax_and_offline(spectrum):
    tfz, jfz = TFeaturizer(TFeatCfg(sample_rate=SR)), JFeaturizer(JFeatCfg(sample_rate=SR))
    state, got = tfz.init_state(), []
    for t in range(spectrum.shape[0]):
        feats, state = tfz.step_from_spec_frame(spectrum[t], state)
        got.append(feats)
    got = torch.stack(got).numpy()
    assert int(state.frame_count) == spectrum.shape[0]

    def scan(s, x):
        out, s = jfz.step_from_spec_frame(x, s)
        return s, out

    _, want = jax.jit(lambda sp: jax.lax.scan(scan, jfz.init_state(), sp))(jnp.asarray(spectrum.numpy()))
    want = np.asarray(want)
    offline = tfz.features_from_spec(spectrum).numpy()
    for c, (atol_jax, atol_offline) in enumerate(((1e-5, 1e-5), (1e-5, 1e-5), (2e-4, 1e-3), (2e-4, 1e-3))):
        np.testing.assert_allclose(got[..., c], want[..., c], rtol=0, atol=atol_jax)
        np.testing.assert_allclose(got[..., c], offline[..., c], rtol=0, atol=atol_offline)


def test_featurizer_step_with_stream_axes_equals_single_streams(spectrum):
    """frame_count with a leading stream axis: each stream starts on its own.
    1e-6: torch.pow vectorised over another length rounds otherwise in the
    last bit (measured 2.4e-7 on one PCEN bin)."""
    fz = TFeaturizer(TFeatCfg(sample_rate=SR))
    specs = torch.stack([spectrum[:40], spectrum[40:80]])  # (2, 40, F)
    state = fz.init_state((2,))
    singles = [fz.init_state(), fz.init_state()]
    for t in range(40):
        feats, state = fz.step_from_spec_frame(specs[:, t], state)
        for i in range(2):
            want, singles[i] = fz.step_from_spec_frame(specs[i, t], singles[i])
            torch.testing.assert_close(feats[i], want, rtol=0, atol=1e-6)
    assert state.frame_count.tolist() == [40, 40]


def test_spec_frame_streaming_is_exact(tiny):
    """Fed the offline STFT frames, the per-frame streaming pipeline
    reproduces the offline output in the interior: frame u covers padded
    samples [u h, (u+1) h) = offline samples [(u-2) h, (u-1) h)."""
    _, _, tcfg, sd = tiny
    audio = _audio(SR)
    spec, offline = _offline(tcfg, sd, audio)
    den = StreamingDenoiser(tcfg, sd, device="cpu")
    state, blocks = den.init_state(), []
    for u in range(spec.shape[0]):
        out, state = den.process_spec_frame(state, spec[u])
        blocks.append(out.numpy())
    streamed = np.concatenate(blocks)
    u0, u1 = 4, spec.shape[0] - 4
    np.testing.assert_allclose(streamed[u0 * HOP : u1 * HOP], offline[(u0 - 2) * HOP : (u1 - 2) * HOP],
                               rtol=1e-4, atol=1e-6)


def test_block_alignment_with_offline(tiny):
    """Block streaming (zero-fill start) meets the offline output at the
    3-hop shift once the start has decayed; other shifts are far off."""
    _, _, tcfg, sd = tiny
    audio = _audio(SR)
    _, offline = _offline(tcfg, sd, audio)
    streamed, _ = StreamingDenoiser(tcfg, sd, device="cpu").process(audio)
    k0, k1 = 60, 120
    ref = offline[(k0 - 3) * HOP : (k1 - 3) * HOP]
    scale = np.abs(ref).max()
    assert np.abs(streamed[k0 * HOP : k1 * HOP] - ref).max() / scale < 5e-2
    assert np.abs(streamed[(k0 + 1) * HOP : (k1 + 1) * HOP] - ref).max() / scale > 0.2


def test_chunked_equals_single_steps(tiny):
    _, _, tcfg, sd = tiny
    audio = _audio(8192)
    single, _ = StreamingDenoiser(tcfg, sd, chunk_frames=1, device="cpu").process(audio)
    chunked, _ = StreamingDenoiser(tcfg, sd, chunk_frames=4, device="cpu").process(audio)
    np.testing.assert_allclose(chunked, single, rtol=1e-4, atol=1e-6)


def test_stateful_progress_and_full_length(tiny):
    _, _, tcfg, sd = tiny
    audio = _audio(1000)
    den = StreamingDenoiser(tcfg, sd, device="cpu")
    state = den.init_state()
    out1, state = den.process_block(state, audio[:HOP])
    assert isinstance(state, StreamState) and out1.shape == (HOP,)
    assert int(state.feat_state.frame_count) == 1
    _, state = den.process_block(state, torch.from_numpy(audio[HOP : 2 * HOP]))
    assert int(state.feat_state.frame_count) == 2
    assert state.tgru_h.shape == (1, den.model.bottleneck_freqs(257), 16)
    assert state.in_buffer.shape == (512,)
    streamed, state = den.process(audio)  # not a multiple of the hop
    assert streamed.shape == (1000,) and np.isfinite(streamed).all()
    assert int(state.feat_state.frame_count) == 8


@pytest.mark.parametrize("chunk_frames", [1, 3])
def test_streaming_matches_jax(tiny, chunk_frames):
    jcfg, variables, tcfg, sd = tiny
    audio = _audio(4000, seed=1)
    want, _ = JStreaming(jcfg, variables, chunk_frames=chunk_frames).process(audio)
    got, _ = StreamingDenoiser(tcfg, sd, chunk_frames=chunk_frames, device="cpu").process(audio)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_flagship_streaming_matches_jax():
    """The slice as a whole: the shipped flagship (config/proc16k.json,
    artifacts/TRUNet-proc) streams a 0.5 s clip as the JAX package does."""
    jcfg = jload_config(CONFIG)
    init = JaxTRUNet(jcfg.network).init(jax.random.PRNGKey(0), jnp.zeros((2, 257, 4)))
    params, stats = load_pretrained_variables(ARTIFACT, init["params"], init["batch_stats"], cfg=jcfg)
    audio = _audio(SR // 2, seed=2)
    want, _ = JStreaming(jcfg, {"params": params, "batch_stats": stats}).process(audio)
    tcfg = tload_config(CONFIG)
    got, state = StreamingDenoiser(tcfg, load_pretrained(ARTIFACT, tcfg), device="cpu").process(audio)
    assert got.shape == audio.shape and np.isfinite(got).all()
    assert int(state.feat_state.frame_count) == len(audio) // HOP + 1
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def test_flagship_streaming_of_a_silence_led_clip_matches_jax():
    """0.5 s of digital silence, then 0.5 s of tone and noise, streamed by
    the shipped flagship: the silent frames' bins are exactly 0 and take
    phase 0 in both packages (with the phase of torch.fft.rfft's -0.0, pi,
    the output lay 5.5e-2 from JAX's)."""
    jcfg = jload_config(CONFIG)
    init = JaxTRUNet(jcfg.network).init(jax.random.PRNGKey(0), jnp.zeros((2, 257, 4)))
    params, stats = load_pretrained_variables(ARTIFACT, init["params"], init["batch_stats"], cfg=jcfg)
    audio = np.concatenate([np.zeros(SR // 2, np.float32), _audio(SR // 2, seed=3)])
    want, _ = JStreaming(jcfg, {"params": params, "batch_stats": stats}).process(audio)
    tcfg = tload_config(CONFIG)
    got, _ = StreamingDenoiser(tcfg, load_pretrained(ARTIFACT, tcfg), device="cpu").process(audio)
    assert got.shape == audio.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def _three_streams(samples=4096):
    rng = np.random.default_rng(5)
    return np.stack([_audio(samples), (0.1 * rng.standard_normal(samples)).astype(np.float32),
                     np.zeros(samples, np.float32)])


def test_multistream_matches_independent_streams(tiny):
    _, _, tcfg, sd = tiny
    streams = _three_streams()
    batched, state = MultiStreamDenoiser(tcfg, sd, num_streams=3, chunk_frames=2, device="cpu").process(streams)
    assert batched.shape == streams.shape
    assert state.feat_state.frame_count.tolist() == [32, 32, 32]
    single = StreamingDenoiser(tcfg, sd, chunk_frames=2, device="cpu")
    for i in range(3):
        np.testing.assert_allclose(batched[i], single.process(streams[i])[0], rtol=1e-4, atol=1e-6)


def test_multistream_matches_jax(tiny):
    jcfg, variables, tcfg, sd = tiny
    streams = _three_streams(2000)
    want, _ = JMultiStream(jcfg, variables, num_streams=3, chunk_frames=2).process(streams)
    got, _ = MultiStreamDenoiser(tcfg, sd, num_streams=3, chunk_frames=2, device="cpu").process(streams)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_multistream_refuses_wrong_block_shape(tiny):
    _, _, tcfg, sd = tiny
    den = MultiStreamDenoiser(tcfg, sd, num_streams=3, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        den.process_block(den.init_state(), np.zeros((2, HOP), np.float32))


def test_streaming_on_cuda_without_a_card_raises(tiny):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda tests cover this path")
    _, _, tcfg, sd = tiny
    for make in (lambda: StreamingDenoiser(tcfg, sd), lambda: MultiStreamDenoiser(tcfg, sd, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()

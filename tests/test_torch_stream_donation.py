"""The streaming step in place, on the CPU: the state contract of
`StreamingDenoiser` and `MultiStreamDenoiser` (the state a call returns is
the denoiser's buffers; any other state is copied in, as the JAX package's
jitted step takes its donated state), held bit for bit against the step
computed functionally (the same `_spectra` and `_advance` on the given
state, writing no buffer) and against the JAX package's streaming.

On a card the same body is captured into a CUDA graph and replayed
(tests/test_torch_cuda.py holds the replay against the body).

Tolerances: against the functional step and against a fresh denoiser, 0
(the same operations in the same order on the same values); against JAX
1e-5, as tests/test_torch_streaming.py's test_streaming_matches_jax
(measured there 6.0e-8 at the tiny width).
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
from tinyrecurrentunet_torch.ops import cuda_gru
from tinyrecurrentunet_torch.signal import Featurizer as TFeaturizer
from tinyrecurrentunet_torch.signal.features import FeaturizerState
from tinyrecurrentunet_torch.weights import state_dict_from_variables
from tinyrecurrentunet_tpu.config import Config as JConfig
from tinyrecurrentunet_tpu.config import FeaturizerConfig as JFeatCfg
from tinyrecurrentunet_tpu.config import NetworkConfig as JNetCfg
from tinyrecurrentunet_tpu.config import load_config as jload_config
from tinyrecurrentunet_tpu.infer.streaming import StreamingDenoiser as JStreaming
from tinyrecurrentunet_tpu.models import TRUNet as JaxTRUNet

torch.set_num_threads(2)  # beside JAX's pools under several test workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOP = 128
TINY = dict(
    encoder=((8, 5, 2), (16, 3, 1), (16, 5, 2), (16, 3, 2)),
    fgru_hidden=8, fgru_out=8, tgru_hidden=16, tgru_out=8,
    decoder=((8, 3, 2), (8, 5, 2), (8, 3, 1), (8, 5, 2)),
)


def _audio(samples, seed=0, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / sr
    return (0.2 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(samples)).astype(np.float32)


def _variables(jcfg):
    variables = JaxTRUNet(jcfg.network).init(jax.random.PRNGKey(0), jnp.zeros((2, 33, 4)))
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32), variables)
    rng = np.random.default_rng(0)
    variables["batch_stats"] = jax.tree.map(
        lambda a: (a + rng.uniform(0.05, 0.5, a.shape)).astype(np.float32), variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX variables, port config, port state_dict) at 16 kHz."""
    jcfg = dataclasses.replace(JConfig(), featurizer=JFeatCfg(sample_rate=16000), network=JNetCfg(**TINY))
    tcfg = dataclasses.replace(TConfig(), featurizer=TFeatCfg(sample_rate=16000), network=TNetCfg(**TINY))
    variables = _variables(jcfg)
    return jcfg, variables, tcfg, state_dict_from_variables(variables)


def _blocks(audio, hop=HOP):
    return [audio[i : i + hop] for i in range(0, len(audio) - hop + 1, hop)]


def _functional(den, state, block):
    """One hop computed from `state` into fresh tensors, writing no buffer:
    the step as `process_block` computed it before it ran in place."""
    with torch.inference_mode():
        specs, in_buffer = den._spectra(state.in_buffer[None], torch.as_tensor(block)[None])
        out, feat, tgru_h, ola = den._advance(
            specs, FeaturizerState(*(t[None] for t in state.feat_state)), state.tgru_h, state.ola_buffer[None])
    return out[0], StreamState(in_buffer[0], FeaturizerState(*(t[0] for t in feat)), tgru_h, ola[0])


def _flat(state):
    return [state.in_buffer, *state.feat_state, state.tgru_h, state.ola_buffer]


def _assert_states_equal(got, want):
    for a, b in zip(_flat(got), _flat(want)):
        assert torch.equal(a, b)


def _snapshot(state):
    return StreamState(state.in_buffer.clone(), FeaturizerState(*(t.clone() for t in state.feat_state)),
                       state.tgru_h.clone(), state.ola_buffer.clone())


def test_restart_from_init_state_mid_stream_is_a_fresh_stream(tiny):
    _, _, tcfg, sd = tiny
    first, second = _blocks(_audio(12 * HOP, seed=1)), _blocks(_audio(10 * HOP, seed=2))
    den = StreamingDenoiser(tcfg, sd, device="cpu")
    state = den.init_state()
    for block in first:
        _, state = den.process_block(state, block)
    state = den.init_state()
    restarted = []
    for block in second:
        out, state = den.process_block(state, block)
        restarted.append(out)
    fresh = StreamingDenoiser(tcfg, sd, device="cpu")
    state = fresh.init_state()
    for got, block in zip(restarted, second):
        out, state = fresh.process_block(state, block)
        assert torch.equal(got, out)


def test_an_output_is_not_overwritten_by_later_calls(tiny):
    _, _, tcfg, sd = tiny
    den = StreamingDenoiser(tcfg, sd, chunk_frames=2, device="cpu")
    blocks = _blocks(_audio(16 * HOP, seed=3), 2 * HOP)
    state = den.init_state()
    outs, kept = [], []
    for block in blocks:
        out, state = den.process_block(state, block)
        outs.append(out)
        kept.append(out.clone())
    for out, copy in zip(outs, kept):
        assert torch.equal(out, copy)
    assert len({out.data_ptr() for out in outs}) == len(outs)


def test_the_returned_state_is_the_buffers_and_is_consumed_by_the_next_call(tiny):
    """The JAX package's donate_argnums=(1,): the state a call returned is
    advanced in place by the next call."""
    _, _, tcfg, sd = tiny
    den = StreamingDenoiser(tcfg, sd, device="cpu")
    blocks = _blocks(_audio(3 * HOP, seed=4))
    _, first = den.process_block(den.init_state(), blocks[0])
    before = _snapshot(first)
    _, second = den.process_block(first, blocks[1])
    assert second is first and int(first.feat_state.frame_count) == 2
    _, want = _functional(den, before, blocks[1])
    _assert_states_equal(second, want)


def test_state_from_process_spec_frame_is_copied_in(tiny):
    _, _, tcfg, sd = tiny
    den = StreamingDenoiser(tcfg, sd, device="cpu")
    audio = _audio(8 * HOP, seed=5)
    spec = TFeaturizer(tcfg.featurizer).spectrogram(torch.from_numpy(audio))
    state = den.init_state()
    for u in range(4):
        _, state = den.process_spec_frame(state, spec[u])
    block = audio[4 * HOP : 5 * HOP]
    want_out, want_state = _functional(den, state, block)
    got_out, got_state = den.process_block(state, block)
    assert torch.equal(got_out, want_out)
    _assert_states_equal(got_state, want_state)
    assert int(got_state.feat_state.frame_count) == 5


def test_state_from_another_denoiser_is_copied_in(tiny):
    """B continues from A's state: B's buffers take a copy, A's stay A's."""
    _, _, tcfg, sd = tiny
    a, b = StreamingDenoiser(tcfg, sd, device="cpu"), StreamingDenoiser(tcfg, sd, device="cpu")
    state_a, state_b = a.init_state(), b.init_state()
    for block in _blocks(_audio(9 * HOP, seed=6)):
        _, state_a = a.process_block(state_a, block)
    for block in _blocks(_audio(5 * HOP, seed=7)):
        _, state_b = b.process_block(state_b, block)
    block = _audio(HOP, seed=8)
    kept_a = _snapshot(state_a)
    want_out, want_state = _functional(b, state_a, block)
    got_out, got_state = b.process_block(state_a, block)
    assert got_state is state_b
    assert torch.equal(got_out, want_out)
    _assert_states_equal(got_state, want_state)
    _assert_states_equal(state_a, kept_a)


def test_multistream_state_from_another_denoiser_is_copied_in(tiny):
    """B takes A's state mid-stream and streams on as A does from it."""
    _, _, tcfg, sd = tiny
    a = MultiStreamDenoiser(tcfg, sd, num_streams=3, chunk_frames=2, device="cpu")
    b = MultiStreamDenoiser(tcfg, sd, num_streams=3, chunk_frames=2, device="cpu")
    streams = np.stack([_audio(14 * HOP, seed=s) for s in (9, 10, 11)])
    calls = [streams[:, i : i + 2 * HOP] for i in range(0, streams.shape[1], 2 * HOP)]
    state_a = a.init_state()
    for blocks in calls[:4]:
        _, state_a = a.process_block(state_a, blocks)
    _, state_b = b.process_block(b.init_state(), calls[-1])
    kept_a = [t.clone() for t in _flat(state_a)]
    got, state = [], state_a
    for blocks in calls[4:]:
        out, state = b.process_block(state, blocks)
        got.append(out)
    assert state is state_b
    for mine, kept in zip(_flat(state_a), kept_a):
        assert torch.equal(mine, kept)
    for blocks, out in zip(calls[4:], got):
        want, state_a = a.process_block(state_a, blocks)
        assert torch.equal(out, want)
    for x, y in zip(_flat(state_a), _flat(state_b)):
        assert torch.equal(x, y)


def test_hand_driven_stream_with_a_foreign_restart_matches_jax(tiny):
    """A streams 10 hops, then continues from B's state after B's 6 hops:
    the port's denoisers against the JAX package's, driven the same way."""
    jcfg, variables, tcfg, sd = tiny
    x, y = _blocks(_audio(20 * HOP, seed=12)), _blocks(_audio(6 * HOP, seed=13))
    ja, jb = JStreaming(jcfg, variables), JStreaming(jcfg, variables)
    ta, tb = StreamingDenoiser(tcfg, sd, device="cpu"), StreamingDenoiser(tcfg, sd, device="cpu")
    want, got = [], []
    js, ts = ja.init_state(), ta.init_state()
    for block in x[:10]:
        out, js = ja.process_block(js, block)
        want.append(np.asarray(out))
        out, ts = ta.process_block(ts, block)
        got.append(out.numpy())
    jsb, tsb = jb.init_state(), tb.init_state()
    for block in y:
        out, jsb = jb.process_block(jsb, block)
        want.append(np.asarray(out))
        out, tsb = tb.process_block(tsb, block)
        got.append(out.numpy())
    js, ts = jsb, tsb
    for block in x[10:]:
        out, js = ja.process_block(js, block)
        want.append(np.asarray(out))
        out, ts = ta.process_block(ts, block)
        got.append(out.numpy())
    assert int(ts.feat_state.frame_count) == len(y) + len(x) - 10
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), rtol=0, atol=1e-5)


def test_48k_two_hops_a_call_matches_jax():
    """The JAX package's promoted 48 kHz mode (bench.py "chunked2"): two
    hops a call, proc48k's featurizer, the tiny network."""
    path = os.path.join(REPO, "config", "proc48k.json")
    jcfg, tcfg = jload_config(path), tload_config(path)
    jcfg = dataclasses.replace(jcfg, network=dataclasses.replace(jcfg.network, **TINY))
    tcfg = dataclasses.replace(tcfg, network=dataclasses.replace(tcfg.network, **TINY))
    assert tcfg.featurizer.sample_rate == 48000
    variables = _variables(jcfg)
    audio = _audio(12000, seed=14, sr=48000)
    want, _ = JStreaming(jcfg, variables, chunk_frames=2).process(audio)
    got, state = StreamingDenoiser(tcfg, state_dict_from_variables(variables), chunk_frames=2,
                                   device="cpu").process(audio)
    assert int(state.feat_state.frame_count) == -(-len(audio) // (2 * HOP)) * 2
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_wrong_block_or_state_shape_raises(tiny):
    _, _, tcfg, sd = tiny
    den = StreamingDenoiser(tcfg, sd, chunk_frames=2, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        den.process_block(den.init_state(), np.zeros(HOP, np.float32))
    multi = MultiStreamDenoiser(tcfg, sd, num_streams=2, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        den.process_block(multi.init_state(), np.zeros(2 * HOP, np.float32))


def test_replay_tally_adds_to_the_launch_counts():
    """What a replay of a captured graph counts: the tally its capture
    recorded, kernel by kernel and path by path."""
    cuda_gru.reset_launch_counts()
    tally = {"gru_fwd": {"registers": 3}}
    for _ in range(4):
        cuda_gru.add_launches(tally)
    cuda_gru.add_launches({"gru_fwd": {"cluster": 3}, "gru_bwd": {"general": 1}})
    counts = cuda_gru.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "gru_fwd": 15, "gru_bwd": 1}
    assert cuda_gru.launch_paths() == {"gru_fwd": {"registers": 12, "cluster": 3}, "gru_bwd": {"general": 1}}
    assert cuda_gru.launches == 15
    with cuda_gru.capture_tally() as recorded:  # no capture on the CPU: nothing recorded
        assert recorded == {}
    assert cuda_gru._capture is None
    cuda_gru.reset_launch_counts()

"""Real-time streaming CLI, counterpart of `tinyrecurrentunet_tpu/infer/stream.py`.

A producer thread (a microphone through sounddevice when it is installed,
else a WAV file, paced at real time with --realtime) feeds the native
stream host's lock-free input ring; the inference loop pulls hop-sized
blocks, runs the streaming step (`StreamingDenoiser`, TGRU and featurizer
state carried on the device) and pushes the denoised block to the output
ring, from which the consumer (speaker callback or output file) drains it.
The native host counts deadline misses as xruns.

Usage:
    # file-driven real-time simulation (reports RTF and xruns):
    python -m tinyrecurrentunet_torch.infer.stream -c config/proc16k.json \
        --ckpt_iter pretrained --input noisy.wav --output enhanced.wav [--realtime] [--device cpu]

    # live duplex audio (needs the sounddevice wheel and PortAudio):
    python -m tinyrecurrentunet_torch.infer.stream -c config/proc16k.json --ckpt_iter pretrained --mic

`--random_init` draws the weights from the config's seed instead of
reading a checkpoint.
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from tinyrecurrentunet_torch.config import Config, load_config
from tinyrecurrentunet_torch.data.audio_io import read_wav, write_wav
from tinyrecurrentunet_torch.infer.streaming import StreamingDenoiser


def stream_file(
    cfg: Config,
    state_dict: dict,
    input_path: str,
    output_path: str,
    realtime: bool = False,
    chunk_frames: int = 1,
    device="cuda",
) -> dict:
    """Stream a WAV through the native host and the streaming step; returns stats."""
    from tinyrecurrentunet_torch.runtime import StreamHost

    audio, sr = read_wav(input_path)
    if audio.ndim > 1:
        audio = audio[0]
    if sr != cfg.featurizer.sample_rate:
        raise ValueError(f"input is {sr} Hz, config wants {cfg.featurizer.sample_rate}")

    hop = cfg.featurizer.hop_length * chunk_frames
    block_seconds = hop / sr
    length = len(audio)
    audio = np.pad(audio, (0, (-length) % hop))
    num_blocks = len(audio) // hop

    sd = StreamingDenoiser(cfg, state_dict, chunk_frames=chunk_frames, device=device)
    # warm the step (and build the kernels) before the clock starts
    sd.process_block(sd.init_state(), np.zeros(hop, np.float32))[0].cpu()
    state = sd.init_state()

    host = StreamHost(block_size=hop)
    stop = threading.Event()

    def producer():
        for i in range(num_blocks):
            if realtime:
                time.sleep(block_seconds)
            block = audio[i * hop : (i + 1) * hop]
            sent = host.feed(block)
            while sent < hop and not stop.is_set():  # input ring full: wait for the consumer
                time.sleep(block_seconds / 4)
                sent += host.feed(block[sent:])

    thread = threading.Thread(target=producer, daemon=True)
    out_blocks = []
    start = time.perf_counter()
    thread.start()
    processed = 0
    try:
        while processed < num_blocks:
            block = host.pull_block(starved=realtime)
            if block is None and not thread.is_alive():
                # the producer is done: all it fed is in the ring by now
                block = host.pull_block(starved=False)
                if block is None:
                    raise RuntimeError(f"input ended after {processed} of {num_blocks} blocks")
            if block is None:
                time.sleep(block_seconds / 16)
                continue
            t0 = time.perf_counter()
            out, state = sd.process_block(state, block)
            out = out.cpu().numpy()  # waits for the device
            host.add_busy(time.perf_counter() - t0)
            host.push_block(out)
            out_blocks.append(host.collect(hop))
            processed += 1
    finally:
        stop.set()
        thread.join(timeout=5.0)
    wall = time.perf_counter() - start

    enhanced = np.concatenate(out_blocks)[:length]
    write_wav(output_path, enhanced, sr)

    stats = host.stats()
    audio_seconds = num_blocks * block_seconds
    stats.update({
        "audio_seconds": audio_seconds,
        "wall_seconds": wall,
        "rtf_busy": stats["busy_seconds"] / audio_seconds,
        "output": output_path,
    })
    return stats


def _sounddevice():
    """The sounddevice module, or ImportError when it (or PortAudio) is missing."""
    try:
        import sounddevice
    except (ImportError, OSError) as e:  # a wheel without libportaudio raises OSError
        raise ImportError(
            "live audio needs the `sounddevice` wheel (PortAudio); here use "
            "--input/--output file streaming instead"
        ) from e
    return sounddevice


def stream_microphone(cfg: Config, state_dict: dict, latency: str = "low", device="cuda"):
    """Live duplex denoising through PortAudio (needs the sounddevice wheel)."""
    sdev = _sounddevice()
    from tinyrecurrentunet_torch.runtime import StreamHost

    hop = cfg.featurizer.hop_length
    sr = cfg.featurizer.sample_rate
    sd = StreamingDenoiser(cfg, state_dict, device=device)
    sd.process_block(sd.init_state(), np.zeros(hop, np.float32))[0].cpu()
    state = sd.init_state()
    host = StreamHost(block_size=hop)
    stop = threading.Event()

    def callback(indata, outdata, frames, time_info, status):  # noqa: ARG001
        host.feed(indata[:, 0])
        got = host.collect(frames)
        outdata[:, 0] = 0.0
        outdata[: len(got), 0] = got

    def inference_loop():
        nonlocal state
        while not stop.is_set():
            block = host.pull_block(starved=False)
            if block is None:
                time.sleep(0.001)
                continue
            t0 = time.perf_counter()
            out, state = sd.process_block(state, block)
            out = out.cpu().numpy()
            host.add_busy(time.perf_counter() - t0)
            host.push_block(out)

    thread = threading.Thread(target=inference_loop, daemon=True)
    thread.start()
    try:
        with sdev.Stream(samplerate=sr, blocksize=hop, channels=1, latency=latency, callback=callback):
            print("streaming... Ctrl-C to stop")
            while True:
                time.sleep(1.0)
                print(host.stats())
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        thread.join(timeout=5.0)


def list_devices() -> list[str]:
    """Audio device inventory: the PortAudio device table with the
    sounddevice wheel installed; without it, the native stream host's
    virtual endpoints, so the flag still says what can be streamed through."""
    try:
        sdev = _sounddevice()
    except ImportError:
        return [
            "sounddevice/PortAudio wheel not installed; native host endpoints:",
            "  0  ring:input   (StreamHost lock-free SPSC input ring)",
            "  1  ring:output  (StreamHost lock-free SPSC output ring)",
            "  file endpoints: --input/--output WAV streaming "
            "(add --realtime to pace blocks at the hop deadline and count xruns)",
        ]
    lines = ["PortAudio devices:"]
    lines.extend(str(sdev.query_devices()).splitlines())
    lines.append(f"default (in, out): {sdev.default.device}")
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", default=None)
    parser.add_argument("--list-devices", action="store_true", help="list audio devices and exit")
    parser.add_argument("--input", default=None)
    parser.add_argument("--output", default="enhanced_stream.wav")
    parser.add_argument("--mic", action="store_true")
    parser.add_argument("--realtime", action="store_true",
                        help="pace file blocks at real time (measures xruns)")
    parser.add_argument("--chunk_frames", type=int, default=1,
                        help="hops per call (latency/throughput trade)")
    parser.add_argument("--ckpt_iter", default=None, help="max | iteration | pretrained")
    parser.add_argument("--random_init", action="store_true",
                        help="weights drawn from the config's seed, no checkpoint")
    parser.add_argument("--latency", default="low")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.list_devices:
        for line in list_devices():
            print(line)
        return
    if not args.config:
        parser.error("-c/--config is required (except with --list-devices)")
    if not args.mic and not args.input:
        parser.error("--input is required without --mic")
    cfg = load_config(args.config)
    # the port works in float32: keep cuDNN convolutions out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tinyrecurrentunet_torch.infer.denoise import Denoiser, random_state_dict

    if args.random_init:
        state_dict = random_state_dict(cfg)
    else:
        state_dict = Denoiser.from_checkpoint(cfg, args.ckpt_iter, device="cpu").model.state_dict()

    if args.mic:
        stream_microphone(cfg, state_dict, args.latency, device=args.device)
        return
    stats = stream_file(cfg, state_dict, args.input, args.output, args.realtime, args.chunk_frames,
                        device=args.device)
    for k, v in stats.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()

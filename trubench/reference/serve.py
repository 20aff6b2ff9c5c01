"""The reference denoisers: a clip offline, and many streams hop by hop.

Offline: the clip padded with zeros to its length bucket (the smallest
multiple of the hop on a ladder that starts at 8 hops and grows by an
eighth, at least a hop, each rung), centred STFT, features, the network in
eval mode, the mask, the inverse STFT over the bucket, the clip's own
samples kept.

Streaming: each hop slides an n_fft window that ends at the hop's last
sample (zeros before the stream's first), makes one spectrum frame and its
features (the unwrap and PCEN carried from frame to frame), runs the
network on that frame with the TGRU carry, masks, inverts, and
overlap-adds: a hop's output is the sum of the n_fft / hop frames that
cover it, divided by their count, 3 hops behind its input. The network is
frame-local outside the TGRU, so the hops of a stream run as one sequence
in blocks of frames, the carry passed from block to block.
"""

from __future__ import annotations

import numpy as np
import torch

from trubench.reference import net, signal


def bucket(length: int, hop: int) -> int:
    size = 8 * hop
    while size < length:
        size += max(size // 8, hop)
    return -(-size // hop) * hop


@torch.no_grad()
def denoise(params: dict, cfg: dict, audio: np.ndarray, device, q=net.FLOAT32) -> np.ndarray:
    fz = cfg["featurizer"]
    n_fft, hop = fz["n_fft"], fz["hop_length"]
    padded = np.zeros(bucket(len(audio), hop), np.float32)
    padded[:len(audio)] = audio
    spec = signal.offline_spectra(padded, n_fft, hop)
    feats = torch.from_numpy(signal.features(spec, fz, streaming=False)).to(device)
    out, _ = net.trunet(params, cfg["network"], feats[None], q=q)
    masked = signal.bsigmoid_spec(out[0], torch.from_numpy(spec).to(device), len(fz["channels"]))
    return signal.istft(masked, n_fft, hop, len(padded))[:len(audio)].cpu().numpy()


@torch.no_grad()
def stream(params: dict, cfg: dict, audio: np.ndarray, device, q=net.FLOAT32, block: int = 1024) -> np.ndarray:
    """(S, K hop) inputs of S streams -> the (S, K hop) outputs of their K hops."""
    fz = cfg["featurizer"]
    n_fft, hop = fz["n_fft"], fz["hop_length"]
    streams, hops = audio.shape[0], audio.shape[1] // hop
    spec = signal.stream_spectra(audio, n_fft, hop)  # (S, K, F)
    feats = signal.features(spec, fz, streaming=True)
    carry, frames = None, []
    for k in range(0, hops, block):
        f = torch.from_numpy(feats[:, k:k + block]).to(device)
        out, carry = net.trunet(params, cfg["network"], f, carry, q=q)
        s = torch.from_numpy(spec[:, k:k + block]).to(device)
        frames.append(torch.fft.irfft(signal.bsigmoid_spec(out, s, len(fz["channels"])), n=n_fft, dim=-1))
    total = signal.overlap_add(torch.cat(frames, dim=1), hop)
    return (total[:, :hops * hop] / (n_fft // hop)).cpu().numpy()

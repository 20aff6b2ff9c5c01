"""Model FLOPs of TRU-Net from the configuration's shapes alone.

Counted as products of multiply-adds, 2 FLOPs each, the way
`torch.utils.flop_counter` counts them: every convolution, transposed
convolution and Dense layer, the GRUs' input projections and their
recurrences (h Wh at every step). Elementwise work, normalisation, the
STFT and the losses are not counted. A frame is one STFT frame of one
clip or stream; the network is frame-local except for the TGRU, whose
work per frame is one step over the bottleneck bins.
"""

from __future__ import annotations


def forward_flops_per_frame(net: dict, num_freqs: int) -> int:
    f, c, flops = num_freqs, net["input_size"], 0
    widths = []
    for i, (feat, k, s) in enumerate(net["encoder"]):
        if i == 0:
            f = (f + 2 * (s // 2) - k) // s + 1
            flops += 2 * f * feat * c * k
        else:
            flops += 2 * f * c * feat  # pointwise Dense
            f = (f + 2 * (k // 2) - k) // s + 1
            flops += 2 * f * feat * k  # depthwise
        c = feat
        widths.append((f, c))
    fb, hf, ht = f, net["fgru_hidden"], net["tgru_hidden"]
    flops += 2 * (2 * fb * c * 3 * hf + 2 * fb * hf * 3 * hf)  # FGRU, both directions
    flops += 2 * fb * 2 * hf * net["fgru_out"]
    flops += 2 * fb * net["fgru_out"] * 3 * ht + 2 * fb * ht * 3 * ht  # TGRU, one step a frame
    flops += 2 * fb * ht * net["tgru_out"]
    c = net["tgru_out"]
    skips = widths[-2::-1]
    decoder = net["decoder"]
    for idx, (feat, k, s) in enumerate(decoder):
        if idx == len(decoder) - 1:
            feat = net["output_size"]
        if idx > 0:
            f, skip_c = skips[idx - 1]
            c += skip_c
        flops += 2 * f * c * feat  # Dense
        flops += 2 * f * feat * feat * k  # transposed conv, per input position
        f, c = (f - 1) * s - 2 * (s // 2) + k, feat
    return flops


def frames(samples: int, hop: int) -> int:
    """STFT frames of a centred transform of `samples`."""
    return 1 + samples // hop

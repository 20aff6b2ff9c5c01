"""TRU-Net: frequency-axis conv U-Net with an FGRU/TGRU bottleneck.

Counterpart of `tinyrecurrentunet_tpu/models/trunet.py` (inference).
Frame-local stages (convs, FGRU) fold time into the batch axis,
(B*T, F, C); the TGRU walks time with batch (B*F'', C).

Forward contract:
    y, tgru_h = model(x, tgru_h0)
    x: (B, T, F, C_in) or (T, F, C_in)
    y: (B, T, F, 2*C_in) — stacked mixture/noise feature sets
    tgru_h: (B, F_bottleneck, tgru_hidden), the TGRU carry

`config.compute_dtype` is "float32" or "bfloat16". In float32 the input and
the carry are cast to the parameters' dtype: float32, or float64 after
`model.double()` for a float64 reference run on the CPU (the CUDA kernels
take float32 only). In bfloat16, as in the JAX package, the parameters stay
float32 and every block casts them at use (`models/blocks.py`); the input
and the carry are cast to bf16, the carry comes back in bf16 (rounded at
every call, which a stream makes at every hop), and the output is cast back
to float32.
"""

from __future__ import annotations

import torch
from torch import nn

from tinyrecurrentunet_torch.config import NetworkConfig
from tinyrecurrentunet_torch.models.blocks import (
    DepthwiseSeparableConv1d,
    GRUBlock,
    StandardConv1d,
    TrCNNBlock,
)
from tinyrecurrentunet_torch.ops.conv import pad_or_crop


class TRUNet(nn.Module):
    def __init__(self, config: NetworkConfig = NetworkConfig(), device=None):
        super().__init__()
        if config.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {config.compute_dtype!r}: float32 or bfloat16")
        self.config = cfg = config
        # None: the parameters' dtype
        self.compute_dtype = dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        channels = cfg.input_size
        enc_out = []
        for i, (feat, k, s) in enumerate(cfg.encoder):
            if i == 0:
                block = StandardConv1d(channels, feat, k, s, dtype=dtype, device=device)
                self.add_module("StandardConv1d_0", block)
            else:
                block = DepthwiseSeparableConv1d(channels, feat, k, s, dtype=dtype, device=device)
                self.add_module(f"DepthwiseSeparableConv1d_{i - 1}", block)
            channels = feat
            enc_out.append(feat)
        gru = cfg.use_pallas_gru
        self.GRUBlock_0 = GRUBlock(
            channels, cfg.fgru_hidden, cfg.fgru_out, bidirectional=True, dtype=dtype, use_pallas_gru=gru,
            device=device,
        )
        self.GRUBlock_1 = GRUBlock(cfg.fgru_out, cfg.tgru_hidden, cfg.tgru_out, dtype=dtype, use_pallas_gru=gru,
                                   device=device)

        dec = cfg.decoder
        self.TrCNNBlock_0 = TrCNNBlock(cfg.tgru_out, *dec[0], dtype=dtype, device=device)
        channels = dec[0][0]
        skip_channels = enc_out[-2::-1]
        self.num_decoder_blocks = 1
        for idx, ((feat, k, s), skip) in enumerate(zip(dec[1:], skip_channels), start=1):
            is_last = idx == len(dec) - 1
            feat = cfg.output_size if is_last else feat
            block = TrCNNBlock(channels + skip, feat, k, s, final_norm=not is_last, dtype=dtype, device=device)
            self.add_module(f"TrCNNBlock_{idx}", block)
            channels = feat
            self.num_decoder_blocks += 1

    def bottleneck_freqs(self, num_freqs: int) -> int:
        """Frequency-axis length at the bottleneck for a given input F."""
        f = num_freqs
        for i, (_, k, s) in enumerate(self.config.encoder):
            p = s // 2 if i == 0 else k // 2
            f = (f + 2 * p - k) // s + 1
        return f

    def init_tgru_state(self, batch: int, num_freqs: int, device=None) -> torch.Tensor:
        """Zero TGRU carry for a (batch, num_freqs)-shaped input stream, in
        the dtype the model returns its carry in (bf16 or float32)."""
        fb = self.bottleneck_freqs(num_freqs)
        dtype = self.compute_dtype or torch.float32
        return torch.zeros((batch, fb, self.config.tgru_hidden), dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, tgru_h0: torch.Tensor | None = None):
        cfg = self.config
        unbatched = x.dim() == 3
        if unbatched:
            x = x[None]
        batch, time, freqs, chans = x.shape
        dtype = self.compute_dtype or self.StandardConv1d_0.Conv_0.weight.dtype
        x = x.to(dtype)

        # encoder: frame-local convs over frequency, time folded into batch
        z = x.reshape(batch * time, freqs, chans)
        skips = []
        for i in range(len(cfg.encoder)):
            name = "StandardConv1d_0" if i == 0 else f"DepthwiseSeparableConv1d_{i - 1}"
            z = self.get_submodule(name)(z)
            skips.append(z)

        # bottleneck: FGRU over frequency, then TGRU over time
        fb = z.shape[1]
        z, _ = self.GRUBlock_0(z)
        z = z.reshape(batch, time, fb, cfg.fgru_out)
        z = z.transpose(1, 2).reshape(batch * fb, time, cfg.fgru_out)
        h0 = None
        if tgru_h0 is not None:
            h0 = tgru_h0.to(dtype).reshape(batch * fb, cfg.tgru_hidden)
        z, h_final = self.GRUBlock_1(z, h0)
        tgru_h = h_final.reshape(batch, fb, cfg.tgru_hidden)
        z = z.reshape(batch, fb, time, cfg.tgru_out)
        z = z.transpose(1, 2).reshape(batch * time, fb, cfg.tgru_out)

        # decoder: skip-concat (except the first block), pad-to-match on F
        z = self.TrCNNBlock_0(z)
        for idx, skip in zip(range(1, self.num_decoder_blocks), skips[-2::-1]):
            z = pad_or_crop(z, skip.shape[1], dim=1)
            z = torch.cat([z, skip], dim=-1)
            z = self.get_submodule(f"TrCNNBlock_{idx}")(z)

        z = pad_or_crop(z, freqs, dim=1)
        y = z.reshape(batch, time, freqs, cfg.output_size)
        if self.compute_dtype is not None:
            y = y.float()
        if unbatched:
            return y[0], tgru_h
        return y, tgru_h

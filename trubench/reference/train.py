"""The reference train step: the composite loss, backward, global-norm
clipping and AdamW, in plain PyTorch.

Loss (the shipped training configs' terms): mean |y - clean| times
`ell_p_lambda`; the multi-resolution STFT loss (spectral convergence
||Y - X||_F / ||Y||_F and mean |log Y - log X| on Hann-windowed
magnitudes, averaged over the bank, times sc_lambda and mag_lambda) times
`stft_lambda`; and the same on the noise side (noisy - y against
noisy - clean) times `noise_stft_lambda`. The update is optax's
chain(clip_by_global_norm, adamw): g scaled by max_norm / ||g|| where
||g|| >= max_norm; b1 0.9, b2 0.999, eps 1e-8 outside the square root,
weight decay on every parameter, at the rate of the linear-warmup cosine
schedule of the update's count.
"""

from __future__ import annotations

import numpy as np
import torch

from trubench.reference import net, signal

B1, B2, EPS = 0.9, 0.999, 1e-8


def learning_rate(opt: dict, count: int) -> float:
    """The rate of update `count` (0-based): linear from lr/divider to lr
    over warmup_proportion of n_iters, then a cosine down to lr/divider/1e4,
    in float32."""
    f32 = np.float32
    lr_max, n_iters = opt["learning_rate"], opt["n_iters"]
    phase1 = max(int(n_iters * opt["warmup_proportion"]), 1)
    phase2 = max(n_iters - phase1, 1)
    lr_min = lr_max / opt["lr_divider"]
    n = f32(count) + f32(1.0)
    if n <= phase1:
        return float(min(f32(lr_min) + (n / f32(phase1)) * f32(lr_max - lr_min), f32(lr_max)))
    n2 = min(max(n - f32(phase1), f32(0.0)), f32(phase2))
    cos_val = np.cos(f32(np.pi) * (n2 / f32(phase2))) + f32(1.0)
    return float(f32(lr_min / 1e4) + f32((lr_max - lr_min / 1e4) / 2.0) * cos_val)


def _bank_sums(x, y, fft: int, hop: int, win: int, band: str):
    """(sum (Y - X)^2, sum Y^2, sum |log Y - log X|, count) of one resolution."""
    xm, ym = signal.stft_magnitude(x, fft, hop, win), signal.stft_magnitude(y, fft, hop, win)
    if band == "high":
        xm, ym = xm[..., xm.shape[-1] // 2:], ym[..., ym.shape[-1] // 2:]
    logs = torch.abs(torch.log(ym) - torch.log(xm))
    return torch.stack([torch.sum((ym - xm) ** 2), torch.sum(ym * ym), torch.sum(logs)]), logs.numel()


def _mrstft(x, y, bank: dict, rows: int):
    """Spectral convergence ||Y - X||_F / ||Y||_F and mean |log Y - log X|
    over the batch, from sums over blocks of `rows` rows (each block's
    spectra made again in the backward where it is not the whole batch)."""
    sc = mag = 0.0
    for fft, hop, win in zip(bank["fft_sizes"], bank["hop_sizes"], bank["win_lengths"]):
        sums, count = 0.0, 0
        for i in range(0, x.shape[0], rows):
            args = (x[i:i + rows], y[i:i + rows], fft, hop, win, bank["band"])
            if rows < x.shape[0]:
                part, n = torch.utils.checkpoint.checkpoint(_bank_sums, *args, use_reentrant=False)
            else:
                part, n = _bank_sums(*args)
            sums, count = sums + part, count + n
        sc = sc + torch.sqrt(sums[0]) / torch.sqrt(sums[1])
        mag = mag + sums[2] / count
    n = len(bank["fft_sizes"])
    return sc * bank["sc_lambda"] / n, mag * bank["mag_lambda"] / n


def loss(params, cfg: dict, clean, noisy, feats, spec, q=net.FLOAT32, rows=None, recompute_rows: int = 0):
    """The composite loss of (B, L) clean and noisy on the card, given the
    noisy features (B, T, F, C) and spectra (B, T, F). `rows` keeps only
    those rows of the batch. `recompute_rows` > 0 trades time for memory:
    the network's blocks and the loss's spectra of each such block of rows
    are made again in the backward (the same arithmetic)."""
    if rows is not None:
        clean, noisy, feats, spec = clean[rows], noisy[rows], feats[rows], spec[rows]
    lc, fz = cfg["loss"], cfg["featurizer"]
    for key in ("cossim_lambda", "aux_feature_lambda"):
        if lc[key]:
            raise ValueError(f"loss term {key} is not in the reference")
    if lc["per_item_norm"] or lc["ell_p"] != 1:
        raise ValueError("the reference computes ell_1 without per-item weights")
    out, _ = net.trunet(params, cfg["network"], feats, train=True, q=q, recompute=recompute_rows > 0)
    block = recompute_rows or clean.shape[0]
    den = signal.istft(signal.bsigmoid_spec(out, spec, len(fz["channels"])), fz["n_fft"], fz["hop_length"],
                       clean.shape[-1])
    total = lc["ell_p_lambda"] * torch.mean(torch.abs(den - clean))
    if lc["stft_lambda"] > 0:
        sc, mag = _mrstft(den, clean, lc["stft_config"], block)
        total = total + (sc + mag) * lc["stft_lambda"]
    if lc["noise_stft_lambda"] > 0:
        sc, mag = _mrstft(noisy - den, noisy - clean, lc["stft_config"], block)
        total = total + (sc + mag) * lc["noise_stft_lambda"]
    return total


class Trainer:
    """Parameters and AdamW's state in float32 on the card, stepped by `step`."""

    def __init__(self, state_dict: dict, cfg: dict, device, q=net.FLOAT32, rows=None, recompute_rows: int = 0):
        self.cfg, self.q, self.rows, self.recompute_rows = cfg, q, rows, recompute_rows
        self.params = {k: v.detach().to(device, torch.float32).clone().requires_grad_(not k.startswith("_") and
                       not k.endswith(("running_mean", "running_var")))
                       for k, v in state_dict.items()}
        self.trained = [k for k, v in self.params.items() if v.requires_grad]
        self.m = {k: torch.zeros_like(self.params[k]) for k in self.trained}
        self.v = {k: torch.zeros_like(self.params[k]) for k in self.trained}
        self.count = 0

    def step(self, clean, noisy, feats, spec) -> tuple[float, dict]:
        """One update: (loss, {name: the clipped gradient})."""
        opt = self.cfg["optimization"]
        value = loss(self.params, self.cfg, clean, noisy, feats, spec, self.q, self.rows, self.recompute_rows)
        grads = torch.autograd.grad(value, [self.params[k] for k in self.trained])
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.where(norm < opt["grad_clip_norm"], torch.ones_like(norm), opt["grad_clip_norm"] / norm)
        grads = {k: g * scale for k, g in zip(self.trained, grads)}
        lr, wd = learning_rate(opt, self.count), opt["weight_decay"]
        self.count += 1
        c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        with torch.no_grad():
            for k, g in grads.items():
                p = self.params[k]
                self.m[k].mul_(B1).add_(g, alpha=1 - B1)
                self.v[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                update = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + EPS)
                p.sub_(lr * (update + wd * p))
        return float(value.detach()), grads

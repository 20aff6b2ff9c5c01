"""Typed configuration, the same schema as `tinyrecurrentunet_tpu/config.py`.

The port keeps its own copy so that it imports nothing of the JAX package
(whose `__init__` imports jax). Every `config/*.json` parses to the same
values in both packages (tests/test_torch_config.py).

- One canonical set of section names (`network/train/trainset/gen/dist`),
  with the older `*_config` aliases accepted on load.
- Sample rate is first-class.

Everything is a frozen dataclass, hashable and safe to share.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence


def _freeze(seq: Sequence) -> tuple:
    return tuple(seq)


@dataclasses.dataclass(frozen=True)
class FeaturizerConfig:
    """STFT featurizer settings (reference `dataset.py:130-153` defaults)."""

    n_fft: int = 512
    hop_length: int = 128
    sample_rate: int = 48000
    min_level_db: float = -100.0
    ref_level_db: float = 25.0
    # Feature channels, in order. The reference README (`README.md:50`) and
    # export config (`config/tiny.json:57-61`) specify the 4-channel input
    # (log-mag, PCEN, real demod, imag demod); the literal featurizer built
    # only 3 (`dataset.py:268-270`, PCEN dead code at `dataset.py:56-76`).
    # 4-channel is the primary path; the 3-channel variant is a config choice
    # (SURVEY.md §0.2).
    channels: tuple = ("logmag", "pcen", "real_demod", "imag_demod")
    # PCEN constants (reference `dataset.py:56`).
    pcen_eps: float = 1e-6
    pcen_s: float = 0.025
    pcen_alpha: float = 0.98
    pcen_delta: float = 2.0
    pcen_r: float = 0.5

    def __post_init__(self):
        object.__setattr__(self, "channels", _freeze(self.channels))
        for ch in self.channels:
            if ch not in ("logmag", "pcen", "real_demod", "imag_demod"):
                raise ValueError(f"unknown feature channel {ch!r}")
        if "logmag" not in self.channels:
            raise ValueError("feature channels must include 'logmag'")
        if not ("real_demod" in self.channels and "imag_demod" in self.channels):
            raise ValueError("feature channels must include demodulated phase")

    @property
    def num_channels(self) -> int:
        return len(self.channels)

    @property
    def num_freqs(self) -> int:
        return self.n_fft // 2 + 1


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """TRU-Net dims. Defaults reproduce the reference's hard-coded plan
    (reference `network.py:134-150`), but every dim is honored (fixes D5)."""

    input_size: int = 4  # feature channels in
    output_size: int = 8  # 2 stacked feature sets out (reference `util.py:217-222`)
    # Encoder: (out_channels, kernel, stride) per block; block 0 is a
    # StandardConv, the rest are depthwise-separable (`network.py:134-139`).
    encoder: tuple = (
        (64, 5, 2),
        (128, 3, 1),
        (128, 5, 2),
        (128, 3, 1),
        (128, 5, 2),
        (128, 3, 2),
    )
    # Bottleneck GRUs (`network.py:149-150`).
    fgru_hidden: int = 64
    fgru_out: int = 64
    tgru_hidden: int = 128
    tgru_out: int = 64
    # Decoder: (out_channels, kernel, stride) per block; first takes no skip,
    # last has no trailing BN/ReLU (`network.py:141-146`).
    decoder: tuple = (
        (64, 3, 2),
        (64, 5, 2),
        (64, 3, 1),
        (64, 5, 2),
        (64, 3, 1),
        (8, 5, 2),
    )
    # Phase-aware mask sharpness (reference `phm.py:10`; only the legacy
    # "mixture" source uses it).
    phm_beta: float = 0.5
    # PHM head formulation (reference `phm.py:31-45`, defect D6):
    # "bsigmoid" (default): the TRU-Net paper's phase-aware beta-sigmoid
    #   mask — magnitude masks for speech/noise from bounded sigmoids,
    #   phase from the law of cosines, network-estimated rotation sign
    #   (models/phm.py `bsigmoid_complex_mask`). The only head whose
    #   direct-optimization oracle beats the noisy input; use for training.
    # "mixture": legacy round-1 reading — sigmoid(beta * phase-difference)
    #   mask on the OBSERVED noisy spectrogram's magnitude+phase. Kept for
    #   round-1 artifact compatibility; measurably inexpressive.
    # "network": magnitude+phase decoded from the network's own mixture
    #   feature set (the reading of the unfinished `util.py:221-234`);
    #   requires the net to learn full phase reconstruction.
    phm_source: str = "bsigmoid"
    # Compute dtype for the forward pass ("float32" or "bfloat16").
    compute_dtype: str = "float32"
    # Kernel selection and scan unrolling of the JAX package. Parsed so the
    # schema stays the same; the port ignores both: on a CUDA device every
    # recurrence goes through the CUDA kernel (ops/cuda_gru.py).
    use_pallas_gru: str = "auto"
    gru_scan_unroll: int = 1

    def __post_init__(self):
        object.__setattr__(self, "encoder", _freeze(tuple(map(tuple, self.encoder))))
        object.__setattr__(self, "decoder", _freeze(tuple(map(tuple, self.decoder))))
        if self.output_size != 2 * self.input_size:
            raise ValueError(
                "output_size must be 2*input_size (mixture + noise feature sets), "
                f"got {self.output_size} vs input {self.input_size}"
            )


@dataclasses.dataclass(frozen=True)
class STFTLossConfig:
    """Multi-resolution STFT loss bank (reference `config/tiny.json:30-37`)."""

    sc_lambda: float = 0.5
    mag_lambda: float = 0.5
    band: str = "full"
    fft_sizes: tuple = (512, 1024, 2048)
    hop_sizes: tuple = (50, 120, 240)
    win_lengths: tuple = (240, 600, 1200)

    def __post_init__(self):
        object.__setattr__(self, "fft_sizes", _freeze(self.fft_sizes))
        object.__setattr__(self, "hop_sizes", _freeze(self.hop_sizes))
        object.__setattr__(self, "win_lengths", _freeze(self.win_lengths))
        if not (len(self.fft_sizes) == len(self.hop_sizes) == len(self.win_lengths)):
            raise ValueError("fft/hop/win lists must have equal length")
        if self.band not in ("full", "high"):
            raise ValueError(f"band must be 'full' or 'high', got {self.band!r}")


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Composite loss (reference `config/tiny.json:26-38`, `util.py:186-251`)."""

    ell_p: int = 1
    ell_p_lambda: float = 1.0
    stft_lambda: float = 1.0
    # Optional cosine-similarity term; available-but-off matches the
    # reference's intent (imported, never wired — D18, `cos_loss.py`).
    cossim_lambda: float = 0.0
    # Optional feature-matching auxiliary loss: L1 between the network's
    # mixture feature set and featurizer(clean), and its noise set and
    # featurizer(noise). Gives every output channel a direct gradient under
    # phm_source="mixture" (where only the demod-phase channels drive the
    # mask). EXPERIMENTAL — measured on the synthetic task it HURT SI-SDR
    # (-0.2 dB at 20k iters vs +1.9 dB at 3k without): pinning the phase
    # estimates to the true clean/noise phases conflicts with the mask
    # treating them as free latents. Keep 0 unless re-validated.
    aux_feature_lambda: float = 0.0
    # Optional noise-side spectral loss: MR-STFT between the implied noise
    # estimate (noisy - denoised; exact, since with the bsigmoid PHM the
    # complex masks satisfy M_n = 1 - M_s and the iSTFT is linear) and the
    # true noise (noisy - clean). The TRU-Net paper trains BOTH source
    # estimates; the waveform-L1 part of a noise-side loss is algebraically
    # identical to the speech-side L1, so only the spectral terms are added.
    # The spectral-convergence term normalizes by the target norm, so this
    # weights noise-spectrum accuracy highly at high SNR where the noise is
    # small - exactly where masking errors are most audible.
    noise_stft_lambda: float = 0.0
    # Per-item loss normalization (VERDICT r4 weak #1 / next #1): scale each
    # batch item's (denoised, clean, noisy) triple by
    #   w_i = mean_b rms(noise_b) / rms(noise_i),   noise = noisy - clean,
    # clipped to [1/4, 4], before the waveform L1 / MR-STFT terms. Without
    # it those terms are absolute-error means over the batch, so -5 dB
    # additive items (noise rms up to ~30x the 25 dB items) dominate the
    # gradient and the small-residual reverb items are out-gradiented —
    # measured round 4: the flagship scored -0.06 dB SI-SDR on pure reverb
    # (QUALITY.json) while its additive rows were strongly positive, and
    # reverb oversampling alone did not move it (commit 7d98f52). The
    # log-magnitude term is invariant to w (log a·Y - log a·X); spectral
    # convergence and L1 become per-item-relative. Mean-relative scaling
    # keeps the overall loss magnitude comparable, so the LR transfers.
    per_item_norm: bool = False
    stft_config: STFTLossConfig = dataclasses.field(default_factory=STFTLossConfig)


@dataclasses.dataclass(frozen=True)
class LogConfig:
    directory: str = "./ckpt"
    ckpt_iter: str = "max"  # "max" | int-as-str | "pretrained"
    iters_per_ckpt: int = 5000
    iters_per_valid: int = 5000


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    n_iters: int = 25_000_000
    learning_rate: float = 4e-4
    batch_size_per_device: int = 1
    # Root seed for the whole training run: parameter init, the data
    # loader's epoch shuffles, and the on-device corpus cache's epoch
    # permutations all derive from it, so two runs of the same command are
    # bit-identical (the reference seeds everything at import,
    # `train.py:11-14`, `dataset.py:19-22`).
    seed: int = 0
    # Reference: grad-clip max-norm 1e9 (`train.py:138`), AdamW (`train.py:68`),
    # warmup 5% with divider 25 then cosine to lr_min/1e4 (`train.py:102-110`).
    grad_clip_norm: float = 1e9
    warmup_proportion: float = 0.05
    lr_divider: float = 25.0
    weight_decay: float = 1e-2  # torch AdamW default
    # TBPTT: split each training clip into segments of this many seconds and
    # carry the TGRU hidden state across them (gradients truncate at the
    # boundary). 0 disables (whole-clip BPTT, the reference regime). This is
    # the long-context strategy for clips beyond the 2 s crop (SURVEY.md §5).
    tbptt_segment_sec: float = 0.0
    # TRAIN-ONLY forward-pass dtype override ("" = use network.compute_dtype).
    # Scoped to training so the exported artifact still serves in f32.
    train_compute_dtype: str = ""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    exp_path: str = "TRUNet"
    log: LogConfig = dataclasses.field(default_factory=LogConfig)
    optimization: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    loss_config: LossConfig = dataclasses.field(default_factory=LossConfig)


@dataclasses.dataclass(frozen=True)
class TrainsetConfig:
    root: str = "./data"
    crop_length_sec: float = 2.0
    sample_rate: int = 48000
    # "pairs": DNS-style precomputed clean/noisy pairs.
    # "mix": on-the-fly clean + augmented-noise mixing (reference
    #        `dataset.py:352-386` semantics, D15/D16 fixed).
    mode: str = "mix"
    noise_dir: str = "noise"


@dataclasses.dataclass(frozen=True)
class GenConfig:
    output_directory: str = "./exp"


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Multi-process topology (parsed for schema parity; the serving slice
    of the port runs on one device)."""

    data_axis: str = "data"
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0


@dataclasses.dataclass(frozen=True)
class ExportConfig:
    """Export dummy shape (reference `config/tiny.json:57-61`)."""

    time_step: int = 751
    channels: int = 4
    frequency: int = 257


@dataclasses.dataclass(frozen=True)
class Config:
    network: NetworkConfig = dataclasses.field(default_factory=NetworkConfig)
    featurizer: FeaturizerConfig = dataclasses.field(default_factory=FeaturizerConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    trainset: TrainsetConfig = dataclasses.field(default_factory=TrainsetConfig)
    gen: GenConfig = dataclasses.field(default_factory=GenConfig)
    dist: DistConfig = dataclasses.field(default_factory=DistConfig)
    onnx_config: ExportConfig = dataclasses.field(default_factory=ExportConfig)


_SECTION_ALIASES = {
    "network_config": "network",
    "train_config": "train",
    "trainset_config": "trainset",
    "gen_config": "gen",
    "dist_config": "dist",
    "export": "onnx_config",
}


def _build(cls, data: Mapping[str, Any]):
    """Recursively build a dataclass from a mapping, ignoring unknown keys
    the reference schema carries (e.g. tiny.json network dims we derive)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            continue
        ftype = fields[key].type
        target = _FIELD_CLASSES.get((cls, key))
        if target is not None and isinstance(value, Mapping):
            kwargs[key] = _build(target, value)
        else:
            del ftype
            kwargs[key] = value
    return cls(**kwargs)


_FIELD_CLASSES = {
    (Config, "network"): NetworkConfig,
    (Config, "featurizer"): FeaturizerConfig,
    (Config, "train"): TrainConfig,
    (Config, "trainset"): TrainsetConfig,
    (Config, "gen"): GenConfig,
    (Config, "dist"): DistConfig,
    (Config, "onnx_config"): ExportConfig,
    (TrainConfig, "log"): LogConfig,
    (TrainConfig, "optimization"): OptimizationConfig,
    (TrainConfig, "loss_config"): LossConfig,
    (LossConfig, "stft_config"): STFTLossConfig,
}


def config_from_dict(raw: Mapping[str, Any]) -> Config:
    """Build a Config from a (possibly reference-schema) dict."""
    data: dict = {}
    for key, value in raw.items():
        data[_SECTION_ALIASES.get(key, key)] = value

    # Map reference tiny.json quirks onto the canonical schema.
    net = dict(data.get("network", {}))
    if "input_size" in net:
        n_in = int(net["input_size"])
        net.setdefault("output_size", 2 * n_in)
        # Drop reference keys that the hard-coded torch model ignored (D5);
        # our dims come from the structured encoder/decoder plans.
        for legacy in ("channels_input", "channels_output", "channels_hidden",
                       "kernel_sizes", "strides", "tr_channels_input"):
            net.pop(legacy, None)
    data["network"] = net

    opt = data.get("train", {}).get("optimization")
    if opt is not None and "batch_size_per_gpu" in opt:
        opt = dict(opt)
        opt["batch_size_per_device"] = opt.pop("batch_size_per_gpu")
        train = dict(data["train"])
        train["optimization"] = opt
        data["train"] = train

    cfg = _build(Config, data)

    # Keep featurizer sample rate in sync with the trainset unless the
    # featurizer section pinned one explicitly.
    if "featurizer" not in data and "sample_rate" in data.get("trainset", {}):
        cfg = dataclasses.replace(
            cfg,
            featurizer=dataclasses.replace(
                cfg.featurizer, sample_rate=cfg.trainset.sample_rate
            ),
        )

    # 3-channel variant when the network says input_size == 3 (SURVEY.md §0.2).
    if cfg.network.input_size == 3 and cfg.featurizer.num_channels != 3:
        cfg = dataclasses.replace(
            cfg,
            featurizer=dataclasses.replace(
                cfg.featurizer, channels=("logmag", "real_demod", "imag_demod")
            ),
        )
    if cfg.network.input_size != cfg.featurizer.num_channels:
        raise ValueError(
            f"network.input_size={cfg.network.input_size} does not match "
            f"featurizer channels {cfg.featurizer.channels}"
        )
    return cfg


def load_config(path: str) -> Config:
    """Load a JSON config file (tiny.json-compatible)."""
    with open(path) as f:
        return config_from_dict(json.load(f))


def config_to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)

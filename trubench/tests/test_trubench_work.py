"""The yardstick's arithmetic: model FLOPs from the configuration's shapes
against torch's own count over the reference, and the GRU work against
counts by hand."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from trubench import harness
from trubench.reference import net
from trubench.work import gru, model, peaks


@pytest.mark.parametrize("name", ["proc16k", "large16k"])
def test_model_flops_equal_flop_counter_over_the_reference(name):
    config = harness.load_json("configs", name)
    freqs = config["featurizer"]["n_fft"] // 2 + 1
    params = {}
    shapes = _shapes(config["network"], freqs)
    for key, shape in shapes.items():
        params[key] = torch.zeros(shape)
    x = torch.zeros(1, 2, freqs, config["network"]["input_size"])
    with FlopCounterMode(display=False) as counter:
        net.trunet(params, config["network"], x)
    assert counter.get_total_flops() == 2 * model.forward_flops_per_frame(config["network"], freqs)


def _shapes(netc: dict, freqs: int) -> dict:
    """Parameter shapes of the reference network, from the configuration."""
    from tinyrecurrentunet_torch.config import NetworkConfig
    from tinyrecurrentunet_torch.models import TRUNet

    cfg = NetworkConfig(**{k: v for k, v in netc.items()})
    return {k: tuple(v.shape) for k, v in TRUNet(cfg, device="meta").state_dict().items()}


def test_flagship_flops_per_frame():
    """34.0 MFLOP a frame forward for the flagship (the issue's count)."""
    config = harness.load_json("configs", "proc16k")
    assert round(model.forward_flops_per_frame(config["network"], 257) / 1e6, 1) == 34.0


def test_gru_work_by_hand():
    rows, steps, h = 3, 5, 4
    n, g = 15, 12
    assert gru.forward(rows, steps, h) == (4 * (n * g + rows * h + h * g + g + n * h + rows * h),
                                           n * (2 * h * g + 12 * h))
    assert gru.forward_train(rows, steps, h)[0] == gru.forward(rows, steps, h)[0] + 4 * n * 4 * h
    assert gru.bptt(rows, steps, h) == (4 * (2 * n * h + 3 * rows * h + 4 * n * h + h * g + n * g),
                                        n * (2 * g * h + 20 * h))
    assert gru.weight_grad(rows, steps, h) == (4 * (2 * n * h + rows * h + n * g + g * (h + 1)),
                                               n * (2 * h * g + 4 * h))
    nbytes, flops = 3.35e12, 1.0
    assert gru.bound_s(nbytes, flops) == 1.0
    assert gru.bound_s(1.0, peaks.FLOPS["float32"] * 2) == 2.0
    assert gru.train_bound_s(rows, steps, h) == sum(
        gru.bound_s(*f(rows, steps, h)) for f in (gru.forward_train, gru.bptt, gru.weight_grad))

"""Linear-warmup / cosine-decay learning rate, counterpart of
`tinyrecurrentunet_tpu/train/schedule.py`.

Phase 1 is linear from lr_max/divider to lr_max over warmup_proportion of
the run; phase 2 is a cosine from lr_max to (lr_max/divider)/1e4, clamped
there past n_iters. `schedule(count)` is the rate of update `count`
(0-based), taken at count + 1 as the reference steps its scheduler before
the optimizer. Computed in float32, operation for operation as the JAX
package does.
"""

from __future__ import annotations

import numpy as np


def linear_warmup_cosine_decay(
    lr_max: float,
    n_iters: int,
    divider: float = 25.0,
    warmup_proportion: float = 0.05,
):
    """Returns schedule: count -> learning rate (a Python float)."""
    phase1 = max(int(n_iters * warmup_proportion), 1)
    phase2 = max(n_iters - phase1, 1)
    lr_min = lr_max / divider
    lr_final = lr_min / 1e4
    f32 = np.float32

    def schedule(count: int) -> float:
        n = f32(count) + f32(1.0)
        if n <= phase1:
            warm = f32(lr_min) + (n / f32(phase1)) * f32(lr_max - lr_min)
            return float(min(warm, f32(lr_max)))
        n2 = min(max(n - f32(phase1), f32(0.0)), f32(phase2))
        cos_val = np.cos(f32(np.pi) * (n2 / f32(phase2))) + f32(1.0)
        return float(f32(lr_final) + f32((lr_max - lr_final) / 2.0) * cos_val)

    return schedule

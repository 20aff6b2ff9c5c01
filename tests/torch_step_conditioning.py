"""How far two correct float32 train steps of the flagship lie from float64.

    JAX_PLATFORMS=cpu python tests/torch_step_conditioning.py [--batch 4] [--clip_sec 2]

One step of config/proc16k.json (train_compute_dtype cleared) at full width
on the CPU, from the port's initial weights (seed 0) and the first `--batch`
clips of the synthetic dataset that chip_smoke.py phase 5 uses. Gradients,
clipped as optax does, of:
- the port in float32;
- the JAX package in float32 (jax.grad of its loss_fn, the same weights);
- the port in float64, computing its noisy input features in float64 (a);
- the port in float64 on the float32 runs' own input features, cast up (b).
Prints one JSON object: the relative L2 distance of each float32 run's
gradients from each float64 reference, the relative error of each
grad_norm, and the share of the port's gradient entries below 1e-5 and at 0. Reference (b) differs from the float32 runs by the network's and
the loss's arithmetic only, (a) also by the rounding of the input features,
so the two readings separate the one from the other; the JAX run is a
second float32 witness beside the port's. Imports both packages, so it
lives with the tests; it is not collected by pytest.
"""

import argparse
import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tinyrecurrentunet_torch import config as tconfig  # noqa: E402
from tinyrecurrentunet_torch.data.dataset import SyntheticPairDataset  # noqa: E402
from tinyrecurrentunet_torch.signal import Featurizer  # noqa: E402
from tinyrecurrentunet_torch.signal.features import Float32Features  # noqa: E402
from tinyrecurrentunet_torch.train.state import create_train_state  # noqa: E402
from tinyrecurrentunet_torch.train.step import make_train_step  # noqa: E402
from tinyrecurrentunet_torch.weights import variables_from_state_dict  # noqa: E402
from tinyrecurrentunet_tpu import config as jconfig  # noqa: E402
from tinyrecurrentunet_tpu.losses import loss_fn as jloss_fn  # noqa: E402
from tinyrecurrentunet_tpu.models import TRUNet as JTRUNet  # noqa: E402
from tinyrecurrentunet_tpu.signal import Featurizer as JFeaturizer  # noqa: E402


def float32_config(mod, clip_sec):
    cfg = mod.load_config(os.path.join(REPO, "config", "proc16k.json"))
    opt = dataclasses.replace(cfg.train.optimization, train_compute_dtype="")
    trainset = dataclasses.replace(cfg.trainset, crop_length_sec=clip_sec)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, optimization=opt),
                               trainset=trainset)


def port_step(cfg, initial, clean, noisy, dtype, featurizer=None):
    """(clipped gradients as one float64 vector, grad_norm) of one port step."""
    state = create_train_state(cfg, device="cpu")
    state.model.to(dtype)
    state.model.load_state_dict(initial)
    _, metrics = make_train_step(cfg, featurizer=featurizer)(
        state, torch.from_numpy(clean).to(dtype), torch.from_numpy(noisy).to(dtype))
    grads = variables_from_state_dict({n: p.grad for n, p in state.model.named_parameters()})
    return flat(grads["params"]), float(metrics["grad_norm"])


def flat(tree):
    leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, tree))
    return np.concatenate([np.asarray(v, np.float64).ravel() for v in leaves])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--clip_sec", type=float, default=2.0)
    args = parser.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)

    tcfg, jcfg = float32_config(tconfig, args.clip_sec), float32_config(jconfig, args.clip_sec)
    dataset = SyntheticPairDataset(num_items=128, length_sec=args.clip_sec,
                                   sample_rate=tcfg.trainset.sample_rate)
    items = [dataset.get(i) for i in range(args.batch)]
    clean, noisy = (np.stack([x[k] for x in items]) for k in (0, 1))
    initial = {k: v.clone() for k, v in create_train_state(tcfg, device="cpu").model.state_dict().items()}
    max_norm = tcfg.train.optimization.grad_clip_norm

    runs = {"port_f32": port_step(tcfg, initial, clean, noisy, torch.float32)}
    runs["f64_own_features"] = port_step(tcfg, initial, clean, noisy, torch.float64)
    runs["f64_f32_features"] = port_step(tcfg, initial, clean, noisy, torch.float64,
                                         Float32Features(Featurizer(tcfg.featurizer)))

    variables = variables_from_state_dict(initial)
    jmodel = JTRUNet(jcfg.network)

    def jloss(params):
        return jloss_fn(jmodel.apply, params, variables["batch_stats"], jnp.asarray(clean),
                        jnp.asarray(noisy), JFeaturizer(jcfg.featurizer), jcfg.network,
                        jcfg.train.loss_config, train=True)[0]

    jgrads = flat(jax.jit(jax.grad(jloss))(variables["params"]))
    jnorm = float(np.sqrt(np.sum(jgrads.astype(np.float32) ** 2, dtype=np.float32)))
    runs["jax_f32"] = (jgrads * (max_norm / jnorm if jnorm >= max_norm else 1.0), jnorm)

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    g32 = np.abs(runs["port_f32"][0])
    report = {"batch": args.batch, "clip_sec": args.clip_sec, "grad_norm": runs["port_f32"][1],
              "port_f32_grad_share_below_1e-5": float(np.mean(g32 < 1e-5)),
              "port_f32_grad_share_zero": float(np.mean(g32 == 0))}
    for ref in ("f64_own_features", "f64_f32_features"):
        g_ref, n_ref = runs[ref]
        report[ref] = {run: {"grad_rel_l2": rel_l2(runs[run][0], g_ref),
                             "grad_norm_rel_err": abs(runs[run][1] - n_ref) / n_ref}
                       for run in ("port_f32", "jax_f32")}
    report["port_f32_vs_jax_f32_grad_rel_l2"] = rel_l2(runs["port_f32"][0], runs["jax_f32"][0])
    report["f64_references_grad_rel_l2"] = rel_l2(runs["f64_own_features"][0], runs["f64_f32_features"][0])
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    sys.exit(main() and 0)

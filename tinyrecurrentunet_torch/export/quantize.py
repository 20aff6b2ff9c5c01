"""The int8 weight packs of `tinyrecurrentunet_tpu/export/quantize.py`:
writing and reading.

A pack holds every parameter as symmetric per-tensor int8 (one float32
scale per tensor) and the BatchNorm running statistics as float32. TRQ2 is
a zlib'd JSON manifest (names, shapes, offsets, scales, the artifact's
decode-critical meta) followed by one little-endian payload, zlib'd when
that is smaller; the older format is a zip of npy files, which this module
reads only. Names are the JAX package's paths through the variables tree,
"['Block_0']/['Dense_0']/['kernel']".

Variables are nested dicts of numpy arrays in the JAX layout, as
`weights.read_npz` and `weights.variables_from_state_dict` give them and
`weights.state_dict_from_variables` maps onto the port's model. The writer
walks them as JAX walks a pytree (keys sorted at every level) and computes
the scales in numpy float64, so a pack written here is the JAX writer's
pack of the same variables, byte for byte.

Usage:
    python -m tinyrecurrentunet_torch.export.quantize -c config/proc16k.json \
        --pretrained artifacts/TRUNet-proc [--out <dir>/model_int8.trq]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import struct
import zipfile
import zlib
from typing import Any, Callable, Mapping

import numpy as np

_TRQ2_MAGIC = b"TRQ2"


def _map_tree(tree: Mapping, fn: Callable[[str, Any], Any], prefix: tuple = ()) -> dict:
    """A nested dict of the same structure with each leaf replaced by
    fn(its pack name, leaf)."""
    out = {}
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, Mapping):
            out[key] = _map_tree(value, fn, path)
        else:
            out[key] = fn("/".join(f"['{k}']" for k in path), value)
    return out


def _flatten(tree: Mapping, prefix: tuple = ()):
    """(pack name, leaf) of every leaf, in JAX's pytree order: the keys of
    every dict sorted."""
    for key in sorted(tree):
        path = prefix + (key,)
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield "/".join(f"['{k}']" for k in path), np.asarray(value)


def quantize_params(params: Mapping) -> dict:
    """-> name -> (int8 values, float32 scale), symmetric per tensor: the
    scale is max|w| / 127 (1 for an all-zero tensor), the values w / scale
    rounded and clipped to +-127."""
    out = {}
    for name, arr in _flatten(params):
        scale = float(np.max(np.abs(arr))) / 127.0
        if scale == 0.0:
            scale = 1.0
        q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
        out[name] = (q, np.float32(scale))
    return out


def save_quantized(path: str, params: Mapping, batch_stats: Mapping | None = None, meta: dict | None = None) -> int:
    """Write a TRQ2 pack of `params` (int8) and `batch_stats` (float32) with
    `meta` (values stored as strings); returns its size in bytes."""
    quantized = quantize_params(params)
    manifest = {"tensors": [], "stats": [], "payload": "raw"}
    if meta:
        manifest["meta"] = {k: str(v) for k, v in meta.items()}
    chunks = []
    offset = 0
    for name, (q, scale) in quantized.items():
        raw = np.ascontiguousarray(q, "<i1").tobytes()
        manifest["tensors"].append({"n": name, "s": list(q.shape), "o": offset, "scale": float(scale)})
        chunks.append(raw)
        offset += len(raw)
    if batch_stats is not None:
        for name, arr in _flatten(batch_stats):
            raw = np.ascontiguousarray(arr, "<f4").tobytes()
            manifest["stats"].append({"n": name, "s": list(arr.shape), "o": offset})
            chunks.append(raw)
            offset += len(raw)
    payload = b"".join(chunks)
    deflated = zlib.compress(payload, 9)
    if len(deflated) < len(payload):
        manifest["payload"] = "zlib"
        payload = deflated
    header = zlib.compress(json.dumps(manifest, separators=(",", ":")).encode(), 9)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_TRQ2_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(payload)
    return os.path.getsize(path)


def dequantize_params(quantized: dict, target_params: Mapping) -> dict:
    """The float32 parameters of a pack, in the structure of
    `target_params` (nested dicts of arrays; their values are ignored)."""

    def leaf(name, value):
        q, scale = quantized[name]
        arr = q.astype(np.float32) * scale
        if arr.shape != np.shape(value):
            raise ValueError(f"{name}: {arr.shape} != {np.shape(value)}")
        return arr

    return _map_tree(target_params, leaf)


def int8_state_dict(state_dict: Mapping) -> dict:
    """A state_dict of the port's model with its parameters through the
    pack's quantize and dequantize; the BatchNorm statistics stay float32,
    as in a pack."""
    from tinyrecurrentunet_torch.weights import state_dict_from_variables, variables_from_state_dict

    variables = variables_from_state_dict(state_dict)
    params = dequantize_params(quantize_params(variables["params"]), variables["params"])
    return state_dict_from_variables({"params": params, "batch_stats": variables["batch_stats"]})


def restore_batch_stats(stats_by_name: dict, target_stats: Mapping) -> dict:
    """The pack's BatchNorm statistics in the structure of `target_stats`."""
    return _map_tree(target_stats, lambda name, value: stats_by_name[name].reshape(np.shape(value)))


def _read_trq2(path: str):
    """(manifest, payload) of a TRQ2 pack, or None for another format."""
    with open(path, "rb") as f:
        if f.read(4) != _TRQ2_MAGIC:
            return None
        (header_len,) = struct.unpack("<I", f.read(4))
        manifest = json.loads(zlib.decompress(f.read(header_len)))
        payload = f.read()
    return manifest, payload


def load_quantized_meta(path: str) -> dict:
    """The pack's recorded decode-critical meta ({} for older packs)."""
    trq2 = _read_trq2(path)
    return {} if trq2 is None else trq2[0].get("meta", {})


def load_quantized(path: str):
    """-> (name -> (int8 values, float32 scale), name -> BatchNorm statistic).

    Reads TRQ2 packs and the older zip-of-npy format."""
    trq2 = _read_trq2(path)
    if trq2 is None:
        return _load_quantized_v1(path)
    manifest, payload = trq2
    if manifest["payload"] == "zlib":
        payload = zlib.decompress(payload)
    quantized = {}
    for t in manifest["tensors"]:
        shape = tuple(t["s"])
        n = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(payload, "<i1", count=n, offset=t["o"]).reshape(shape)
        quantized[t["n"]] = (arr, np.float32(t["scale"]))
    stats = {}
    for t in manifest["stats"]:
        shape = tuple(t["s"])
        n = int(np.prod(shape)) if shape else 1
        stats[t["n"]] = np.frombuffer(payload, "<f4", count=n, offset=t["o"]).reshape(shape)
    return quantized, stats


def _load_quantized_v1(path: str):
    quantized: dict = {}
    stats: dict = {}
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            kind, name = info.filename.split("/", 1)
            if kind == "q":
                quantized.setdefault(name, [None, None])[0] = np.load(io.BytesIO(zf.read(info)))
            elif kind == "scale":
                quantized.setdefault(name, [None, None])[1] = np.frombuffer(zf.read(info), np.float32)[0]
            elif kind == "stats":
                stats[name] = np.load(io.BytesIO(zf.read(info)))
    return {k: tuple(v) for k, v in quantized.items()}, stats


def main(argv=None) -> int:
    """Pack `<pretrained>/pretrained.npz` as an int8 .trq; returns its size."""
    from tinyrecurrentunet_torch.config import load_config
    from tinyrecurrentunet_torch.weights import artifact_meta, check_artifact_meta, read_npz

    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--pretrained", required=True, help="dir with pretrained.npz")
    parser.add_argument("--out", default=None, help="output .trq path (default <pretrained>/model_int8.trq)")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    npz = os.path.join(args.pretrained, "pretrained.npz")
    variables, meta = read_npz(npz)
    check_artifact_meta(meta, cfg, npz)
    out = args.out or os.path.join(args.pretrained, "model_int8.trq")
    size = save_quantized(out, variables["params"], variables["batch_stats"], meta=artifact_meta(cfg))
    print(f"wrote {out} ({size / 1024:.1f} KB)")
    return size


if __name__ == "__main__":
    main()

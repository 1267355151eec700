"""Weight bridge between ``woft_tpu`` parameter trees and ``WeightedRAFT``.

A ``woft_tpu`` parameter tree is a nested dict keyed like the reference's
state dict, with HWIO conv kernels. As plain numpy arrays (the tests make
them from the JAX package; this package never reads orbax):

- ``params_from_jax_numpy(tree)`` -> a flat state dict that strict-loads
  into ``WeightedRAFT``: conv kernels HWIO -> OIHW, BatchNorm step counters
  added, and the shortcut-norm aliases the reference registers twice
  (``downsample.1`` also as ``norm3`` in residual blocks, ``norm4`` in
  bottleneck blocks) emitted under both names;
- ``params_to_jax_numpy(state_dict)`` -> the nested numpy tree, dropping the
  aliases and step counters and a ``module.`` prefix.

The parameters are float32 in every precision mode: bf16 mode rounds them
where they are used (``models/layers.py``), as the reference does, so one
state dict serves ``WOFT.py`` and ``WOFT_fast.py``.
"""

import numpy as np
import torch


def params_from_jax_numpy(tree):
    """Nested dict of numpy arrays (HWIO convs) -> flat torch state dict."""
    flat = {}

    def emit(path, value):
        arr = np.asarray(value)
        if path.endswith(".weight") and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)             # HWIO -> OIHW
        flat[path] = torch.tensor(arr)

    def walk(node, prefix):
        if "running_mean" in node:
            flat[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
        for key, value in node.items():
            path = f"{prefix}.{key}" if prefix else key
            if not isinstance(value, dict):
                emit(path, value)
                continue
            walk(value, path)
            if key == "downsample" and "1" in value:
                alias = "norm4" if "conv3" in node else "norm3"
                walk(value["1"], f"{prefix}.{alias}" if prefix else alias)

    walk(tree, "")
    return flat


def params_to_jax_numpy(state_dict):
    """Flat torch state dict -> nested dict of numpy arrays (HWIO convs)."""
    keys = [k[len("module."):] if k.startswith("module.") else k
            for k in state_dict]
    values = list(state_dict.values())
    blocks_with_shortcut = {k.rsplit(".downsample.1.", 1)[0]
                            for k in keys if ".downsample.1." in k}
    tree = {}
    for key, value in zip(keys, values):
        if key.endswith("num_batches_tracked"):
            continue
        parts = key.split(".")
        block = ".".join(parts[:-2])
        if block in blocks_with_shortcut and parts[-2] in ("norm3", "norm4"):
            alias = ("norm4" if f"{block}.conv3.weight" in keys else "norm3")
            if parts[-2] == alias:
                continue
        arr = value.detach().cpu().numpy()
        if parts[-1] == "weight" and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)             # OIHW -> HWIO
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return tree

#!/usr/bin/env python3
"""Export the trained WeightedRAFT checkpoints as PyTorch state dicts.

The JAX package keeps its trained weights as orbax directories
(``weights/wraft_tpu_v4``: full frame, ``weights/wraft_tpu_v5``: window
mode, ``weights/wraft_tpu_v3``: the 'rep' flow config's and the external
backend's), which only JAX and tensorstore read. This tool restores each one
read-only with ``woft_tpu.models.checkpoint.load_checkpoint``, converts the
tree with ``woft_tpu_torch.models.convert.params_from_jax_numpy`` and writes
``weights/<name>_torch.pt`` with ``torch.save``: a flat float32 state dict
that strict-loads into ``woft_tpu_torch.models.raft.WeightedRAFT``.

It is the one bridge between the packages that needs JAX, so it runs where
the JAX package is installed, from the repository root:

    JAX_PLATFORMS=cpu python tools/export_torch_weights.py [v3 v4 v5]

The port's flow configs then load the files without JAX
(``woft_tpu_torch/configs/flow/wraft_large.py``, ``configs/WOFT_window.py``,
``configs/flow/wraft_large_rep.py``, ``configs/flow/liteflownet2.py``).
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
WEIGHTS = ROOT / "weights"


def restore_tree(name):
    """The orbax checkpoint ``weights/<name>`` as a nested dict of float32
    numpy arrays."""
    import jax
    from woft_tpu.models.checkpoint import load_checkpoint
    tree = load_checkpoint(str(WEIGHTS / name))
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, dtype=np.float32), tree)


def export_state_dict(name):
    """The torch state dict of checkpoint ``weights/<name>``."""
    from woft_tpu_torch.models.convert import params_from_jax_numpy
    return params_from_jax_numpy(restore_tree(name))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("versions", nargs="*", default=["v3", "v4", "v5"],
                        help="checkpoint versions to export (default: v3 v4 "
                             "v5)")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for version in args.versions:
        name = f"wraft_tpu_{version}"
        state = export_state_dict(name)
        out = WEIGHTS / f"{name}_torch.pt"
        torch.save(state, out)
        n_values = sum(v.numel() for v in state.values()
                       if v.is_floating_point())
        print(f"{name} -> {out.relative_to(ROOT)}: {len(state)} tensors, "
              f"{n_values} float32 values")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Convert a JAX package serving artifact into one the PyTorch port loads.

    python tools/orbax_to_torch.py --train_dir D

``<D>/serving/`` as ``k8s_tpu.models.serving.export_serving`` writes it
holds ``model_config.json`` and an orbax checkpoint of the params.  This
reads it with ``k8s_tpu.models.serving.load_serving``, maps the params
tree through ``k8s_tpu_torch.models.bridge.params_from_jax`` (dtypes
kept) and writes the port's ``params.pt`` beside the unchanged
``model_config.json`` (atomically: a temporary file, then
``os.replace``).  ``k8s_tpu_torch.models.serving.load_serving`` and the
port's server then load the directory as one of their own exports.

It imports JAX, orbax and ``k8s_tpu``, so it lives outside
``k8s_tpu_torch`` (which never imports them); run it where JAX runs.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def convert(train_dir: str) -> str:
    """Write ``<train_dir>/serving/params.pt``; returns its path."""
    import torch

    from k8s_tpu.models.serving import load_serving
    from k8s_tpu_torch.models import bridge
    from k8s_tpu_torch.models.serving import PARAMS_FILE

    _, variables = load_serving(train_dir)
    state_dict = bridge.params_from_jax(variables["params"])
    d = os.path.join(train_dir, "serving")
    path = os.path.join(d, PARAMS_FILE)
    tmp = path + ".tmp"
    torch.save(state_dict, tmp)
    os.replace(tmp, path)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_dir", required=True,
                   help="training directory whose serving/ holds the JAX "
                   "export")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    print(f"wrote {convert(args.train_dir)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

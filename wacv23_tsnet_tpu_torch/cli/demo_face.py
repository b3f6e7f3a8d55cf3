"""Weights for the face demos and the server (counterpart of the JAX
package's `cli/demo_face.py:load_params`).

The demo's own `main` needs the face datasets, which the port has not
taken over yet; `load_params` is what `cli.serve` uses.
"""

from __future__ import annotations

import os

from ..compat import load_flax_params, load_reference_checkpoint
from ..models import TSNetModules
from ..train.checkpoint import restore_generator_params


def load_params(path: str, cfg, device="cuda", seed: int = 0
                ) -> TSNetModules:
    """Generator modules of `cfg` on `device`, with the weights of `path`:
    a reference `.pth`, a flax msgpack generator file, or a full trainer
    snapshot (its `gen_params`). With no file, a random init from `seed`.
    Raises where `device` is CUDA and there is none."""
    mods = TSNetModules(cfg, device=device, seed=seed)
    if path and os.path.isfile(path):
        if path.endswith(".pth"):
            params, example = load_reference_checkpoint(path, cfg)
            load_flax_params(mods, params)
            print(f"=> loaded reference checkpoint {path} (example {example})")
            return mods
        restore_generator_params(path, mods)
        print(f"=> loaded checkpoint {path}")
        return mods
    print("=> no checkpoint found, using random init (demo smoke mode)")
    return mods

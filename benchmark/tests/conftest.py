"""CPU tests of the benchmark: toy configurations, small traffic."""

import copy
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import common, harness  # noqa: E402

TOY_TRAFFIC = {
    "clip": {"frames": 5, "chunk": 4, "subjects": 2, "clips": 2,
             "warmup_jobs": 1, "traced_jobs": 1, "check_jobs": 2},
    "train": {"batch": 2, "pool": 4, "traced_steps": 1},
}


def toy_config(task: str) -> dict:
    """A configuration file's numbers at the port's toy sizes."""
    from wacv23_tsnet_tpu_torch import configs
    cfg = configs.toy_pose_config() if task == "pose" else configs.toy_config()
    out = {k: getattr(cfg, k) for k in common.MODEL_KEYS}
    out["img_mean"] = list(out["img_mean"])
    return out


def toy_context(cell_name: str, seed: int = 7, trace: bool = False,
                seconds: float = 0.0) -> harness.Context:
    """A cell's context on the CPU at its configuration's toy sizes."""
    cell = copy.deepcopy(harness.load_json("workloads", cell_name))
    cell["traffic"].update(TOY_TRAFFIC[cell["driver"]])
    config = toy_config(harness.load_json("configs", cell["config"])["task"])
    return harness.Context(cell_name, cell, config, seed, seconds, trace,
                           torch.device("cpu"), time.perf_counter())


@pytest.fixture
def toy():
    return toy_context

"""% of the clip's chunks that the program copied back to the host
through its pinned slots on a copy stream, among all it copied back,
from its always-on counter `CLIP_COPIES` (layer: clip I/O). A program
without the counter gives None."""

import importlib

PROFILING = "wacv23_tsnet_tpu_torch.utils.profiling"


def counter() -> dict:
    """The program's chunks copied back, by path."""
    try:
        mod = importlib.import_module(PROFILING)
    except ImportError:
        return {}
    return dict(getattr(mod, "CLIP_COPIES", None) or {})


def read(rec):
    if "clip_shape" not in rec or not rec.get("trace"):
        return None
    c = counter()
    total = c.get("staged", 0) + c.get("plain", 0)
    if total <= 0:
        return None
    return 100.0 * c.get("staged", 0) / total

"""% of the clip's chunks that the program decoded on a source pack it
had already encoded for an earlier chunk of the same job, among all the
chunks it decoded, from its always-on counter `CLIP_PACKS` (layer: clip
I/O). A program without the counter gives None."""

import importlib

PROFILING = "wacv23_tsnet_tpu_torch.utils.profiling"


def counter() -> dict:
    """The program's chunks decoded, by the pack they ran on."""
    try:
        mod = importlib.import_module(PROFILING)
    except ImportError:
        return {}
    return dict(getattr(mod, "CLIP_PACKS", None) or {})


def read(rec):
    if "clip_shape" not in rec or not rec.get("trace"):
        return None
    c = counter()
    total = c.get("encoded", 0) + c.get("reused", 0)
    if total <= 0:
        return None
    return 100.0 * c.get("reused", 0) / total

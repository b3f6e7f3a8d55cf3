"""% of the encoders' and FuseNet's instance norms that the program ran
through its fused instance-norm kernel (K8), among all their norms, from
its always-on counter `TRUNK_NORMS` (layer: generator). A program
without the counter, or one that counted no norm, gives None."""

import importlib

PROFILING = "wacv23_tsnet_tpu_torch.utils.profiling"


def counter() -> dict:
    """The program's trunk norms, by the route they took."""
    try:
        mod = importlib.import_module(PROFILING)
    except ImportError:
        return {}
    return dict(getattr(mod, "TRUNK_NORMS", None) or {})


def read(rec):
    if "clip_shape" not in rec or not rec.get("trace"):
        return None
    c = counter()
    total = c.get("fused", 0) + c.get("plain", 0)
    if total <= 0:
        return None
    return 100.0 * c.get("fused", 0) / total

from .pipeline import ClipInference, montage_row, to_display_rgb
from .streaming import RetargetSession

__all__ = ["ClipInference", "RetargetSession", "montage_row",
           "to_display_rgb"]

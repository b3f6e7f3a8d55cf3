from .pipeline import ClipInference, montage_row, save_gif, to_display_rgb
from .streaming import RetargetSession

__all__ = ["ClipInference", "RetargetSession", "montage_row", "save_gif",
           "to_display_rgb"]

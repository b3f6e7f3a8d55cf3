from .flax_params import (export_flax_params, flax_to_state_dict,
                          load_flax_params, state_dict_to_flax)

__all__ = ["export_flax_params", "flax_to_state_dict", "load_flax_params",
           "state_dict_to_flax"]

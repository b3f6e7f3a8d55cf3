from .flax_params import (export_flax_params, export_train_state,
                          flax_to_state_dict, load_flax_params,
                          load_train_state, state_dict_to_flax)

__all__ = ["export_flax_params", "export_train_state", "flax_to_state_dict",
           "load_flax_params", "load_train_state", "state_dict_to_flax"]

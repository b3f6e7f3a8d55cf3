from .flax_params import (export_flax_params, export_opt_states,
                          export_train_state, flax_to_state_dict,
                          gather_flax_trees, load_flax_params,
                          load_train_state, load_train_state_dict,
                          shard_flax_tree, state_dict_to_flax,
                          tp_split_dim, train_state_dict)
from .torch_export import reference_checkpoint, save_reference_checkpoint
from .torch_import import (generator_params_from_checkpoint,
                           load_reference_checkpoint)

__all__ = ["export_flax_params", "export_opt_states", "export_train_state",
           "flax_to_state_dict", "gather_flax_trees",
           "generator_params_from_checkpoint", "shard_flax_tree",
           "tp_split_dim",
           "load_flax_params", "load_reference_checkpoint",
           "load_train_state", "load_train_state_dict",
           "reference_checkpoint", "save_reference_checkpoint",
           "state_dict_to_flax", "train_state_dict"]

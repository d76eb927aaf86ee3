from dhd_tpu_torch.io.checkpoint import (load_checkpoint, load_weights,
                                         save_checkpoint)
from dhd_tpu_torch.io.convert import (build_rules, load_jax_variables,
                                      variables_to_state_dict)

__all__ = ["build_rules", "load_checkpoint", "load_jax_variables",
           "load_weights", "save_checkpoint", "variables_to_state_dict"]

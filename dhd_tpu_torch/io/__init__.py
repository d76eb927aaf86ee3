from dhd_tpu_torch.io.convert import (build_rules, load_jax_variables,
                                      variables_to_state_dict)

__all__ = ["build_rules", "load_jax_variables", "variables_to_state_dict"]

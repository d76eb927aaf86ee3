from dhd_tpu_torch.geometry.frustum import (create_frustum, frustum_to_ego,
                                            get_mlp_input)
from dhd_tpu_torch.geometry.rigid import (inverse_3x3, rigid_inverse,
                                          rigid_relative)

__all__ = ["create_frustum", "frustum_to_ego", "get_mlp_input",
           "inverse_3x3", "rigid_inverse", "rigid_relative"]

from bench_port.reference.geometry.frustum import (create_frustum, frustum_to_ego,
                                            get_mlp_input)
from bench_port.reference.geometry.rigid import (inverse_3x3, rigid_inverse,
                                          rigid_relative)

__all__ = ["create_frustum", "frustum_to_ego", "get_mlp_input",
           "inverse_3x3", "rigid_inverse", "rigid_relative"]

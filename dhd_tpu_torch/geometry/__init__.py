from dhd_tpu_torch.geometry.frustum import (create_frustum, frustum_to_ego,
                                            get_mlp_input)

__all__ = ["create_frustum", "frustum_to_ego", "get_mlp_input"]

from dhd_tpu_torch.data.synthetic import synthetic_batch

__all__ = ["synthetic_batch"]

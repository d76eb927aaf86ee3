"""When a kernel may run: the wrappers whose kernels have no backward
(B4, B5) are launched, and B1 runs outside its ``autograd.Function``, only
where autograd records nothing."""
import torch


def records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an op on ``tensors``: grad mode is on and
    one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)

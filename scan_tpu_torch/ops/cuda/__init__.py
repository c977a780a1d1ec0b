"""Hand-written CUDA kernels K1-K6 and their plain versions.

No kernel here has a backward: a wrapper called on a tensor that needs a
gradient while grad mode is on raises (``refuse_autograd``) rather than
return a result that autograd would treat as a constant.
"""

import torch


def refuse_autograd(name: str, *tensors):
    """Raise if grad mode is on and any of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if isinstance(t, torch.Tensor)):
        raise RuntimeError(
            f"{name}: the kernel has no backward and an input requires "
            "grad; call it under torch.no_grad() or on frozen tensors, or "
            "run its plain version for a gradient")


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_raw_stream(index):
    """The current CUDA stream of device ``index`` as the handle a launch
    takes: ``torch.cuda.current_stream(index).cuda_stream`` without building
    a ``Stream`` object, for wrappers called many times a forward."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(index).cuda_stream
    return _RAW_STREAM(index)

"""The device rule of the port: every entry point takes ``device=None`` and
``None`` means the CUDA device. Without a card that raises; the CPU is used
only when the caller asks for it."""

import torch
import torch.autograd.forward_ad as fwAD


def resolve_device(device=None) -> torch.device:
    """``None`` → ``torch.device("cuda")`` (raises if no card is present);
    anything else → ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available and none was asked for: this package runs on "
                "the GPU unless the caller passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def make_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (see :func:`resolve_device`),
    seeded with ``seed``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


def tracks_grad(t) -> bool:
    """Whether a derivative flows through ``t``: autograd records it (it
    requires a gradient and grad mode is on) or it carries a forward-mode
    tangent: it takes no kernel and no CUDA graph, which have none."""
    return (t.requires_grad and torch.is_grad_enabled()) \
        or fwAD.unpack_dual(t).tangent is not None

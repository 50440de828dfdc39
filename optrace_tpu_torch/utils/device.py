"""The device rule of the port: every entry point takes ``device=None`` and
``None`` means the CUDA device. Without a card that raises; the CPU is used
only when the caller asks for it."""

import torch


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

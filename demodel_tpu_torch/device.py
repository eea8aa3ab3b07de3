"""Device resolution for the port's entry points.

Every entry point (``serve.boot``, ``GenEngine``, ``llama.init_params``,
the weight converters) runs on ``cuda`` unless the caller asks for the
CPU. Asking for CUDA on a machine without a card raises: nothing quietly
drops to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``.
    Raises when CUDA is asked for and absent, or for any other type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "false; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

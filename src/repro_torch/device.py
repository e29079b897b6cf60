"""Device resolution for the port's entry points.

No JAX counterpart: JAX picks its backend process-wide.  In the port every
entry point takes an explicit ``device`` and runs on the CUDA card unless
the caller asks for the CPU.  A missing card is an error, never a silent
move to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Raises ``RuntimeError`` when CUDA is asked for (or defaulted to) and
    no card is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available (torch.cuda.is_available() is "
            "False); pass device='cpu' (CLI: --device cpu) to run the port "
            "on the CPU")
    return dev


def new_generator(seed: int, device: Optional[torch.device] = None
                  ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(int(seed))
    return gen


def derive_seed(*parts: int) -> int:
    """A 64-bit seed mixed from integer ``parts`` (the port's counterpart
    of ``jax.random.fold_in``: distinct parts give independent streams)."""
    state = np.random.SeedSequence([int(p) for p in parts])
    return int(state.generate_state(1, np.uint64)[0])

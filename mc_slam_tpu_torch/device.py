"""The port's device default, in one place.

Every constructor of the port that takes `device=None` resolves it here:
no device given means the card. There is no probing and no quiet CPU; on a
host without a GPU the default raises where the first tensor is made, as
torch itself does. The CPU is used only when the caller asks for it
(`device="cpu"`), as the parity tests do. Functions on tensors do not come
through here: they follow the device of their inputs.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`None` -> torch.device("cuda"); anything else as given."""
    if device is None:
        return torch.device("cuda")
    return torch.device(device)

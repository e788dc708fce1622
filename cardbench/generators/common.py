"""What generators share: the dtypes a configuration may name, and
scaling to unit norm."""
from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def unit(X: torch.Tensor) -> torch.Tensor:
    return X / torch.linalg.vector_norm(X)

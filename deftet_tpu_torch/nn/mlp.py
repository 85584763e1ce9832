"""Per-point MLP decoder, the occupancy head (torch port of
deftet_tpu/nn/mlp.py): Dense+BN+ReLU per integer entry, Dropout per
fractional entry, then a bare Dense ``classifier``."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Dense, dropout


class MLPDecoder(nn.Module):
    def __init__(self, in_features: int,
                 hidden: Sequence[float] = (256, 0.2, 256, 0.2, 128, 0.2, 64),
                 out_dim: int = 1, dtype=None, generator=None):
        super().__init__()
        self.plan = []  # ("dense", i) or ("dropout", rate)
        i = 0
        for h in hidden:
            if h < 1:
                self.plan.append(("dropout", float(h)))
                continue
            self.add_module(f"Dense_{i}", Dense(in_features, int(h), dtype,
                                                generator))
            self.add_module(f"BatchNorm_{i}", BatchNorm(int(h), 1e-5,
                                                        dtype=dtype))
            self.plan.append(("dense", i))
            in_features = int(h)
            i += 1
        self.classifier = Dense(in_features, out_dim, dtype, generator)

    def input_dtype(self, dtype: torch.dtype) -> torch.dtype:
        """The dtype an input of ``dtype`` is first cast to: the first
        Dense's compute dtype (a leading dropout takes it as it comes)."""
        if self.plan and self.plan[0][0] == "dropout":
            return dtype
        first = self.Dense_0 if self.plan else self.classifier
        return first.compute_dtype(dtype)

    def forward(self, x: torch.Tensor, train: bool,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for kind, arg in self.plan:
            if kind == "dropout":
                x = dropout(x, arg, train, generator)
            else:
                x = getattr(self, f"Dense_{arg}")(x)
                x = F.relu(getattr(self, f"BatchNorm_{arg}")(x, train))
        return self.classifier(x).float()

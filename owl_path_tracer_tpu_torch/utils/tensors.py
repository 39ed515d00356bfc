"""Dataclasses of tensors: one ``.to(device)`` for every bundle type."""
from __future__ import annotations

import dataclasses

import torch


class TensorBundle:
    """Mixin for dataclasses whose fields are tensors (or nested bundles).

    ``to(device)`` moves every tensor field, recursing into nested bundles;
    other fields are carried over unchanged.
    """

    def to(self, device):
        return dataclasses.replace(
            self,
            **{f.name: _move(getattr(self, f.name), device) for f in dataclasses.fields(self)},
        )


def _move(value, device):
    if isinstance(value, (torch.Tensor, TensorBundle)):
        return value.to(device)
    return value

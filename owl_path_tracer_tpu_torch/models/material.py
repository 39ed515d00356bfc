"""Disney material table as a dataclass of tensors (counterpart of
``owl_path_tracer_tpu/models/material.py``): 15 parameters, all [M] float32
except ``base_color`` [M,3]; ``subsurface`` is parsed but unused."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.parser import MATERIAL_DEFAULTS, MATERIAL_SCALAR_FIELDS, MaterialDesc
from ..utils.tensors import TensorBundle


@dataclasses.dataclass
class Materials(TensorBundle):
    base_color: torch.Tensor
    subsurface: torch.Tensor
    metallic: torch.Tensor
    specular: torch.Tensor
    specular_tint: torch.Tensor
    roughness: torch.Tensor
    anisotropic: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    ior: torch.Tensor
    specular_transmission: torch.Tensor
    specular_transmission_roughness: torch.Tensor
    emission: torch.Tensor

    @property
    def count(self) -> int:
        return self.base_color.shape[0]

    def rows(self) -> torch.Tensor:
        """[M,17] table: base_color, then the scalar fields in order."""
        return torch.cat([self.base_color] + [getattr(self, f.name)[:, None] for f in dataclasses.fields(self)
                                              if f.name != "base_color"], dim=1)


def _from_rows(base: np.ndarray, cols: dict, device) -> Materials:
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return Materials(base_color=as_t(base), **{k: as_t(v) for k, v in cols.items()})


def from_descs(descs: list[MaterialDesc], *, device) -> Materials:
    base = np.asarray([d.base_color for d in descs], np.float32).reshape(-1, 3)
    cols = {k: [d.params[k] for d in descs] for k in MATERIAL_SCALAR_FIELDS}
    return _from_rows(base, cols, device)


def single(*, device, **overrides) -> Materials:
    """One default material with overrides (test helper)."""
    vals = dict(MATERIAL_DEFAULTS)
    vals.update(overrides)
    return _from_rows(
        np.asarray([vals["base_color"]], np.float32),
        {k: [float(vals[k])] for k in MATERIAL_SCALAR_FIELDS},
        device,
    )

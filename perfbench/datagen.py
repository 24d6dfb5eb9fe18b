"""The clustered Gaussian mixture the configurations are drawn from, made on
the device from the run's seed (a frozen copy of the law of
repro_torch/data/synthetic.py's `mixture`: centres N(0, 16 I), a uniform
component per row, unit noise).

A configuration's `data` block names the shapes:

    {"generator": "mixture", "rows": 1000000, "dim": 128, "clusters": 2000,
     "pool": 10000, "attrs": [{"kind": "int", "low": 0, "high": 10},
                              {"kind": "uniform"}]}

`pool` rows are held out: drawn from the same centres, never ingested, and
the traffic draws its query vectors from them. Rows that a mix writes
during the window come from `extra_rows`, the same law on a stream of its
own. The same seed gives the same tensors on the same device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

# torch.Generator takes seeds below 2**64; a run's --seed may exceed 2**31
_SEED_MOD = 2 ** 63


@dataclasses.dataclass
class Data:
    X: torch.Tensor          # [rows, dim] float32, ingested; asset id = row
    attrs: torch.Tensor      # [rows, n_attr] float32
    pool: torch.Tensor       # [pool, dim] float32 held-out query vectors
    centers: torch.Tensor    # [clusters, dim] float32
    attr_spec: List[Dict]


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % _SEED_MOD)
    return g


def draw_attrs(spec: List[Dict], n: int, g: torch.Generator,
               device) -> torch.Tensor:
    """[n, len(spec)] float32 attribute columns: "int" draws whole numbers
    in [low, high), "uniform" draws from [0, 1)."""
    cols = []
    for col in spec:
        if col["kind"] == "int":
            cols.append(torch.randint(int(col["low"]), int(col["high"]),
                                      (n,), generator=g, device=device
                                      ).to(torch.float32))
        elif col["kind"] == "uniform":
            cols.append(torch.rand((n,), generator=g, device=device))
        else:
            raise ValueError(f"unknown attribute kind {col['kind']!r}")
    if not cols:
        return torch.zeros((n, 0), dtype=torch.float32, device=device)
    return torch.stack(cols, dim=1)


def _rows(centers: torch.Tensor, n: int, g: torch.Generator) -> torch.Tensor:
    asg = torch.randint(0, centers.shape[0], (n,), generator=g,
                        device=centers.device)
    return centers[asg] + torch.randn((n, centers.shape[1]), generator=g,
                                      device=centers.device)


def make(spec: Dict, seed: int, device) -> Data:
    """The configuration's data, drawn on `device` from `seed`."""
    if spec.get("generator", "mixture") != "mixture":
        raise ValueError(f"unknown generator {spec['generator']!r}")
    n, d = int(spec["rows"]), int(spec["dim"])
    g = _generator(seed, 0, device)
    centers = torch.randn((int(spec["clusters"]), d), generator=g,
                          device=device) * 4.0
    X = _rows(centers, n, g)
    attrs = draw_attrs(spec.get("attrs", []), n, g, device)
    pool = _rows(centers, int(spec["pool"]), _generator(seed, 1, device))
    return Data(X=X, attrs=attrs, pool=pool, centers=centers,
                attr_spec=list(spec.get("attrs", [])))


def extra_rows(data: Data, n: int, seed: int):
    """n further rows and their attributes from the same law (the rows a
    mix writes), on the data's device: (vectors [n, dim], attrs)."""
    g = _generator(seed, 2, data.centers.device)
    vecs = _rows(data.centers, n, g)
    return vecs, draw_attrs(data.attr_spec, n, g, data.centers.device)

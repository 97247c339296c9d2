"""The seeding rule of a phase-stage SVI step, frozen here.

A fit's random draws come from integer seeds: a root key, one key per
step, and per sample site a seed from the step's key and a hash of the
site's name; the site draws ``torch.randn`` from a `torch.Generator` on
the device seeded with it.  The reference follows the same rule so that it
draws the noise the program draws, from nothing but the root key.
"""
from __future__ import annotations

import hashlib

import torch


def site_hash(name: str) -> int:
    """Stable 31-bit hash of a site name."""
    return int.from_bytes(
        hashlib.blake2s(name.encode(), digest_size=4).digest(), "little"
    ) & 0x7FFFFFFF


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed from ``seed`` and an integer."""
    h = hashlib.blake2s(f"{int(seed)}:{int(data)}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & 0x7FFFFFFFFFFFFFFF


def step_keys(root: int, steps: int) -> list[int]:
    """The guide's key of each of the first ``steps`` steps: the state key
    is fold_in(root, 1); a step evaluates its ELBO at fold_in(key, 1), whose
    guide runs at fold_in(., 0), and moves the state key to fold_in(key, 0)."""
    key = fold_in(root, 1)
    out = []
    for _ in range(steps):
        out.append(fold_in(fold_in(key, 1), 0))
        key = fold_in(key, 0)
    return out


def site_normal(guide_key: int, name: str, shape, device) -> torch.Tensor:
    """The standard normal draw (float32) of site ``name`` under
    ``guide_key``."""
    g = torch.Generator(device=device)
    g.manual_seed(fold_in(guide_key, site_hash(name)))
    return torch.randn(tuple(shape), generator=g, device=device,
                       dtype=torch.float32)

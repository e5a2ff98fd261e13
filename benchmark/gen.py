"""The benchmark's inputs, made from ``--seed`` on the device.

Every value comes from a ``torch.Generator`` seeded with a hash of (the
run's seed, what it is for, the solve index, the X plane), so

* the same seed gives the same links and sources on every run;
* a rank that holds some X planes makes exactly those planes (and the
  halo planes beside them) without making the rest: the four-card cell
  and its plain reference build the same lattice slab by slab;
* any seed up to 2**63 is taken whole (it is hashed, never truncated).

Links are unitary 3x3 matrices from Gram-Schmidt of Gaussian columns,
the third column the conjugate cross product of the first two (so SU(3));
sources are Gaussian noise in every column, split into real and
imaginary float32 planes as the port's fields are.
"""

from __future__ import annotations

import hashlib

import torch

LINKS, SOURCE, SAMPLE = "links", "source", "sample"


def subseed(*parts) -> int:
    """A 63-bit seed from any tuple of integers and names."""
    digest = hashlib.blake2b(":".join(str(p) for p in parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def unitarize(a: torch.Tensor) -> torch.Tensor:
    """SU(3) matrices [..., 3, 3] from Gaussian complex ones: Gram-Schmidt
    of the first two columns, the third their conjugate cross product."""
    c0 = a[..., 0]
    c0 = c0 / torch.linalg.vector_norm(c0, dim=-1, keepdim=True)
    c1 = a[..., 1] - (c0.conj() * a[..., 1]).sum(-1, keepdim=True) * c0
    c1 = c1 / torch.linalg.vector_norm(c1, dim=-1, keepdim=True)
    c2 = torch.linalg.cross(c0.conj(), c1.conj())
    return torch.stack([c0, c1, c2], dim=-1)


def links(seed: int, planes, rest, device) -> torch.Tensor:
    """Links U[mu, x, y, z, t, a, b], complex128, for the X planes
    ``planes`` (global indices, in the order given) of a lattice whose
    other extents are ``rest``: one generator call a plane."""
    rest = tuple(int(r) for r in rest)
    out = torch.empty((4, len(planes)) + rest + (3, 3), dtype=torch.complex128, device=device)
    for k, g in enumerate(planes):
        gen = generator(device, subseed(seed, LINKS, int(g)))
        a = torch.randn((2, 4) + rest + (3, 3), generator=gen, device=device,
                        dtype=torch.float64)
        out[:, k] = unitarize(torch.complex(a[0], a[1]))
    return out


def source(seed: int, index: int, lead, planes, rest, device):
    """Solve ``index``'s right-hand sides: (re, im) float32 tensors
    [*lead, len(planes), *rest], Gaussian in every column and feature,
    one generator call an X plane."""
    lead, rest = tuple(lead), tuple(int(r) for r in rest)
    re = torch.empty(lead + (len(planes),) + rest, device=device)
    im = torch.empty_like(re)
    axis = len(lead)
    for k, g in enumerate(planes):
        gen = generator(device, subseed(seed, SOURCE, int(index), int(g)))
        v = torch.randn((2,) + lead + rest, generator=gen, device=device)
        re.select(axis, k).copy_(v[0])
        im.select(axis, k).copy_(v[1])
    return re, im


def sampled(seed: int, index: int, share: float) -> bool:
    """Whether solve ``index`` is among those whose answer is checked: a
    draw from the seed, independent of the timing."""
    return subseed(seed, SAMPLE, int(index)) % 1_000_000 < share * 1_000_000

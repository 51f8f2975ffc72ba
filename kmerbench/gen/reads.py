"""The benchmark's read generator: one read set from a seed, made on a device.

One general generator for every read profile. A profile is data (the
"reads" block of a configuration file, kmerbench/configs/<config>.json):

  length        [min, max]: read lengths spread evenly over the range (one
                value: every read that long)
  substitution  share of bases substituted, each by one of the three other
                bases
  reverse       share of reads taken from the reverse strand
  n_per_2e26    Ns per 2^26 bases, coded as A (0), as the FASTA reader codes
                every non-ACGT byte
  repeats       {elements, length, share, divergence} or null: `elements`
                random sequences of `length` bases copied into non-overlapping
                places of the genome until `share` of it is repeats, each
                copy with `divergence` of its bases substituted

The genome is `bases / coverage` uniform random bases. The read lengths
are a fixed multiset for a given (profile, bases): every seed gets the same
sizes, in another order, so every seed asks for the same work. Everything
random comes from one torch.Generator on the device, seeded by `seed`, in a
few large calls; the same seed and device type give the same reads.
"""

from __future__ import annotations

import numpy as np
import torch

# Positions a chunk of the flat read set is built in (bounds the int64
# index arrays to 1 GiB each).
CHUNK = 1 << 27


def read_lengths(profile: dict, bases: int) -> np.ndarray:
    """The fixed multiset of read lengths (int64, ascending) for `bases`:
    a fixed length gives bases // length reads; a range [a, b] gives R reads
    spread evenly over it, R = round(bases / mean), then adjusted by one
    base a read (within the range) so that they sum to `bases` exactly."""
    lo, hi = int(profile["length"][0]), int(profile["length"][-1])
    if lo == hi:
        return np.full(bases // lo, lo, dtype=np.int64)
    r = max(1, round(2 * bases / (lo + hi)))
    lengths = lo + (np.arange(r, dtype=np.int64) * (hi - lo)) // max(1, r - 1)
    rest = bases - int(lengths.sum())
    step = 1 if rest > 0 else -1
    room = (hi - lengths) if rest > 0 else (lengths - lo)
    order = np.argsort(-room, kind="stable")
    left = abs(rest)
    for i in order:
        if left == 0:
            break
        take = min(left, int(room[i]))
        lengths[i] += step * take
        left -= take
    if left:
        raise ValueError(f"{r} reads in [{lo}, {hi}] cannot hold {bases} bases")
    return np.sort(lengths)


def _substitute(codes: torch.Tensor, count: int, gen: torch.Generator) -> None:
    """`count` positions of codes drawn uniformly (one drawn twice counts
    once, so a write never races another), each moved to one of the three
    other bases, in place."""
    if count <= 0:
        return
    n = codes.numel()
    pos = torch.unique(torch.randint(0, n, (count,), generator=gen, device=codes.device))
    delta = torch.randint(1, 4, pos.shape, generator=gen, device=codes.device,
                          dtype=torch.uint8)
    codes[pos] = (codes[pos] + delta) % 4


def make_genome(profile: dict, size: int, gen: torch.Generator, device) -> torch.Tensor:
    """(size,) uint8 genome in [0, 3] with the profile's repeats copied in."""
    genome = torch.randint(0, 4, (size,), generator=gen, device=device, dtype=torch.uint8)
    rep = profile.get("repeats")
    if not rep:
        return genome
    length = int(rep["length"])
    copies = round(rep["share"] * size / length)
    slots = size // length
    if copies > slots:
        raise ValueError(f"{copies} repeat copies of {length} bases in a genome of {size}")
    if copies == 0:
        return genome
    elements = torch.randint(0, 4, (int(rep["elements"]), length), generator=gen,
                             device=device, dtype=torch.uint8)
    where = torch.randperm(slots, generator=gen, device=device)[:copies] * length
    body = elements[torch.arange(copies, device=device) % elements.shape[0]].reshape(-1)
    _substitute(body, round(rep["divergence"] * body.numel()), gen)
    idx = where[:, None] + torch.arange(length, device=device)[None, :]
    genome[idx.reshape(-1)] = body
    return genome


def make_reads(profile: dict, bases: int, coverage: float, seed: int, device
               ) -> tuple[torch.Tensor, np.ndarray]:
    """The read set of `bases` bases: (codes (N,) uint8 in [0, 3] on
    `device`, lengths (R,) int64 on the host), N = lengths.sum()."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    lengths = read_lengths(profile, bases)
    genome_size = int(bases // coverage)
    if genome_size < int(lengths.max()):
        raise ValueError(f"a genome of {genome_size} bases for reads of {lengths.max()}")
    genome = make_genome(profile, genome_size, gen, device)
    r = lengths.size
    order = torch.randperm(r, generator=gen, device=device)
    lens_d = torch.from_numpy(lengths).to(device)[order]
    span = (genome_size - lens_d + 1).to(torch.float64)
    starts = (torch.rand(r, generator=gen, device=device, dtype=torch.float64) * span
              ).to(torch.int64).clamp_(max=genome_size - lens_d)
    reverse = torch.rand(r, generator=gen, device=device) < float(profile["reverse"])
    offsets = torch.zeros(r + 1, dtype=torch.int64, device=device)
    torch.cumsum(lens_d, 0, out=offsets[1:])
    n = int(offsets[-1])
    codes = torch.empty(n, dtype=torch.uint8, device=device)
    bounds = offsets.cpu().numpy()
    first = 0
    while first < r:
        # Reads [first, last) in one chunk of at most CHUNK bases (at least one read).
        last = max(first + 1, int(np.searchsorted(bounds, bounds[first] + CHUNK, "right")) - 1)
        last = min(last, r)
        lo, hi = int(bounds[first]), int(bounds[last])
        rid = torch.repeat_interleave(torch.arange(first, last, device=device),
                                      lens_d[first:last])
        q = torch.arange(lo, hi, device=device) - offsets[rid]
        rev = reverse[rid]
        src = torch.where(rev, starts[rid] + lens_d[rid] - 1 - q, starts[rid] + q)
        base = genome[src]
        codes[lo:hi] = torch.where(rev, 3 - base, base)
        del rid, q, rev, src, base
        first = last
    del genome
    _substitute(codes, round(float(profile["substitution"]) * n), gen)
    n_count = round(float(profile.get("n_per_2e26", 0)) * n / (1 << 26))
    if n_count:
        codes[torch.randint(0, n, (n_count,), generator=gen, device=device)] = 0
    return codes, lens_d.cpu().numpy()


def host_reads(profile: dict, bases: int, coverage: float, seed: int, device
               ) -> tuple[np.ndarray, np.ndarray]:
    """make_reads, copied to host arrays (codes uint8, lengths int64), with
    the device's memory given back."""
    codes, lengths = make_reads(profile, bases, coverage, seed, device)
    host = codes.cpu().numpy()
    del codes
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    return host, lengths

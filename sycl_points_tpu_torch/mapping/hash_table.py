"""Open-addressing hash-table primitives of the map backends.

Counterpart of :mod:`sycl_points_tpu.mapping.hash_table`: double hashing on a
power-of-two capacity, a read-only lookup loop and a *scatter-claim* insert
loop (every unresolved key writes a ticket at its probe slot and re-reads to
find the winner). Keys must be unique within a batch; the map's sort /
segment-reduce pre-aggregation sees to that.

What differs from the JAX side, and why:

  * PyTorch has little uint32 arithmetic, so the hashes and the packed
    coordinates are computed in int64 and masked to 32 bits; ``hash_coords``
    and ``_pack2`` give the same values, bit for bit.
  * Inside the loops a slot is one int64 (the two packed planes side by side,
    -1 when empty: bit 31 of the low plane is never set by a real key), so a
    probe round is one gather and tells "empty" and "match" from it.
  * The claim is a ``scatter_reduce_(amin)`` on the ticket, so the lowest
    ticket wins and a run repeats itself on the card. The JAX scatter leaves
    the winner unspecified, so *which slot* a voxel lands in may differ
    between the packages; the map as a set does not.
  * Each loop's exit test is a host read (counted in ``utils.sync``). It is
    made once every ``ROUNDS_PER_CHECK`` probe rounds; a round on settled
    keys changes nothing, so the result does not depend on that number.

A fleet's tables are stacked: ``coords_tbl [B, C, 3]``, ``used [B, C]``, keys
``[B, M, 3]``. They run as one table of ``B * C`` slots in which stream
``b``'s probe sequence is offset by ``b * C``, so one set of probe rounds and
one exit test a round serve all streams, and stream ``b``'s slots, claims and
winners are those of a single-stream call on its own table (its tickets keep
their order, and no other stream's key ever probes its slots). Slots come back
as each stream's own (``[0, C)``).
"""

from __future__ import annotations

import torch

from sycl_points_tpu_torch.utils.sync import to_host

_SENTINEL = 2**31 - 1
_MASK21 = (1 << 21) - 1
_M32 = 0xFFFFFFFF
_EMPTY = -1
ROUNDS_PER_CHECK = 2


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 values reinterpreted as uint32, held in int64."""
    return x.to(torch.int64) & _M32


def _mul32(x: torch.Tensor, a: int) -> torch.Tensor:
    """``x * a`` modulo 2^32 for ``x`` in [0, 2^32) held in int64, without
    leaving the int64 range."""
    lo = x * (a & 0xFFFF)
    hi = ((x * (a >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_coords(coords: torch.Tensor, capacity: int):
    """Double hashing ``(h1, h2)`` from 3 int32 voxel coordinates, as uint32
    values held in int64; ``capacity`` must be a power of two (the odd ``h2``
    gives a full probe cycle)."""
    c = _u32(coords)
    h1 = _mul32(c[..., 0], 73856093) ^ _mul32(c[..., 1], 19349669) ^ _mul32(c[..., 2], 83492791)
    h2 = _mul32(h1, 2654435761) | 1
    return h1 & (capacity - 1), h2


def probe_slots(h1: torch.Tensor, h2: torch.Tensor, probe: int, capacity: int) -> torch.Tensor:
    """The slot (int64) of probe number ``probe``."""
    return (h1 + probe * h2) & (capacity - 1)


def _pack2(coords: torch.Tensor):
    """3 x 21-bit coordinates -> two uint32 planes held in int64
    (x:21|y_hi:11, y_lo:10|z:21)."""
    c = _u32(coords)
    hi = ((c[..., 0] << 11) & _M32) | (c[..., 1] >> 10)
    lo = ((c[..., 1] & 0x3FF) << 21) | (c[..., 2] & _MASK21)
    return hi, lo


def _unpack2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    x = (hi >> 11) & _MASK21
    y = ((hi & 0x7FF) << 10) | (lo >> 21)
    z = lo & _MASK21
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def _slot_keys(coords: torch.Tensor) -> torch.Tensor:
    """One int64 a row: the two packed planes side by side."""
    hi, lo = _pack2(coords)
    return (hi << 32) | lo


def _stream_base(lead, rows: int, device):
    """The first flat row of each stream (``[B, 1]``), or 0 for one stream."""
    return torch.arange(lead[0], device=device)[:, None] * rows if lead else 0


def compact_indices(keep: torch.Tensor, out_capacity: int):
    """Slot indices of the first ``out_capacity`` True entries of ``keep``, in
    slot order, by cumsum and scatter: ``(idx [out_capacity] int64, mask
    [out_capacity] bool)``; entries beyond the number of kept slots point at
    slot 0 and are masked. A fleet's ``keep [B, C]`` gives ``[B,
    out_capacity]`` of each stream's own slots."""
    lead, C = keep.shape[:-1], keep.shape[-1]
    dev = keep.device
    csum = torch.cumsum(keep.to(torch.int64), -1)
    dest = torch.where(keep & (csum <= out_capacity), csum - 1, out_capacity)
    idx = torch.zeros(lead + (out_capacity + 1,), dtype=torch.int64, device=dev).reshape(-1)
    idx.index_copy_(0, (dest + _stream_base(lead, out_capacity + 1, dev)).reshape(-1),
                    torch.arange(C, device=dev).expand(keep.shape).reshape(-1))
    n = torch.clamp_max(csum[..., -1:], out_capacity)
    mask = torch.arange(out_capacity, device=dev) < n
    return idx.reshape(lead + (out_capacity + 1,))[..., :out_capacity], mask.reshape(lead + (out_capacity,))


def compact_indices_ranked(keep: torch.Tensor, rank: torch.Tensor, out_capacity: int):
    """:func:`compact_indices` with overflow accounting and rank-ordered
    retention: when more slots are kept than fit, the ``out_capacity`` of
    smallest ``rank`` are taken (a sort, paid only then) instead of a subset
    in slot order. The choice is a host branch on one fetched count.

    Returns ``(idx, mask, n_overflow)``; ``n_overflow`` (0-dim int32) counts
    the kept slots that did not fit. For a fleet's ``keep [B, C]`` the one
    read asks whether any stream overflowed, and each stream that did takes
    its rank order (``n_overflow`` is ``[B]``)."""
    lead, C = keep.shape[:-1], keep.shape[-1]
    dev = keep.device
    if out_capacity >= C:  # overflow impossible: every slot fits
        idx, mask = compact_indices(keep, out_capacity)
        return idx, mask, torch.zeros(lead, dtype=torch.int32, device=dev)
    n_keep = keep.sum(-1, dtype=torch.int32)
    n_overflow = torch.clamp_min(n_keep - out_capacity, 0)
    idx, mask = compact_indices(keep, out_capacity)
    if to_host(n_overflow.max()) > 0:
        key = torch.where(keep, rank.to(torch.float32), torch.inf)
        ranked = torch.sort(key, dim=-1, stable=True)[1][..., :out_capacity]
        over = (n_overflow > 0)[..., None]
        idx = torch.where(over, ranked, idx)
        mask = mask | over
    return idx, mask, n_overflow


def _lookup(table: torch.Tensor, keys: torch.Tensor, h1, h2, valid, capacity: int, max_probes: int, base=0):
    """The read-only probe loop over ``table`` (slot keys, -1 when empty):
    ``(slot [M] int64 (-1 when missing), found [M])``. A key is settled once
    it is found or meets an empty slot on its chain. ``base`` offsets each
    key's probe sequence (its stream's first slot in a stacked table)."""
    slot = torch.full_like(keys, -1)
    found = torch.zeros_like(valid)
    dead = torch.zeros_like(valid)
    probe = 0
    while probe < max_probes:
        for _ in range(min(ROUNDS_PER_CHECK, max_probes - probe)):
            cand = base + probe_slots(h1, h2, probe, capacity)
            tk = table[cand]
            new_found = valid & ~found & ~dead & (tk == keys)
            slot = torch.where(new_found, cand, slot)
            found = found | new_found
            dead = dead | (tk == _EMPTY)
            probe += 1
        if not to_host((valid & ~found & ~dead).any()):
            break
    return slot, found


def resolve_slots(coords_tbl, used, keys, valid, capacity: int, max_probes: int):
    """Find or claim a slot for each unique key.

    Returns ``(coords_tbl', used', slot [M] int64 (-1 unresolved), resolved
    [M] bool)``; the inputs are left as they were. A fleet's stacked tables
    and keys (see the module's docstring) give ``[B, ...]`` results.

    Two phases. Read-only lookup rounds settle every key that is already in
    the table or provably not (an empty slot on its chain); in the steady
    state of map insertion that is nearly all of them. Claim rounds run only
    for the keys the lookup proved absent: each writes its ticket (its row
    number) at its first free probe slot, the lowest ticket wins the slot,
    and the losers probe on.
    """
    return _resolve(coords_tbl, used, keys, valid, capacity, max_probes)[:4]


def _resolve(coords_tbl, used, keys, valid, capacity: int, max_probes: int, also=None):
    """:func:`resolve_slots`, and the host value of the 0-dim bool ``also``,
    fetched with the claim phase's first exit test (no read of its own)."""
    lead = keys.shape[:-2]
    dev = keys.device
    shape_k = keys.shape[:-1]
    keys, valid = keys.reshape(-1, 3), valid.reshape(-1)
    coords_tbl, used = coords_tbl.reshape(-1, 3), used.reshape(-1)
    M, total = keys.shape[0], used.shape[0]  # rows and slots of all streams
    base = _stream_base(lead, capacity, dev)
    if lead:
        base = base.expand(shape_k).reshape(-1)
    h1, h2 = hash_coords(keys, capacity)
    kk = _slot_keys(keys)
    # One spare slot at the end takes the writes of keys that claim nothing.
    table = torch.full((total + 1,), _EMPTY, dtype=torch.int64, device=dev)
    table[:total] = torch.where(used, _slot_keys(coords_tbl), _EMPTY)

    slot, found = _lookup(table, kk, h1, h2, valid, capacity, max_probes, base)

    unresolved = valid & ~found
    claimed = torch.zeros_like(valid)
    tickets = torch.arange(M, device=dev)
    pending, also_h = to_host(torch.stack([unresolved.any(), valid.new_zeros(()) if also is None else also]))
    probe = 0
    while probe < max_probes and pending:
        for _ in range(min(ROUNDS_PER_CHECK, max_probes - probe)):
            cand = base + probe_slots(h1, h2, probe, capacity)
            try_claim = unresolved & (table[cand] == _EMPTY)
            claim = torch.full((total + 1,), M, dtype=torch.int64, device=dev)
            claim.scatter_reduce_(0, torch.where(try_claim, cand, total), tickets, "amin")
            winner = try_claim & (claim[cand] == tickets)
            slot = torch.where(winner, cand, slot)
            table.index_copy_(0, torch.where(winner, cand, total), kk)
            claimed = claimed | winner
            unresolved = unresolved & ~winner
            probe += 1
        pending = probe < max_probes and to_host(unresolved.any())

    w_idx = torch.where(claimed, slot, total)
    coords_out = torch.cat([coords_tbl, coords_tbl.new_full((1, 3), _SENTINEL)])
    coords_out.index_copy_(0, w_idx, keys)
    used_out = torch.cat([used, used.new_zeros(1)])
    used_out.index_fill_(0, w_idx, True)
    slot = torch.where(slot >= 0, slot - base, -1)
    return (coords_out[:total].reshape(lead + (-1, 3)), used_out[:total].reshape(lead + (-1,)),
            slot.reshape(shape_k), (valid & ~unresolved).reshape(shape_k), also_h)


def resolve_slots_tiered(coords_tbl, used, keys, valid, capacity: int, max_probes: int, tier: int = 16384):
    """:func:`resolve_slots` whose cost follows the count of valid keys, not
    the width of the batch, for batches whose valid keys form a prefix (the
    occupancy map's merged miss keys are rank-ordered).

    The front ``tier`` rows are resolved; the tail only when it holds a valid
    key. The tail test travels with the front's first claim-phase read, so
    it costs no host read of its own (JAX decides it in a ``lax.cond``)."""
    M = keys.shape[-2]
    if M <= tier:
        return resolve_slots(coords_tbl, used, keys, valid, capacity, max_probes)
    vt = valid[..., tier:]
    c, u, s1, r1, tail = _resolve(coords_tbl, used, keys[..., :tier, :], valid[..., :tier], capacity, max_probes,
                                  also=vt.any())
    if tail:
        c, u, s2, r2 = resolve_slots(c, u, keys[..., tier:, :], vt, capacity, max_probes)
    else:
        s2, r2 = torch.full_like(vt, -1, dtype=s1.dtype), torch.zeros_like(vt)
    return c, u, torch.cat([s1, s2], -1), torch.cat([r1, r2], -1)


def lookup_slots(coords_tbl, used, keys, valid, capacity: int, max_probes: int):
    """Read-only lookup: ``(slot [M] int64 (-1 missing), found [M])``. Ends
    once every key is found or proven absent."""
    h1, h2 = hash_coords(keys, capacity)
    table = torch.where(used, _slot_keys(coords_tbl), _EMPTY)
    return _lookup(table, _slot_keys(keys), h1, h2, valid, capacity, max_probes)

"""Per-frame event queues as fixed-capacity buffers, batched over
instances (bonnie32_tpu/game/events.py).

Reference: event.rs — EventQueue<T> (:21) with push / drain / clear, and
the Events aggregate (:69) of damage, death, spawn, checkpoint, door,
item, collision and respawn queues, cleared every frame (runtime.rs:482).

Each queue holds a count and columns per instance, (I,) and (I, C):
pushes are masked, and a push past the capacity drops and counts in
`dropped` (the reference's Vec would grow; the capacity is a frame's
worth of events).  A value pushed is one for all instances or one per
instance.
"""

from typing import NamedTuple

import torch


class EventQueue(NamedTuple):
    """One typed queue: i32 payload lanes (entities, amounts,
    discriminants) and an f32 position lane."""

    count: torch.Tensor    # (I,) i32
    dropped: torch.Tensor  # (I,) i32
    a: torch.Tensor        # (I, C) i32 (e.g. target / entity)
    b: torch.Tensor        # (I, C) i32 (e.g. source / amount)
    c: torch.Tensor        # (I, C) i32 (e.g. amount / discriminant)
    pos: torch.Tensor      # (I, C, 3) f32


def new_queue(n_instances: int, capacity: int = 32,
              device=None) -> EventQueue:
    """Empty queues of `capacity` for `n_instances` instances on
    `device` (default: the card)."""
    from ..types import resolve_device
    device = resolve_device(device)

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    i, c = n_instances, capacity
    return EventQueue(count=z(i), dropped=z(i), a=z(i, c), b=z(i, c),
                      c=z(i, c), pos=z(i, c, 3, dtype=torch.float32))


def _per_instance(v, n, dtype, device, tail=()):
    """`v` (one value for all, or one per instance) as an (n, *tail)
    tensor."""
    return torch.as_tensor(v, dtype=dtype, device=device).expand(
        (n,) + tail)


def push(q: EventQueue, a=0, b=0, c=0, pos=(0.0, 0.0, 0.0),
         enabled=True) -> EventQueue:
    """Masked push (event.rs:33) onto every instance's queue; a no-op
    where `enabled` is False."""
    n, cap = q.a.shape
    dev = q.a.device
    enabled = _per_instance(enabled, n, torch.bool, dev)
    fits = enabled & (q.count < cap)
    rows = torch.arange(n, device=dev)
    idx = torch.where(fits, q.count, torch.zeros_like(q.count)).long()

    def put(arr, val):
        out = arr.clone()
        tail = tuple(arr.shape[2:])
        val = _per_instance(val, n, arr.dtype, dev, tail)
        keep = fits.reshape((n,) + (1,) * len(tail))
        out[rows, idx] = torch.where(keep, val, arr[rows, idx])
        return out

    return EventQueue(
        count=q.count + fits.to(torch.int32),
        dropped=q.dropped + (enabled & ~fits).to(torch.int32),
        a=put(q.a, a), b=put(q.b, b), c=put(q.c, c), pos=put(q.pos, pos))


def push_many(q: EventQueue, mask, a=None, b=None, c=None,
              pos=None) -> EventQueue:
    """Append every instance's masked rows (mask (I, n)) in index order:
    a stable compaction, each selected row to the next free slot, rows
    past the capacity dropped and counted.  Lanes not given push 0 (the
    position lane keeps its contents)."""
    n_inst, cap = q.a.shape
    n = mask.shape[1]
    dev = q.a.device
    mask = mask.to(torch.bool)
    k = mask.sum(1).to(torch.int32)
    # slot of each selected row: the count before it plus the rows of its
    # instance selected ahead of it
    rank = torch.cumsum(mask.to(torch.int32), 1) - 1
    slot = q.count[:, None] + rank
    ok = mask & (slot < cap)
    rows = torch.arange(n_inst, device=dev)[:, None].expand(-1, n)[ok]
    dst = slot[ok].long()

    def scat(arr, vals):
        out = arr.clone()
        if vals is None:
            vals = torch.zeros((n_inst, n) + tuple(arr.shape[2:]),
                               dtype=arr.dtype, device=dev)
        vals = torch.as_tensor(vals, dtype=arr.dtype, device=dev).expand(
            (n_inst, n) + tuple(arr.shape[2:]))
        out[rows, dst] = vals[ok]
        return out

    return EventQueue(
        count=torch.clamp(q.count + k, max=cap),
        dropped=q.dropped + torch.clamp(q.count + k - cap, min=0),
        a=scat(q.a, a), b=scat(q.b, b), c=scat(q.c, c),
        pos=q.pos if pos is None else scat(q.pos, pos))


def clear(q: EventQueue) -> EventQueue:
    """event.rs:49 — counts reset; storage reused."""
    return q._replace(count=torch.zeros_like(q.count),
                      dropped=torch.zeros_like(q.dropped))


class Events(NamedTuple):
    """event.rs:69 — the aggregate.  Lane meanings:
    damage:      a=target, b=source, c=amount, pos=hit position
    death:       a=entity, c=team, pos=death position
    pickup:      a=item entity, b=key type, c=amount
    door:        a=door, b=opener, c=1 opened / 0 blocked
    checkpoint:  a=checkpoint, b=player
    collision:   a=entity A, b=entity B
    respawn:     a=player, pos=respawn position
    spawn:       a=new entity, c=kind
    """

    damage: EventQueue
    death: EventQueue
    pickup: EventQueue
    door: EventQueue
    checkpoint: EventQueue
    collision: EventQueue
    respawn: EventQueue
    spawn: EventQueue


def new_events(n_instances: int, capacity: int = 32, device=None) -> Events:
    return Events(*(new_queue(n_instances, capacity, device)
                    for _ in range(8)))


def clear_all(ev: Events) -> Events:
    """runtime.rs:482 — end-of-frame clear."""
    return Events(*(clear(q) for q in ev))

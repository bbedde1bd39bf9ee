"""Capped-bucket owner routing over a feature group: the shared comm core.

The port of ``quiver_tpu/parallel/routing.py`` (``BucketRoute``). The JAX
package runs it inside ``shard_map``, one request vector per device, with
``all_to_all``, ``psum`` and ``all_gather`` over the mesh axis. Here one
process holds every member of the group at once, so the plan takes the
members' ``(F, L)`` request vectors together and the collectives become
tensor operations:

1. each member's requests are sorted by owning shard (stable; results come
   back through the inverse permutation);
2. destination buckets are packed, CAPPED at ``cap`` lanes each, into one
   ``(F_src, F_dst, cap)`` tensor; the ``all_to_all`` is its transpose;
3. each owner serves the requests it received (the caller's ``serve``),
   and the answers return by the transpose again;
4. lanes past their bucket's capacity are served exactly by the fallback:
   every member's overflow lanes (the ``all_gather``: a stack), served by
   every owner with the rows it owns, summed over the members in member
   order (the ``psum``), each member keeping its own slice.

The JAX package runs the fallback only when the psum'd overflow count is
positive (a ``lax.cond``); deciding that here would read the count on the
host in every step. So the fallback always runs over its static ``(F,
L - cap)`` budget, riding in the same ``serve`` call as the main buckets;
lanes that did not overflow are ``-1`` and come back as zero rows, which
the merge drops. The answers are the same bitwise either way: at most
``L`` lanes are valid and every overflowing bucket keeps its first ``cap``,
so the total overflow of a member is at most ``L - cap``. Capped and
uncapped routing (``cap >= L``) return the same answers bitwise.

Each collective is marked where it runs (``obs.marks.collective``, over
the ``feature`` axis): the overflow count's ``psum`` (capped plans), the
two ``all_to_all`` transposes (and a payload's), the overflow lanes'
``all_gather`` and the fallback's ``psum``, so the program audit
(``tools/audit``) sees JAX's collective schedule.

On a world mesh (``group=``, the rank's feature group) each process is one
member and holds only its own ``(L,)`` requests, as a JAX device does: the
``(F_dst, cap)`` send buckets (requests, a payload, the answers on their
way back) go over the group's ``all_to_all``, the overflow lanes over its
``all_gather``, the fallback and the overflow count over its sums
(``parallel/world.py``), and ``serve`` is called once, for this member.
The plan and the merge are the logical form's code over one row, so the
answers are bitwise the logical mesh's; the static fallback budget and the
rule of no host read hold alike.
"""

from __future__ import annotations

import torch

from ..obs.marks import collective
from . import world
from .mesh import FEATURE_AXIS

__all__ = ["BucketRoute"]


class BucketRoute:
    """One planned owner-routing of a feature group's request vectors.

    The plan (owner sort, bucket bounds, overflow mask) is made once;
    :meth:`exchange` routes any number of request or payload exchanges
    through the same buckets (the distributed sampler routes ids, then per
    id sample offsets).

    Args:
      ids: ``(F, L)`` integer request keys, one row per group member;
        invalid lanes may hold anything (sanitised to 0, never routed).
      valid: ``(F, L)`` bool. Invalid lanes go to a sentinel bucket past
        the real ones, take no bucket capacity and come back as zeros.
      owner: ``(F, L)`` owning member in ``[0, F)`` (anything on invalid
        lanes).
      num_shards: F, the group's size (``ids.shape[0]``).
      cap: per-destination bucket capacity; ``None`` or ``>= L`` is the
        uncapped full-length mode, whose :attr:`overflow` is 0 and which
        has no fallback.
      tape: optional ``obs.MetricsTape``; the plan's :attr:`overflow` is
        added to it as counter ``metric`` (default ``obs.ROUTED_OVERFLOW``).
      group: the world form: this rank's feature group
        (``WorldMesh.group("feature")``); ``ids``, ``valid`` and ``owner``
        are then this member's ``(L,)`` (or ``(1, L)``) rows.

    :attr:`overflow` is the group's total of fallback-served lanes, an
    int32 scalar on the requests' device (never read back here);
    :attr:`member_overflow` the ``(F,)`` lanes of each member (``(1,)``,
    this member's, in the world form).
    """

    def __init__(self, ids, valid, owner, *, num_shards: int,
                 cap: int | None = None, tape=None, metric: str | None = None,
                 group=None):
        F = int(num_shards)
        self._group = group
        if group is not None:
            if len(group.ranks) != F:
                raise ValueError(f"a world group of {len(group.ranks)} ranks routes "
                                 f"over {F} shards")
            ids, valid, owner = (t.reshape(1, -1) for t in (ids, valid, owner))
        rows = 1 if group is not None else F
        if ids.dim() != 2 or ids.shape[0] != rows:
            raise ValueError(f"ids must be ({rows}, L), one row per member held; got "
                             f"{tuple(ids.shape)}")
        L = int(ids.shape[1])
        if cap is None or int(cap) >= L:
            cap = L  # full-length buckets ARE the uncapped exact-safe mode
        cap = int(cap)
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        self.num_shards = F
        self.length = L
        self.cap = cap
        dev = ids.device
        self._valid = valid
        self._members = torch.arange(rows, device=dev)[:, None]
        safe = torch.where(valid, ids, torch.zeros((), dtype=ids.dtype, device=dev))
        # invalid lanes go to a sentinel bucket F past the real ones: they
        # are never routed, take no bucket capacity, and cannot fake overflow
        owner = torch.where(valid, owner.to(torch.int64).clamp(0, F - 1), F)
        order = torch.argsort(owner, dim=1, stable=True)
        self._order = order
        self._sorted_ids = safe.gather(1, order)
        sorted_owner = owner.gather(1, order)
        sorted_valid = valid.gather(1, order)
        bounds = torch.searchsorted(
            sorted_owner, torch.arange(F + 1, device=dev).expand(rows, F + 1).contiguous())
        self._start, ends = bounds[:, :F], bounds[:, 1:]
        self._counts = ends - self._start
        self._owner_c = sorted_owner.clamp(0, F - 1)
        self._slot = (torch.arange(L, device=dev)[None, :]
                      - self._start.gather(1, self._owner_c))

        # overflow bookkeeping (absent when cap == L)
        self.ov_budget = L - cap
        if self.ov_budget == 0:
            self._ov_mask = None
            self.member_overflow = torch.zeros(F, dtype=torch.int32, device=dev)
        else:
            self._ov_mask = sorted_valid & (self._slot >= cap)
            self.member_overflow = self._ov_mask.sum(1, dtype=torch.int32)
            # my overflow lanes first in sorted order (stable), cut to the
            # static budget
            self._ov_take = torch.argsort((~self._ov_mask).to(torch.int8), dim=1,
                                          stable=True)[:, :self.ov_budget]
            self._ov_rank = self._ov_mask.to(torch.int64).cumsum(1) - 1
        self.overflow = self.member_overflow.sum(dtype=torch.int32)
        if self.ov_budget:
            if group is not None:
                self.overflow = world.int_sum(self.overflow, group, (FEATURE_AXIS,))
            else:
                collective("psum", (FEATURE_AXIS,), self.overflow)
        # the routed request ids, kept after the first exchange: a second
        # exchange through the same plan sends only its payload
        self._requests = None
        if tape is not None:
            from ..obs.registry import ROUTED_OVERFLOW

            tape.add(metric or ROUTED_OVERFLOW, self.overflow)

    @property
    def group(self):
        """The world form's feature group (None: the group form)."""
        return self._group

    # -- internals ----------------------------------------------------------

    def _bucketize(self, sorted_vals, fill):
        """``(F, L, ...)`` sorted per-lane values -> ``(F_src, F_dst, cap,
        ...)`` send buckets: the first ``cap`` lanes per destination,
        ``fill`` elsewhere."""
        cap, L = self.cap, self.length
        j = torch.arange(cap, device=sorted_vals.device)
        pos = (self._start[:, :, None] + j).clamp(0, L - 1)
        live = j < self._counts.clamp(max=cap)[:, :, None]
        vals = sorted_vals[self._members[:, :, None], pos]
        live = live.reshape(live.shape + (1,) * (vals.dim() - 3))
        return torch.where(live, vals, torch.full((), fill, dtype=vals.dtype,
                                                  device=vals.device))

    def _compact_overflow(self, sorted_vals, fill):
        """``(F, L, ...)`` sorted values -> ``(F, ov_budget, ...)``: each
        member's overflow lanes first, ``fill`` past its count."""
        take = sorted_vals[self._members, self._ov_take]
        live = (torch.arange(self.ov_budget, device=take.device)[None, :]
                < self.member_overflow[:, None])
        live = live.reshape(live.shape + (1,) * (take.dim() - 2))
        return torch.where(live, take, torch.full((), fill, dtype=take.dtype,
                                                  device=take.device))

    # -- API ----------------------------------------------------------------

    def _transpose(self, send):
        """The ``all_to_all`` of ``(rows, F_dst, cap, ...)`` send buckets:
        each member's received ``(F_src, cap, ...)`` buckets, in member
        order (this member's alone in the world form)."""
        if self._group is not None:
            return [world.all_to_all(send[0], self._group, (FEATURE_AXIS,))]
        collective("all_to_all", (FEATURE_AXIS,), send)
        return list(send.transpose(0, 1))

    def _gather_overflow(self, sorted_vals, fill):
        """The ``all_gather`` of every member's compacted overflow lanes:
        ``(F * ov_budget, ...)``, member-major."""
        ov = self._compact_overflow(sorted_vals, fill)
        if self._group is not None:
            ov = world.all_gather(ov[0], self._group, (FEATURE_AXIS,))
        else:
            collective("all_gather", (FEATURE_AXIS,), ov)
        return ov.flatten(0, 1)

    def requests(self) -> list:
        """The flat ids that each owner serves in every exchange: member
        ``d``'s ``(F * cap,)`` received bucket lanes, then (when the plan
        has a fallback) every member's ``ov_budget`` overflow lanes; ``-1``
        on dead lanes (one entry, this member's, in the world form). Made
        at the first call and kept: every exchange hands ``serve`` these
        same tensors, so an owner may compute what it needs of its ids once
        per plan."""
        if self._requests is None:
            recv = self._transpose(self._bucketize(self._sorted_ids, -1))
            reqs = [r.reshape(-1) for r in recv]
            if self.ov_budget > 0:
                ov_ids = self._gather_overflow(self._sorted_ids, -1)
                reqs = [torch.cat([r, ov_ids]) for r in reqs]
            self._requests = reqs
        return self._requests

    def exchange(self, serve, payload=None):
        """Route the planned ids (and the optional ``(F, L, ...)``
        ``payload``; this member's ``(L, ...)`` in the world form) to their
        owners, serve, and return ``(F, L, ...)`` answers in the original
        lane order (zeros on invalid lanes; ``(L, ...)`` in the world form).

        ``serve(member, ids[, payload])`` receives the flat ids that owner
        ``member`` must answer (``-1`` on dead lanes; the tensor
        ``requests()[member]``, the same in every exchange) and the matching
        payload, and returns one answer per id that is ZERO for ids the
        member does not own and for ids below 0: that masking is what
        makes the summed fallback exact. It is called once per member held
        (once, for this rank's member, in the world form); its answers for
        the main buckets and the fallback come from that one call.
        """
        F, cap = self.num_shards, self.cap
        group = self._group
        held = range(F) if group is None else [group.index]
        requests = self.requests()
        recv_pay = sorted_pay = None
        if payload is not None:
            if group is not None:
                payload = payload.unsqueeze(0)
            sorted_pay = payload[self._members, self._order]
            recv_pay = self._transpose(self._bucketize(sorted_pay, 0))
        ov = self.ov_budget > 0
        if ov and payload is not None:
            ov_pay = self._gather_overflow(sorted_pay, 0)
        mains, fallback = [], None
        for i, d in enumerate(held):
            req = requests[i]
            pay = None if payload is None else recv_pay[i].flatten(0, 1)
            if ov and pay is not None:
                pay = torch.cat([pay, ov_pay])
            out = serve(d, req) if payload is None else serve(d, req, pay)
            mains.append(out[:F * cap])
            if ov:
                # the psum: every owner's answers to every member's
                # overflow lanes, summed in member order
                part = out[F * cap:]
                fallback = part if fallback is None else fallback + part
        trailing = tuple(mains[0].shape[1:])
        ov_shape = (F, self.ov_budget) + trailing
        if ov:
            if group is not None:
                fallback = world.ordered_sum(fallback, group, (FEATURE_AXIS,),
                                             shape=ov_shape)
            else:
                collective("psum", (FEATURE_AXIS,), fallback, shape=ov_shape)
        if group is not None:
            # this owner's (F_src, cap, ...) answers back to their
            # requesters: the received (F_owner, cap, ...) are this row's
            back = world.all_to_all(mains[0].reshape((F, cap) + trailing), group,
                                    (FEATURE_AXIS,))[None]
        else:
            # (F_owner, F_src, cap, ...): the answers' all_to_all back
            answers = torch.stack(mains).reshape((F, F, cap) + trailing)
            collective("all_to_all", (FEATURE_AXIS,), answers)
            back = answers.transpose(0, 1)
        main = back[self._members, self._owner_c, self._slot.clamp(0, cap - 1)]
        if ov:
            ov_rows = fallback.reshape(ov_shape)
            if group is not None:
                ov_rows = ov_rows[group.index:group.index + 1]
            rank = self._ov_rank.clamp(0, self.ov_budget - 1)
            mask = self._ov_mask.reshape(self._ov_mask.shape + (1,) * len(trailing))
            main = torch.where(mask, ov_rows[self._members, rank], main)
        inv = torch.empty_like(self._order)
        inv.scatter_(1, self._order, torch.arange(self.length, device=inv.device)
                     .expand_as(self._order))
        out = main[self._members, inv]
        vmask = self._valid.reshape(self._valid.shape + (1,) * len(trailing))
        out = torch.where(vmask, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))
        return out if group is None else out[0]

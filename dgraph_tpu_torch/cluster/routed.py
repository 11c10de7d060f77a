"""Routed read views: transparent foreign-tablet access for the engine.

Port of `dgraph_tpu/cluster/routed.py`. Reference parity: the read half
of `worker/task.go ProcessTaskOverNetwork` — a query touching a
predicate another group owns goes over the wire. The shared dense rank
space lets the routing live BELOW the engine: a routed view looks
exactly like a local Store, but predicate data the local node doesn't
maintain is pulled from the owning group as a whole-tablet snapshot
(cluster/tablet.py) and cached by version. The engine, kernels, and
renderer are untouched — they cannot tell a pulled tablet from a local
one.

Freshness: every node learns each tablet's latest commit_ts from the
mutation broadcast (Alpha.apply_committed), even for predicates it does
not apply. A cached foreign tablet is valid while its version matches;
reads at older timestamps fetch an as-of snapshot without caching.

Where the device caches live. The view is a per-request `RoutedView`.
A local predicate's kernel caches (ELL blocks, their device copies, the
runners, the placed CSRs) live on the view's snapshot, as under an ACL
view (`engine/batch.py:_cache_host`). A pulled tablet's live on the
`Store` the Alpha's tablet cache keeps beside it (`Alpha._tablet_cache`,
one per predicate, version and vocabulary width), so a second request
at the same version builds and places nothing, and evicting the cached
tablet (`api.tablet`) drops its device copies. The reference keys these
caches by the snapshot alone (ROADMAP Queue 3).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import grpc

from dgraph_tpu_torch.store.store import Store
from dgraph_tpu_torch.utils import deadline
from dgraph_tpu_torch.utils.device import DEFAULT_DEVICE
from dgraph_tpu_torch.utils.metrics import METRICS


class _RoutedPreds(dict):
    """preds mapping that faults in foreign tablets on access."""

    def __init__(self, local: dict, alpha, read_ts: int):
        super().__init__(local)
        self.alpha = alpha
        self.read_ts = read_ts
        self.view = None
        # pred → the Store a pulled tablet's kernel caches live on
        self.hosts: dict = {}

    def _fetch(self, pred):
        # budget gate before faulting a whole foreign tablet over the
        # wire (the remaining budget rides the RPC as its gRPC timeout)
        deadline.checkpoint("tablet_fault")
        try:
            got = self.alpha._fetch_tablet(pred, self.read_ts, self.view)
        except grpc.RpcError as e:
            # EVERY replica of the owning group was exhausted (failover
            # + breaker + retries all refused): the refusal contract is
            # ReadUnavailable — retryable, never a raw transport error
            # leaking through the engine to the client
            from dgraph_tpu_torch.server.api import ReadUnavailable
            METRICS.inc("read_unavailable_total",
                        reason="replicas_exhausted")
            raise ReadUnavailable(
                f"tablet {pred!r}: every replica of its owning group "
                f"is unreachable ({e.code() if hasattr(e, 'code') else e}"
                f"); retry") from e
        if got is None:
            return None
        pd, host = got
        super().__setitem__(pred, pd)
        self.hosts[pred] = host
        return pd

    def get(self, pred, default=None):
        present = dict.__contains__(self, pred) or None
        if self.alpha._needs_fetch(pred, self.read_ts, present):
            pd = self._fetch(pred)
            return pd if pd is not None else default
        return super().get(pred, default)

    def __getitem__(self, pred):
        out = self.get(pred)
        if out is None:
            raise KeyError(pred)
        return out

    def __contains__(self, pred):
        return self.get(pred) is not None


class RoutedView(Store):
    """A snapshot with the cluster's foreign tablets routed in (see the
    module doc). Built per request; nothing is copied or placed here."""

    def __init__(self, alpha, store: Store, read_ts: int):
        # Store.__init__ is not run: the view owns no data and registers
        # no cache with the memory governor
        self._base = store
        self._alpha = alpha
        self._read_ts = read_ts
        self.uids = store.uids
        self.schema = store.schema
        self.preds = _RoutedPreds(store.preds, alpha, read_ts)
        self.preds.view = self
        self._empty_rel = store._empty_rel
        # per-snapshot kernel caches key off the underlying immutable
        # store, not this per-request wrapper (engine/batch.py)
        self._ell_host = getattr(store, "_ell_host", store)
        # a filter set over a pulled tablet is not the snapshot's: the
        # view keeps its own memo, and what it places for a predicate
        # that has no host stays here too
        self._filter_sets = OrderedDict()
        self._filter_lock = threading.Lock()
        self._device: dict = {}
        self._vec_tab: dict = {}
        self._vec_dev: dict = {}
        self._placed: set = set()
        self._place_lock = threading.Lock()

    def remote_expand(self, pred, reverse, frontier):
        """A small-frontier hop over a foreign tablet, run on its owner
        (ServeTask), or None when the hop is not eligible."""
        return self._alpha.remote_hop(pred, reverse, frontier,
                                      self._read_ts, self)

    def tablet_host(self, pred):
        """The Store a pulled tablet's kernel caches live on, or None
        when `pred` was not pulled."""
        pd = self.preds.get(pred)
        host = self.preds.hosts.get(pred)
        return host if pd is not None and host is not None \
            and host.preds.get(pred) is pd else None

    def _host(self, pred):
        host = self.tablet_host(pred)
        if host is not None:
            return host
        pd = self.preds.get(pred)
        if pd is not None and self._base.preds.get(pred) is pd:
            return self._base
        return None

    def device_rel(self, pred, reverse=False, device=DEFAULT_DEVICE):
        host = self._host(pred)
        if host is not None:
            return host.device_rel(pred, reverse, device)
        return Store.device_rel(self, pred, reverse, device)

    def vec_tablet(self, pred):
        host = self._host(pred)
        if host is not None:
            return host.vec_tablet(pred)
        return Store.vec_tablet(self, pred)

    def vec_device(self, pred, device=DEFAULT_DEVICE):
        host = self._host(pred)
        if host is not None:
            return host.vec_device(pred, device)
        return Store.vec_device(self, pred, device)


def routed_view(alpha, store: Store, read_ts: int) -> Store:
    """Wrap a local read view so foreign predicates resolve remotely:
    small-frontier hops route per-hop through the owner's ServeTask
    (`remote_expand` — O(frontier+result) bytes), everything else faults
    in the whole tablet through the preds mapping."""
    return RoutedView(alpha, store, read_ts)


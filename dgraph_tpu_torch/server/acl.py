"""Access control lists: users, groups, predicate permissions, login.

Port of `dgraph_tpu/server/acl.py`. Reference parity: `ee/acl`: ACL
state lives IN the graph itself under reserved predicates (`dgraph.xid`,
`dgraph.password`, `dgraph.user.group`, `dgraph.rule.predicate`,
`dgraph.rule.permission`), a `groot` superuser in the `guardians` group
is bootstrapped on first start, login returns a signed access token, and
enforcement hides unreadable predicates from queries and refuses
unwritable mutations.

Permissions are a bitmask per (group, predicate): READ=4, WRITE=2,
MODIFY=1 (the reference's values). Guardians bypass all checks. Tokens
are HMAC-SHA256-signed JSON (userid + expiry), the role the reference's
JWTs play. Passwords hash through the port's `store/types.py`, whose
hashes both packages read, so a directory with ACL users written by one
package logs in through the other.

Enforcement is store-level: an unreadable predicate does not exist in
the user's view (`readable_view`), so every engine path (filters,
expand, recurse, the lane kernels, whole-block programs) inherits the
policy. The view is an `AclView`: a per-request `Store` whose predicate
data for the readable predicates IS its snapshot's (the same objects),
so every device cache lives on the snapshot and is shared with it:

  * the ELL blocks, their device copies, the runners and the tree
    programs (`engine/batch.py:_cache_host` redirects to `_ell_host`);
  * the whole-block programs (`engine/fused.py` keys them by that host);
  * the placed CSRs and embedding stacks (`device_rel`, `vec_tablet`
    and `vec_device` answer from the snapshot; the view registers
    nothing with the memory governor).

A hidden predicate reads as empty, and what the view computes for one
stays on the view. The snapshot's memo of whole-store filter sets is
shared under a key that holds the view's readable set, so `has(p)`
memoized for one permission set never answers for another.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import re
import threading
import time

from dgraph_tpu_torch.store.store import Store
from dgraph_tpu_torch.store.types import check_password, hash_password
from dgraph_tpu_torch.utils.device import DEFAULT_DEVICE

__all__ = ["READ", "WRITE", "MODIFY", "GROOT", "GUARDIANS", "AclError",
           "AclManager", "AclView"]

READ, WRITE, MODIFY = 4, 2, 1
GROOT, GUARDIANS = "groot", "guardians"
ACL_SCHEMA = """
dgraph.xid: string @index(exact) @upsert .
dgraph.password: string .
dgraph.user.group: [uid] @reverse .
dgraph.acl.rule: [uid] .
dgraph.rule.predicate: string .
dgraph.rule.permission: int .
"""
TOKEN_TTL_S = 3600.0


class AclError(PermissionError):
    pass


_USERID_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


def _check_userid(userid: str) -> str:
    """User ids are spliced into DQL lookups: a strict charset is the
    injection guard (reference: xid validation)."""
    if not _USERID_RE.match(userid or ""):
        raise AclError(f"invalid userid {userid!r}")
    return userid


def _hash_password(password: str) -> str:
    return hash_password(password)


def _check_password(password: str, stored: str) -> bool:
    return check_password(password, stored)


class AclManager:
    """Login + enforcement against ACL state stored in the graph."""

    def __init__(self, alpha, secret: str):
        self.alpha = alpha
        self.secret = secret.encode()
        self._perm_cache: tuple[int, dict] | None = None

    # -- bootstrap -----------------------------------------------------------
    def ensure_groot(self, password: str = "password") -> None:
        """First-start bootstrap: groot user in the guardians group
        (reference: ee/acl ResetAcl)."""
        self.alpha.alter(ACL_SCHEMA)
        out = self._query(
            '{ q(func: eq(dgraph.xid, "%s")) { uid } }' % GROOT)
        if out["q"]:
            return
        self.alpha.mutate(set_nquads=f'''
            _:g <dgraph.xid> "{GUARDIANS}" .
            _:u <dgraph.xid> "{GROOT}" .
            _:u <dgraph.password> "{_hash_password(password)}" .
            _:u <dgraph.user.group> _:g .
        ''')

    def _query(self, q: str) -> dict:
        # internal reads bypass enforcement (the manager IS the authority)
        return self.alpha.query(q)

    # -- login / tokens -------------------------------------------------------
    def login(self, userid: str, password: str) -> str:
        userid = _check_userid(userid)
        out = self._query(
            '{ q(func: eq(dgraph.xid, "%s")) { dgraph.password } }'
            % userid)
        rows = [r for r in out["q"] if "dgraph.password" in r]
        if not rows or not _check_password(password,
                                           rows[0]["dgraph.password"]):
            raise AclError("invalid credentials")
        # the wall clock: any Alpha that shares the HMAC secret verifies
        # the expiry, and a monotonic reading means nothing across
        # processes
        doc = json.dumps({"u": userid,
                          "exp": time.time() + TOKEN_TTL_S},
                         separators=(",", ":")).encode()
        sig = hmac.new(self.secret, doc, hashlib.sha256).digest()
        return (base64.urlsafe_b64encode(doc).decode() + "." +
                base64.urlsafe_b64encode(sig).decode())

    def verify(self, token: str | None) -> str:
        if not token:
            raise AclError("no access token")
        try:
            doc_b64, sig_b64 = token.split(".", 1)
            doc = base64.urlsafe_b64decode(doc_b64)
            sig = base64.urlsafe_b64decode(sig_b64)
        except Exception:  # noqa: BLE001 — any decode failure is malformed
            raise AclError("malformed access token") from None
        want = hmac.new(self.secret, doc, hashlib.sha256).digest()
        if not hmac.compare_digest(sig, want):
            raise AclError("bad token signature")
        payload = json.loads(doc)
        if payload["exp"] < time.time():   # see login(): cross-process
            raise AclError("token expired")
        return _check_userid(payload["u"])

    # -- permissions ----------------------------------------------------------
    def perms_for(self, userid: str):
        """(is_guardian, {pred: bitmask}) for a user: the union over
        their groups' rules. Cached per committed version."""
        userid = _check_userid(userid)
        ver = self.alpha.oracle.max_assigned
        if self._perm_cache is not None and self._perm_cache[0] == ver:
            cached = self._perm_cache[1].get(userid)
            if cached is not None:
                return cached
        out = self._query('''
        { q(func: eq(dgraph.xid, "%s")) {
            dgraph.user.group {
              dgraph.xid
              dgraph.acl.rule {
                dgraph.rule.predicate dgraph.rule.permission } } } }'''
                          % userid)
        guardian = False
        perms: dict[str, int] = {}
        for user in out["q"]:
            for grp in user.get("dgraph.user.group", []):
                if grp.get("dgraph.xid") == GUARDIANS:
                    guardian = True
                for rule in grp.get("dgraph.acl.rule", []):
                    p = rule.get("dgraph.rule.predicate")
                    m = rule.get("dgraph.rule.permission", 0)
                    if p:
                        perms[p] = perms.get(p, 0) | int(m)
        result = (guardian, perms)
        cache = self._perm_cache
        if cache is None or cache[0] != ver:
            cache = self._perm_cache = (ver, {})
        cache[1][userid] = result
        return result

    # -- enforcement ----------------------------------------------------------
    def check_alter(self, userid: str) -> None:
        guardian, _ = self.perms_for(userid)
        if not guardian:
            raise AclError(f"{userid!r} is not a guardian: alter denied")

    def check_mutation(self, userid: str, preds) -> None:
        guardian, perms = self.perms_for(userid)
        if guardian:
            return
        for p in preds:
            if p == "dgraph.type":
                continue  # typed nodes are writable by any user (ref)
            if p.startswith("dgraph."):
                raise AclError(f"reserved predicate {p!r}: denied")
            if not perms.get(p, 0) & WRITE:
                raise AclError(f"no write permission on {p!r}")

    def readable_view(self, userid: str, store):
        """Store view hiding unreadable predicates (reference: unauthorized
        predicates are dropped from the query, not errored)."""
        guardian, perms = self.perms_for(userid)
        if guardian:
            return store
        return AclView(store, {p for p, m in perms.items() if m & READ})


class AclView(Store):
    """A snapshot seen through one readable set (see the module doc).
    Built per request, cheap: no array is copied and nothing is placed."""

    def __init__(self, store: Store, allowed):
        # Store.__init__ is not run: the view owns no data and registers
        # no cache with the memory governor
        self._base = store
        self.uids = store.uids
        self.schema = store.schema
        self.preds = _AclPreds(store.preds, frozenset(allowed))
        self._empty_rel = store._empty_rel
        # every kernel cache of a readable predicate lives on the snapshot
        self._ell_host = getattr(store, "_ell_host", store)
        # the filter-set memo's key part: the readable set, sorted
        self._acl_key = ("acl",) + tuple(sorted(self.preds._allowed))
        # what the view computes for a HIDDEN predicate (an empty
        # tablet) stays here, never in the snapshot's caches
        self._device: dict = {}
        self._vec_tab: dict = {}
        self._vec_dev: dict = {}
        self._placed: set = set()
        self._place_lock = threading.Lock()

    def _shared(self, pred: str) -> bool:
        """Does the view read `pred`'s data as the snapshot holds it?"""
        pd = self.preds.get(pred)
        return pd is not None and self._base.preds.get(pred) is pd

    def filter_set_memo(self, key, compute):
        return self._base.filter_set_memo((self._acl_key, key), compute)

    def device_rel(self, pred, reverse=False, device=DEFAULT_DEVICE):
        if self._shared(pred):
            return self._base.device_rel(pred, reverse, device)
        return Store.device_rel(self, pred, reverse, device)

    def tablet_host(self, pred):
        """A pulled tablet's host when the view reads it through a routed
        view (`cluster/routed.py`), else None."""
        pulled = getattr(self._base, "tablet_host", None)
        return pulled(pred) if pulled is not None and self._shared(pred) \
            else None

    def vec_tablet(self, pred):
        if self._shared(pred):
            return self._base.vec_tablet(pred)
        return Store.vec_tablet(self, pred)

    def vec_device(self, pred, device=DEFAULT_DEVICE):
        if self._shared(pred):
            return self._base.vec_device(pred, device)
        return Store.vec_device(self, pred, device)


class _AclPreds(dict):
    def __init__(self, inner, allowed):
        super().__init__()
        self._inner = inner
        self._allowed = allowed

    def _ok(self, pred) -> bool:
        if pred == "dgraph.type":
            return True  # type membership is readable by any user (ref)
        return pred in self._allowed and not str(pred).startswith("dgraph.")

    def get(self, pred, default=None):
        if not self._ok(pred):
            return default
        return self._inner.get(pred, default)

    def __getitem__(self, pred):
        out = self.get(pred)
        if out is None:
            raise KeyError(pred)
        return out

    def __contains__(self, pred):
        return self.get(pred) is not None

    def __iter__(self):
        return (p for p in self._inner if self._ok(p))

    def keys(self):
        return [p for p in self._inner if self._ok(p)]

    def items(self):
        return [(p, v) for p, v in self._inner.items() if self._ok(p)]

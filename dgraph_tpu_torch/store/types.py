"""Scalar value types and the conversion matrix.

Port of `dgraph_tpu/store/types.py`: `Kind`, `NUMPY_DTYPE`, `convert`
(geo values included), `sort_key` and the password hash helpers, with
the same host representation (numpy-columnar int64, float64, object
strings, bool_, datetime64[us], `GeoVal` objects) and the same
`salt$key` scrypt encoding, so a hash written by either package verifies
in the other. float32vector values are ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import base64
import datetime as _dt
import hashlib
import hmac
import os
from enum import Enum

import numpy as np

from dgraph_tpu_torch.store.geo import parse_geo


class Kind(str, Enum):
    UID = "uid"
    INT = "int"
    FLOAT = "float"
    STRING = "string"
    BOOL = "bool"
    DATETIME = "datetime"
    PASSWORD = "password"
    GEO = "geo"
    VECTOR = "float32vector"  # dense f32 embedding (GraphRAG tablets)
    DEFAULT = "default"  # untyped: stored as string, coerced on use


NUMPY_DTYPE = {
    Kind.INT: np.int64,
    Kind.FLOAT: np.float64,
    Kind.STRING: object,
    Kind.BOOL: np.bool_,
    Kind.DATETIME: "datetime64[us]",
    Kind.PASSWORD: object,
    Kind.GEO: object,
    Kind.VECTOR: object,  # object column of 1-D float32 rows
    Kind.DEFAULT: object,
}


def hash_password(password: str) -> str:
    """Salted scrypt hash, encoded "salt$key" (password values store
    hashes, never plaintext)."""
    salt = os.urandom(16)
    dk = hashlib.scrypt(password.encode(), salt=salt, n=2**14, r=8, p=1)
    return base64.b64encode(salt).decode() + "$" + \
        base64.b64encode(dk).decode()


def check_password(password: str, stored: str) -> bool:
    """Constant-time verification against a hash_password() value."""
    try:
        salt_b64, dk_b64 = stored.split("$", 1)
        salt = base64.b64decode(salt_b64)
        dk = hashlib.scrypt(password.encode(), salt=salt,
                            n=2**14, r=8, p=1)
        return hmac.compare_digest(dk, base64.b64decode(dk_b64))
    except Exception:  # noqa: BLE001 — malformed hash = no access
        return False


def parse_datetime(s: str) -> np.datetime64:
    """RFC3339-ish datetime parsing (reference: types.ParseTime)."""
    s = s.strip()
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    try:
        dt = _dt.datetime.fromisoformat(s)
    except ValueError:
        for fmt in ("%Y", "%Y-%m", "%Y-%m-%d"):
            try:
                dt = _dt.datetime.strptime(s, fmt)
                break
            except ValueError:
                continue
        else:
            raise
    if dt.tzinfo is not None:
        dt = dt.astimezone(_dt.timezone.utc).replace(tzinfo=None)
    return np.datetime64(dt, "us")


def convert(value, kind: Kind):
    """Coerce a raw (string or python) value to `kind` — the reference
    conversion matrix: anything → string; string → int/float/bool/
    datetime by parse; int ↔ float; bool → int. Raises ValueError on
    inconvertible pairs."""
    if kind in (Kind.STRING, Kind.DEFAULT, Kind.PASSWORD):
        if isinstance(value, bool):
            return "true" if value else "false"
        return str(value)
    if kind == Kind.INT:
        if isinstance(value, bool):
            return int(value)
        if isinstance(value, (int, np.integer)):
            return int(value)
        if isinstance(value, (float, np.floating)):
            return int(value)
        try:
            return int(str(value), 10)
        except ValueError:
            return int(float(str(value)))  # "3.0" → 3, raises if not numeric
    if kind == Kind.FLOAT:
        if isinstance(value, bool):
            return float(value)
        return float(value) if not isinstance(value, str) else float(value.strip())
    if kind == Kind.BOOL:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float, np.number)):
            return bool(value)
        s = str(value).strip().lower()
        if s in ("true", "1"):
            return True
        if s in ("false", "0", ""):
            return False
        raise ValueError(f"cannot convert {value!r} to bool")
    if kind == Kind.DATETIME:
        if isinstance(value, np.datetime64):
            return value
        if isinstance(value, _dt.datetime):
            return np.datetime64(value, "us")
        return parse_datetime(str(value))
    if kind == Kind.GEO:
        return parse_geo(value)
    if kind == Kind.VECTOR:
        return parse_vector(value)
    raise ValueError(f"cannot convert to {kind}")


def parse_vector(value) -> np.ndarray:
    """Raw value → 1-D float32 vector. Accepts ndarray, list/tuple of
    numbers, or the loader's string literal form `"[0.1, 0.2, ...]"`
    (the `^^<float32vector>` RDF object / JSON string encoding)."""
    if isinstance(value, np.ndarray):
        v = value
    elif isinstance(value, (list, tuple)):
        v = np.asarray(value)
    elif isinstance(value, str):
        s = value.strip()
        if not (s.startswith("[") and s.endswith("]")):
            raise ValueError(f"cannot convert {value!r} to float32vector")
        body = s[1:-1].strip()
        v = np.array([float(p) for p in body.split(",") if p.strip()])
    else:
        raise ValueError(f"cannot convert {value!r} to float32vector")
    v = np.asarray(v, np.float32)
    if v.ndim != 1:
        raise ValueError(
            f"float32vector must be 1-D, got shape {v.shape}")
    return v


def sort_key(value, kind: Kind):
    """Total-order key used by order-by on values (reference: types.Sort)."""
    if kind == Kind.DATETIME:
        return np.datetime64(value, "us").astype("int64")
    return value

"""Encryption-at-rest: AES-GCM over checkpoint files and WAL records.

Port of `dgraph_tpu/store/vault.py`: the same formats (a file or record
sealed by either package opens in the other), crc checks, typed
`StorageCorruption`, the IO fault hook, and AES-GCM through the
`cryptography` package imported only when a key is set. A key set
without that package raises; nothing falls back to plaintext. Every
detected corruption counts in `storage_corruption_total{file_kind=}`
and is a `storage.corruption` event in the flight recorder's ring.

Reference parity: the enterprise encryption-at-rest feature (SURVEY §2.5
`ee/`) — the reference encrypts Badger SSTs and value-log blocks with an
AES key loaded from `--encryption key-file=` at process start. Here the
at-rest units are (a) whole checkpoint files (numpy blocks, facet
sidecars, the manifest) and (b) individual WAL/journal record payloads;
backups inherit both automatically because they are built from the same
two writers.

Design notes:
- One process-global key, loaded once at startup (the reference's model:
  encryption is a property of the deployment, not of a call site).
- AES-256/192/128-GCM via the `cryptography` package; every encryption
  uses a fresh random 96-bit nonce, stored alongside the ciphertext:
  ``MAGIC | nonce(12) | ciphertext+tag``.
- WAL framing CRCs the *ciphertext*, so torn-tail detection and
  truncation (`wal._valid_end`) still work without the key — an operator
  can repair a crashed directory they cannot read, like Badger's
  MANIFEST replay under encryption.
- Plaintext files/records remain readable while a key is set (migration:
  enable the key, next checkpoint rewrites everything encrypted). An
  encrypted file without a key raises `VaultError` with a clear message.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

MAGIC = b"DTE1"   # single-shot sealed blob (file or WAL payload)
MAGIC_C = b"DTEC"  # chunked sealed blob (large checkpoint files)
MAGIC_P = b"DTEP"  # plaintext-escape: raw bytes that happen to start
#                    with one of our magics (a delta-varint uid stream
#                    can emit any byte sequence) are written behind this
#                    prefix so they are never misread as ciphertext
_NONCE = 12
_KEY_SIZES = (16, 24, 32)
# AESGCM's one-shot API caps plaintext at 2^31-1 bytes; blobs above this
# are sealed as independent 1 GiB chunks, each with its own nonce+tag
_CHUNK = 1 << 30
_LEN = struct.Struct("<Q")

_aead = None    # process-global AESGCM, None = encryption off
_strict = False  # refuse plaintext once migration is done


class VaultError(Exception):
    """Missing/incorrect key or tampered ciphertext."""


class StorageCorruption(Exception):
    """A durable file failed its integrity check (crc mismatch, torn
    content, undecodable manifest). Typed and RETRYABLE: on a clustered
    Alpha the load path first tries to heal the tablet from a replica
    (TabletSnapshot), and a refused load names the exact file so the
    operator can repair or restore it — corruption is never served as
    wrong query results."""

    retryable = True

    def __init__(self, path: str, kind: str = "file", detail: str = ""):
        self.path = path
        self.kind = kind
        msg = f"storage corruption in {kind} {path}"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def corruption(path: str, kind: str, detail: str = "") -> StorageCorruption:
    """Build a StorageCorruption — the single construction site every
    detection path (checkpoint load, replay, sidecars) goes through."""
    from dgraph_tpu_torch.utils.metrics import METRICS
    METRICS.inc("storage_corruption_total", file_kind=kind)
    # lazy import: vault sits below the telemetry modules (flightrec
    # writes its bundles through atomic_write)
    from dgraph_tpu_torch.utils import flightrec
    flightrec.emit("storage.corruption", file=path, file_kind=kind,
                   detail=detail[:200])
    return StorageCorruption(path, kind=kind, detail=detail)


# ---- disk-fault injection hook ----
# One process-global write hook: every durable write (atomic file
# writes below + WAL record appends in store/wal.py) passes its final
# bytes through it. A fuzz/test hook may mutate the bytes (bit-flip),
# shorten them (torn write), or raise OSError (ENOSPC) — recorded
# digests are computed from the INTENDED bytes, so an injected fault is
# exactly what the integrity checks must catch. None = zero overhead.
_io_fault = None


def set_io_fault(cb) -> None:
    """Install (or clear, with None) the write-fault hook:
    ``cb(path, data) -> bytes`` may return mutated/truncated bytes or
    raise OSError. Test/fuzz only — never armed in production."""
    global _io_fault
    _io_fault = cb


def io_faulted(path: str, data: bytes) -> bytes:
    if _io_fault is None:
        return data
    out = _io_fault(path, data)
    return data if out is None else out


def set_key(key: bytes | None, strict: bool = False) -> None:
    """Install (or clear, with None) the process-global at-rest key.
    `strict` additionally REJECTS plaintext blobs on read — the
    post-migration posture in which a keyless writer (or an attacker
    swapping in unauthenticated files) cannot inject data."""
    global _aead, _strict
    if key is None:
        _aead = None
        _strict = False
        return
    if len(key) not in _KEY_SIZES:
        raise VaultError(
            f"encryption key must be {_KEY_SIZES} bytes (AES-128/192/256), "
            f"got {len(key)}")
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    _aead = AESGCM(key)
    _strict = bool(strict)


def load_key_file(path: str, strict: bool = False) -> None:
    """Read the raw AES key from `path` (reference: --encryption
    key-file=). A single trailing newline is tolerated — keys are often
    written by shell redirection."""
    with open(path, "rb") as f:
        key = f.read()
    if len(key) - 1 in _KEY_SIZES and key.endswith(b"\n"):
        key = key[:-1]
    set_key(key, strict=strict)


def active() -> bool:
    return _aead is not None


def encrypt(data: bytes, aad: bytes = b"") -> bytes:
    """Seal `data`. `aad` binds context (e.g. a WAL record's ordinal) so
    a sealed blob cannot be replayed at a different position — GCM
    authenticates it without storing it."""
    if _aead is None:
        return data
    if len(data) <= _CHUNK:
        nonce = os.urandom(_NONCE)
        return MAGIC + nonce + _aead.encrypt(nonce, data, aad or None)
    # chunked: each chunk's AAD carries (index, total) on top of the
    # caller context, so chunk reorder, boundary truncation, and
    # same-key cross-splice of a different-length file all fail the tag
    n_chunks = -(-len(data) // _CHUNK)
    parts = [MAGIC_C]
    for ci, off in enumerate(range(0, len(data), _CHUNK)):
        nonce = os.urandom(_NONCE)
        ct = _aead.encrypt(nonce, data[off:off + _CHUNK],
                           aad + b"|chunk:%d/%d" % (ci, n_chunks))
        parts.append(_LEN.pack(len(ct)) + nonce + ct)
    return b"".join(parts)


def is_encrypted(data: bytes) -> bool:
    return data[:len(MAGIC)] in (MAGIC, MAGIC_C)


def decrypt(data: bytes, aad: bytes = b"") -> bytes:
    """Decrypt an encrypted blob; plaintext blobs pass through unchanged
    (pre-encryption files stay loadable after the key is enabled) unless
    strict mode is on. `aad` must match what encrypt() was given."""
    if not is_encrypted(data):
        if _strict and _aead is not None:
            raise VaultError(
                "plaintext data rejected: encryption is in strict mode")
        return data
    if _aead is None:
        raise VaultError(
            "data is encrypted but no key is loaded "
            "(--encryption_key_file)")
    try:
        if data[:len(MAGIC)] == MAGIC:
            nonce = data[len(MAGIC):len(MAGIC) + _NONCE]
            return _aead.decrypt(nonce, data[len(MAGIC) + _NONCE:],
                                 aad or None)
        # first pass counts chunks (the (index, total) AAD needs the
        # total up front to reject boundary truncation)
        n_chunks, off = 0, len(MAGIC_C)
        while off < len(data):
            (clen,) = _LEN.unpack_from(data, off)
            off += _LEN.size + _NONCE + clen
            n_chunks += 1
        if off != len(data):
            raise VaultError("decryption failed: truncated chunk stream")

        def _chunks(indexed_aad: bool) -> bytes:
            out, off, ci = [], len(MAGIC_C), 0
            while off < len(data):
                (clen,) = _LEN.unpack_from(data, off)
                off += _LEN.size
                nonce = data[off:off + _NONCE]
                off += _NONCE
                ca = (aad + b"|chunk:%d/%d" % (ci, n_chunks)
                      if indexed_aad else (aad or None))
                out.append(_aead.decrypt(nonce, data[off:off + clen], ca))
                off += clen
                ci += 1
            return b"".join(out)

        try:
            return _chunks(True)
        except Exception:
            # chunked blobs sealed before (index, total) binding carried
            # no per-chunk AAD; accept them as a migration path
            return _chunks(False)
    except VaultError:
        raise
    except Exception as e:  # InvalidTag/short read — wrong key/tampering
        raise VaultError(f"decryption failed (wrong key or corrupt "
                         f"data): {e!r}") from e


# ---- file IO helpers (checkpoint blocks, sidecars, manifests) ----

def atomic_write(path: str, file_bytes: bytes) -> int:
    """THE durable-file writer: tmp + flush + fsync + os.replace, so a
    kill at any point leaves either the previous file or the whole new
    one — never a torn mix. Returns crc32 of the INTENDED bytes
    (the integrity digest recorded in manifests); the injected-fault
    hook mutates only what lands on disk, so a fault is exactly what
    the digest check later catches."""
    crc = zlib.crc32(file_bytes)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(io_faulted(path, file_bytes))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return crc


def write_bytes(path: str, data: bytes) -> int:
    """Seal + atomically write `data`; returns the on-disk crc32."""
    # escape regardless of key state: content beginning with any magic
    # must survive the unconditional MAGIC_P strip in read_bytes
    if data[:len(MAGIC)] in (MAGIC, MAGIC_C, MAGIC_P):
        data = MAGIC_P + data
    return atomic_write(path, encrypt(data))


def _verify_crc(path: str, raw: bytes, crc: int | None,
                kind: str) -> None:
    if crc is not None and zlib.crc32(raw) != crc:
        raise corruption(path, kind=kind,
                         detail=f"crc mismatch over {len(raw)} bytes")


def file_crc_ok(path: str, crc: int) -> bool:
    """Digest check of a file's raw on-disk bytes without decoding it
    (backup verify / restore-resume re-verification)."""
    try:
        with open(path, "rb") as f:
            return zlib.crc32(f.read()) == crc
    except OSError:
        return False


def read_bytes(path: str, crc: int | None = None,
               kind: str = "file") -> bytes:
    """Read (+ decrypt) a vault file; `crc` (from the manifest) is
    verified against the RAW on-disk bytes first — a failed check
    raises StorageCorruption naming the file."""
    with open(path, "rb") as f:
        raw = f.read()
    _verify_crc(path, raw, crc, kind)
    data = decrypt(raw)
    if data[:len(MAGIC_P)] == MAGIC_P:
        return data[len(MAGIC_P):]
    return data


def save_np(path: str, arr: np.ndarray) -> int:
    """np.save through the vault (serialize to memory, encrypt, write
    atomically). Returns the on-disk crc32. Plaintext bytes are
    identical to a direct np.save of the same array."""
    buf = io.BytesIO()
    np.save(buf, arr)
    if _aead is None:
        return atomic_write(path, buf.getvalue())
    return write_bytes(path, buf.getvalue())


def load_np(path: str, allow_pickle: bool = False,
            crc: int | None = None,
            kind: str = "segment") -> np.ndarray:
    if crc is None:
        # fast path: no digest recorded (pre-v3 snapshot) — keep the
        # zero-copy np.load for plaintext files
        with open(path, "rb") as f:
            head = f.read(len(MAGIC))
            if not is_encrypted(head):
                if _strict and _aead is not None:
                    raise VaultError(f"plaintext file rejected in strict "
                                     f"encryption mode: {path}")
                return np.load(path, allow_pickle=allow_pickle)
            data = head + f.read()
        return np.load(io.BytesIO(decrypt(data)),
                       allow_pickle=allow_pickle)
    with open(path, "rb") as f:
        raw = f.read()
    _verify_crc(path, raw, crc, kind)
    if not is_encrypted(raw):
        if _strict and _aead is not None:
            raise VaultError(f"plaintext file rejected in strict "
                             f"encryption mode: {path}")
        try:
            return np.load(io.BytesIO(raw), allow_pickle=allow_pickle)
        except ValueError as e:
            # crc passed but the block won't decode — a digest recorded
            # over an already-corrupt write; still a typed refusal
            raise corruption(path, kind=kind, detail=str(e)) from e
    return np.load(io.BytesIO(decrypt(raw)), allow_pickle=allow_pickle)

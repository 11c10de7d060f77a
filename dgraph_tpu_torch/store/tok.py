"""Index tokenizers behind `eq` and the term functions.

Port of `dgraph_tpu/store/tok.py` as far as `eq` on an `@index(exact)`,
`hash` or `term` predicate and `anyofterms`/`allofterms` need it. Every tokenizer name the reference
accepts stays registered, so schema validation accepts the same text;
`fulltext`, `trigram` and `geo` raise until the functions that use them
are ported (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import re
import unicodedata

_TERM_SPLIT = re.compile(r"[^\w]+", re.UNICODE)


def _fold(s: str) -> str:
    """Lowercase + strip diacritics (unicode normalisation)."""
    s = unicodedata.normalize("NFKD", s.lower())
    return "".join(c for c in s if not unicodedata.combining(c))


def exact_tokens(value) -> list[str]:
    """`exact` index: the value itself, one token."""
    return [str(value)]


def hash_tokens(value) -> list[str]:
    """`hash` index: same as exact for eq purposes."""
    return [str(value)]


def term_tokens(value) -> list[str]:
    """`term` index: folded alphanumeric words, deduped."""
    return sorted({w for w in _TERM_SPLIT.split(_fold(str(value))) if w})


def _not_ported(name: str):
    def tokens(value) -> list[str]:
        raise NotImplementedError(
            f"the {name!r} tokenizer is not ported yet (ROADMAP Queue 1 "
            f"item 4: store/tok.py)")
    return tokens


TOKENIZERS = {
    "exact": exact_tokens,
    "hash": hash_tokens,
    "term": term_tokens,
    "fulltext": _not_ported("fulltext"),
    "trigram": _not_ported("trigram"),
    # numeric/datetime/bool "indexes" are satisfied by sorted value
    # columns; registered as identity so schema validation accepts them
    "int": exact_tokens,
    "float": exact_tokens,
    "bool": exact_tokens,
    "datetime": exact_tokens,
    "year": exact_tokens,
    "month": exact_tokens,
    "day": exact_tokens,
    "hour": exact_tokens,
    "geo": _not_ported("geo"),
}


def tokens_for(tokenizer: str, value) -> list[str]:
    try:
        return TOKENIZERS[tokenizer](value)
    except KeyError:
        raise ValueError(f"unknown tokenizer {tokenizer!r}") from None

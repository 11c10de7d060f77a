"""Index tokenizers behind `eq`, the term and text functions and geo.

Port of `dgraph_tpu/store/tok.py`, whole: exact, hash, term, fulltext
(the bleve English stopword list, possessives stripped, Porter-stemmed),
trigram and geohash cell tokens keying the inverted indexes (token →
sorted rank posting list). Numeric/datetime comparisons do not use
tokens: the store keeps sorted value columns and answers ranges with
numpy searchsorted.
"""

from __future__ import annotations

import re
import unicodedata

from dgraph_tpu_torch.store.geo import parse_geo, tokens_for_geo

# The snowball/bleve English stopword list (the reference's fulltext
# tokenizer uses bleve's english analyzer; this is its stopword set).
STOPWORDS = frozenset("""
a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for
from further had hadn't has hasn't have haven't having he he'd he'll he's
her here here's hers herself him himself his how how's i i'd i'll i'm
i've if in into is isn't it it's its itself let's me more most mustn't my
myself no nor not of off on once only or other ought our ours ourselves
out over own same shan't she she'd she'll she's should shouldn't so some
such than that that's the their theirs them themselves then there there's
these they they'd they'll they're they've this those through to too under
until up very was wasn't we we'd we'll we're we've were weren't what
what's when when's where where's which while who who's whom why why's
with won't would wouldn't you you'd you'll you're you've your yours
yourself yourselves
""".split())

_TERM_SPLIT = re.compile(r"[^\w]+", re.UNICODE)
# fulltext keeps intra-word apostrophes through the split so the
# contraction stopwords ("isn't", "you've") can actually match; the
# possessive tail is stripped after filtering ("dog's" → "dog"), the
# bleve analyzer's behavior
_FT_SPLIT = re.compile(r"[^\w']+", re.UNICODE)


def _fold(s: str) -> str:
    """Lowercase + strip diacritics (unicode normalisation)."""
    s = unicodedata.normalize("NFKD", s.lower())
    return "".join(c for c in s if not unicodedata.combining(c))


# -- Porter stemmer ----------------------------------------------------------
# The reference's fulltext analyzer stems with bleve's porter filter;
# this is the classic Porter (1980) algorithm, implemented from the
# published description. Matching symmetry still holds (query and data
# pass through the same function); quality now matches the reference's
# (conflates relational/relate, conditional/condition, etc.).

def _is_cons(w: str, i: int) -> bool:
    c = w[i]
    if c in "aeiou":
        return False
    if c == "y":
        return i == 0 or not _is_cons(w, i - 1)
    return True


def _measure(w: str) -> int:
    """m in [C](VC)^m[V] — the number of vowel→consonant transitions."""
    m, i, n = 0, 0, len(w)
    while i < n and _is_cons(w, i):
        i += 1
    while i < n:
        while i < n and not _is_cons(w, i):
            i += 1
        if i >= n:
            break
        m += 1
        while i < n and _is_cons(w, i):
            i += 1
    return m


def _has_vowel(w: str) -> bool:
    return any(not _is_cons(w, i) for i in range(len(w)))


def _ends_cvc(w: str) -> bool:
    return (len(w) >= 3 and _is_cons(w, len(w) - 3)
            and not _is_cons(w, len(w) - 2) and _is_cons(w, len(w) - 1)
            and w[-1] not in "wxy")


def _ends_double_cons(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1)


_STEP2 = (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
          ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
          ("alli", "al"), ("entli", "ent"), ("eli", "e"),
          ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
          ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
          ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
          ("iviti", "ive"), ("biliti", "ble"), ("logi", "log"))
_STEP3 = (("icate", "ic"), ("ative", ""), ("alize", "al"),
          ("iciti", "ic"), ("ical", "ic"), ("ful", ""), ("ness", ""))
_STEP4 = ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
          "ement", "ment", "ent", "ion", "ou", "ism", "ate", "iti",
          "ous", "ive", "ize")


def _stem(w: str) -> str:
    if len(w) <= 2:
        return w
    # step 1a: plurals
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]
    # step 1b: -eed/-ed/-ing
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        stem = None
        if w.endswith("ed") and _has_vowel(w[:-2]):
            stem = w[:-2]
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            stem = w[:-3]
        if stem is not None:
            w = stem
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and w[-1] not in "lsz":
                w = w[:-1]
            elif _measure(w) == 1 and _ends_cvc(w):
                w += "e"
    # step 1c: y → i after a vowel
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2: double suffixes (m > 0)
    for suf, rep in _STEP2:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 3: -ic-, -full, -ness etc. (m > 0)
    for suf, rep in _STEP3:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 4: bare suffixes (m > 1)
    for suf in _STEP4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1 and (
                    suf != "ion" or (stem and stem[-1] in "st")):
                w = stem
            break
    # step 5a: trailing e
    if w.endswith("e"):
        m = _measure(w[:-1])
        if m > 1 or (m == 1 and not _ends_cvc(w[:-1])):
            w = w[:-1]
    # step 5b: -ll → -l (m > 1)
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


def exact_tokens(value) -> list[str]:
    """`exact` index: the value itself, one token."""
    return [str(value)]


def hash_tokens(value) -> list[str]:
    """`hash` index: same as exact for eq purposes (we key dicts by the
    string itself; a real hash adds nothing host-side)."""
    return [str(value)]


def term_tokens(value) -> list[str]:
    """`term` index: folded alphanumeric words, deduped."""
    return sorted({w for w in _TERM_SPLIT.split(_fold(str(value))) if w})


def fulltext_tokens(value) -> list[str]:
    """`fulltext` index: word tokens (contractions intact) minus the
    snowball stopword list, possessives stripped, Porter-stemmed."""
    out = set()
    for w in _FT_SPLIT.split(_fold(str(value))):
        w = w.strip("'")
        if not w or w in STOPWORDS:
            continue
        if w.endswith("'s"):
            w = w[:-2]
        w = w.replace("'", "")
        if w:
            out.add(_stem(w))
    return sorted(out)


def trigram_tokens(value) -> list[str]:
    """`trigram` index (regexp support): all 3-grams of the raw string."""
    s = str(value)
    return sorted({s[i:i + 3] for i in range(len(s) - 2)}) if len(s) >= 3 else []


def geo_tokens(value) -> list[str]:
    """Geohash cell tokens at every ladder precision (reference: the S2
    cell tokenizer; store/geo.py)."""
    return tokens_for_geo(parse_geo(value))


TOKENIZERS = {
    "exact": exact_tokens,
    "hash": hash_tokens,
    "term": term_tokens,
    "fulltext": fulltext_tokens,
    "trigram": trigram_tokens,
    # numeric/datetime/bool "indexes" are satisfied by sorted value columns;
    # registered as identity so schema validation accepts them.
    "int": exact_tokens,
    "float": exact_tokens,
    "bool": exact_tokens,
    "datetime": exact_tokens,
    "year": exact_tokens,
    "month": exact_tokens,
    "day": exact_tokens,
    "hour": exact_tokens,
    "geo": geo_tokens,
}


def tokens_for(tokenizer: str, value) -> list[str]:
    try:
        return TOKENIZERS[tokenizer](value)
    except KeyError:
        raise ValueError(f"unknown tokenizer {tokenizer!r}") from None

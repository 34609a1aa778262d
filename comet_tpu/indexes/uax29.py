"""UAX#29 word segmentation (Unicode TR29 word-boundary rules).

The reference tokenizes with ``github.com/clipperhouse/uax29/v2/words``
(/root/reference/bm25_index.go:67,159-166): ``words.FromString`` yields
EVERY segment of the text — letters/number clusters, but also punctuation
and whitespace runs — and the BM25 index stores all of them (doc lengths,
postings, and ``docTokens`` for more-like-this all include them). Score
parity with the reference therefore requires the same segmentation, not a
``\\w+`` approximation (which splits "don't", "1,000.5" and "example.com",
and never emits whitespace segments).

Two implementations, differentially tested against each other
(tests/test_uax29.py):

- ``segment_slow``: a direct, rule-by-rule transcription of TR29's WB1-WB999
  (the executable spec; also the arbiter when the fast path is in doubt).
- ``segment``: a single compiled ``re`` pattern whose alternatives encode
  the same grammar (CR+LF, newline, WSegSpace runs, the letter/number/
  katakana/ExtendNumLet word cluster with mid-letter links, regional-
  indicator pairs, then any-char), running at C speed for the ingest path.

Word-break properties come from the committed code-point tables in
``uax29_tables`` (generated from the ``regex`` package's Unicode database by
scripts/gen_uax29_tables.py), so only the standard library is needed here.
"""

from __future__ import annotations

import bisect
import re
import unicodedata

from comet_tpu.indexes.uax29_tables import EXTENDED_PICTOGRAPHIC, WORD_BREAK

# -- word-break property lookup (slow path) ---------------------------------

# the classes are disjoint by spec, so one sorted range list serves them all
_RANGES = sorted(
    (lo, hi, name) for name, rs in WORD_BREAK.items() for lo, hi in rs
)
_RANGE_LO = [r[0] for r in _RANGES]
_EP_LO = [lo for lo, _ in EXTENDED_PICTOGRAPHIC]


def _in_ranges(cp: int, los: list[int], ranges) -> int:
    """Index of the range holding code point `cp`, or -1."""
    i = bisect.bisect_right(los, cp) - 1
    return i if i >= 0 and cp <= ranges[i][1] else -1


def _is_ext_pict(ch: str) -> bool:
    return _in_ranges(ord(ch), _EP_LO, EXTENDED_PICTOGRAPHIC) >= 0


_prop_cache: dict[str, str] = {}


def _wb_prop(ch: str) -> str:
    p = _prop_cache.get(ch)
    if p is None:
        i = _in_ranges(ord(ch), _RANGE_LO, _RANGES)
        p = _RANGES[i][2] if i >= 0 else "Other"
        _prop_cache[ch] = p
    return p


_AH = ("ALetter", "Hebrew_Letter")  # AHLetter
_MIDNUMLETQ = ("MidNumLet", "Single_Quote")
_EFZ = ("Extend", "Format", "ZWJ")
_NL = ("Newline", "CR", "LF")


def segment_slow(text: str) -> list[str]:
    """Reference implementation: evaluate WB1-WB999 at every position."""
    n = len(text)
    if n == 0:
        return []
    props = [_wb_prop(c) for c in text]
    ext_pict = [_is_ext_pict(c) for c in text]

    def prev_base(i: int) -> int:
        """Largest j < i with a non-Extend/Format/ZWJ property, or -1."""
        j = i - 1
        while j >= 0 and props[j] in _EFZ:
            j -= 1
        return j

    def next_base(i: int) -> int:
        """Smallest j > i with a non-Extend/Format/ZWJ property, or n."""
        j = i + 1
        while j < n and props[j] in _EFZ:
            j += 1
        return j

    def is_boundary(i: int) -> bool:
        pl, pr = props[i - 1], props[i]
        # WB3: CR x LF
        if pl == "CR" and pr == "LF":
            return False
        # WB3a / WB3b: break around newlines
        if pl in _NL:
            return True
        if pr in _NL:
            return True
        # WB3c: ZWJ x Extended_Pictographic (literal chars)
        if text[i - 1] == "\u200d" and ext_pict[i]:
            return False
        # WB3d: WSegSpace x WSegSpace (literal adjacency)
        if pl == "WSegSpace" and pr == "WSegSpace":
            return False
        # WB4: X (Extend|Format|ZWJ)* -> X — never break before EFZ
        if pr in _EFZ:
            return False
        # fold the left context per WB4
        j1 = prev_base(i)
        if j1 < 0:
            return True  # only EFZ before us: WB999
        p1 = props[j1]
        j0 = prev_base(j1)
        p0 = props[j0] if j0 >= 0 else None
        k = next_base(i)
        r2 = props[k] if k < n else None

        if p1 in _AH and pr in _AH:  # WB5
            return False
        if p1 in _AH and (pr == "MidLetter" or pr in _MIDNUMLETQ) and r2 in _AH:  # WB6
            return False
        if (p0 in _AH) and (p1 == "MidLetter" or p1 in _MIDNUMLETQ) and pr in _AH:  # WB7
            return False
        if p1 == "Hebrew_Letter" and pr == "Single_Quote":  # WB7a
            return False
        if p1 == "Hebrew_Letter" and pr == "Double_Quote" and r2 == "Hebrew_Letter":  # WB7b
            return False
        if p0 == "Hebrew_Letter" and p1 == "Double_Quote" and pr == "Hebrew_Letter":  # WB7c
            return False
        if p1 == "Numeric" and pr == "Numeric":  # WB8
            return False
        if p1 in _AH and pr == "Numeric":  # WB9
            return False
        if p1 == "Numeric" and pr in _AH:  # WB10
            return False
        if p0 == "Numeric" and (p1 == "MidNum" or p1 in _MIDNUMLETQ) and pr == "Numeric":  # WB11
            return False
        if p1 == "Numeric" and (pr == "MidNum" or pr in _MIDNUMLETQ) and r2 == "Numeric":  # WB12
            return False
        if p1 == "Katakana" and pr == "Katakana":  # WB13
            return False
        if p1 in ("ALetter", "Hebrew_Letter", "Numeric", "Katakana", "ExtendNumLet") and pr == "ExtendNumLet":  # WB13a
            return False
        if p1 == "ExtendNumLet" and pr in ("ALetter", "Hebrew_Letter", "Numeric", "Katakana"):  # WB13b
            return False
        if p1 == "Regional_Indicator" and pr == "Regional_Indicator":  # WB15/16
            # join only if the number of preceding consecutive RIs is odd
            count = 0
            j = j1
            while j >= 0 and props[j] == "Regional_Indicator":
                count += 1
                j = prev_base(j)
            if count % 2 == 1:
                return False
        return True  # WB999

    out: list[str] = []
    start = 0
    for i in range(1, n):
        if is_boundary(i):
            out.append(text[start:i])
            start = i
    out.append(text[start:])
    return out


# -- fast path: the same grammar as one compiled pattern ---------------------

def _cls(*names: str) -> str:
    """A ``re`` character class over the code points of the named
    Word_Break classes ("ExtPict" = Extended_Pictographic)."""
    parts = []
    for name in names:
        rs = EXTENDED_PICTOGRAPHIC if name == "ExtPict" else WORD_BREAK[name]
        for lo, hi in rs:
            parts.append(
                f"\\U{lo:08x}" if lo == hi else f"\\U{lo:08x}-\\U{hi:08x}"
            )
    return "[" + "".join(parts) + "]"


def _build_pattern() -> "re.Pattern":
    CR = r"\r"
    LF = r"\n"
    NLCLS = "[\\r\\n\\x0b\\x0c\\x85\\u2028\\u2029]"
    EFZ = _cls("Extend", "Format", "ZWJ")
    # WB4 absorption after every char
    E = rf"{EFZ}*+"
    # WB3c: a literal trailing ZWJ pulls in a following Extended_Pictographic
    # (which may itself chain ZWJ+ExtPict). The pictograph folds as Other, so
    # no word rule can continue past it — the absorption is TERMINAL and is
    # appended once at the end of each token alternative, not inside E.
    T = rf"(?:(?<=\u200d){_cls('ExtPict')}{EFZ}*+)*+"
    WS = _cls("WSegSpace")
    AL = _cls("ALetter", "Hebrew_Letter")
    HL = _cls("Hebrew_Letter")
    NU = _cls("Numeric")
    KA = _cls("Katakana")
    EXNL = _cls("ExtendNumLet")
    LMID = _cls("MidLetter", "MidNumLet", "Single_Quote")
    NMID = _cls("MidNum", "MidNumLet", "Single_Quote")
    DQ = _cls("Double_Quote")
    RI = _cls("Regional_Indicator")

    # WB7b/c (HL " HL): the Hebrew letter itself carries the link, since
    # ``re`` has no variable-width lookbehind to test the folded left
    # context at the quote
    Lx = rf"(?:{HL}{E}(?:{DQ}{E}(?={HL}))?|{AL}{E})"
    # links between AHLetters: WB6/7 (MidLetter|MidNumLetQ)
    Lrun = rf"{Lx}(?:(?:{LMID}{E})?{Lx})*"
    Nx = rf"{NU}{E}"
    Nrun = rf"{Nx}(?:(?:{NMID}{E})?{Nx})*"
    LN = rf"(?:{Lrun}|{Nrun})+"  # WB9/WB10: letters and digits adjoin freely
    KArun = rf"(?:{KA}{E})+"
    EXrun = rf"(?:{EXNL}{E})+"
    Block = rf"(?:{LN}|{KArun})"
    # WB7a (a single quote after a Hebrew letter) is TERMINAL and needs the
    # folded left context: segment() attaches it after matching
    Word = rf"(?:(?:{EXrun})?{Block}(?:{EXrun}{Block})*(?:{EXrun})?|{EXrun})"
    RIpair = rf"{RI}{E}{RI}{E}|{RI}{E}"
    Any = rf".{E}"

    return re.compile(
        rf"{CR}{LF}|{NLCLS}|(?:{WS}+{E}|{Word}|{RIpair}|{Any}){T}",
        re.DOTALL,
    )


_PATTERN = _build_pattern()
_EFZ_TAIL = re.compile(_cls("Extend", "Format", "ZWJ") + "*$")


def _attach_hebrew_quotes(tokens: list[str]) -> list[str]:
    """WB7a: Hebrew_Letter x Single_Quote. A word whose last letter (past
    any Extend/Format/ZWJ) is Hebrew keeps the quote token that follows it;
    nothing continues past that quote, so the whole token joins."""
    out: list[str] = []
    for tok in tokens:
        if out and tok[0] == "'":
            prev = out[-1]
            base = prev[: _EFZ_TAIL.search(prev).start()]
            if base and _wb_prop(base[-1]) == "Hebrew_Letter":
                out[-1] = prev + tok
                continue
        out.append(tok)
    return out


def _build_ascii_pattern() -> "re.Pattern":
    """The same grammar restricted to ASCII (no Extend/Format/ZWJ, no
    Hebrew/Katakana/Regional_Indicator exist below U+0080), compiled from
    plain character classes — many times faster than the full-Unicode form.
    ASCII WB classes (exhaustively enumerated in tests/test_uax29.py):
    ALetter=[A-Za-z] Numeric=[0-9] ExtendNumLet=[_] MidLetter=[:]
    MidNumLet=[.] MidNum=[,;] Single_Quote=['] WSegSpace=[ ]
    Newline=[\\x0b\\x0c] CR LF; everything else Other."""
    Lrun = r"[A-Za-z]+(?:[:.'][A-Za-z]+)*"
    Nrun = r"[0-9]+(?:[.,;'][0-9]+)*"
    LN = rf"(?:{Lrun}|{Nrun})+"
    Word = rf"(?:_*{LN}(?:_+{LN})*_*|_+)"
    return re.compile(rf"\r\n|[\r\n\x0b\x0c]| +|{Word}|.", re.DOTALL)


_ASCII_PATTERN = _build_ascii_pattern()


def segment(text: str) -> list[str]:
    """Partition ``text`` into UAX#29 word segments (all of them, including
    whitespace and punctuation — ``words.FromString`` semantics)."""
    if not text:
        return []
    if text.isascii():
        return _ASCII_PATTERN.findall(text)
    return _attach_hebrew_quotes(_PATTERN.findall(text))


def wordlike(tokens: list[str]) -> list[str]:
    """Optional filter: keep only segments containing a letter or digit
    (NOT what the reference does — it indexes every segment)."""
    return [
        t for t in tokens
        if any(unicodedata.category(c)[0] in "LN" for c in t)
    ]

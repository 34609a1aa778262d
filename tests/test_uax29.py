"""UAX#29 word segmentation tests.

Curated cases are recorded expectations of TR29 word-boundary behavior —
the same rules the reference's tokenizer library implements
(github.com/clipperhouse/uax29/v2/words, /root/reference/bm25_index.go:159-166):
contractions, hyphens, numerics, domains, Hebrew quotes, Katakana vs Han,
emoji ZWJ sequences, regional-indicator flag pairs, newline classes.

The fast compiled-regex partition (`segment`) is differentially fuzzed
against the rule-by-rule transcription (`segment_slow`) on ASCII and
Unicode alphabets — two independent implementations of the spec must agree.
"""

import random
import string

import pytest

from comet_tpu.indexes.uax29 import segment, segment_slow, wordlike


CASES = {
    # basics: every segment is yielded, including whitespace and punctuation
    "Hello, world!": ["Hello", ",", " ", "world", "!"],
    "the quick-brown fox!": ["the", " ", "quick", "-", "brown", " ", "fox", "!"],
    # WB6/WB7: MidLetter & MidNumLetQ keep contractions and domains together
    "don't stop": ["don't", " ", "stop"],
    "can't won't o'clock": ["can't", " ", "won't", " ", "o'clock"],
    "example.com": ["example.com"],
    "user@host.org": ["user", "@", "host.org"],
    "a:b a.b a..b": ["a:b", " ", "a.b", " ", "a", ".", ".", "b"],
    # WB8-WB12: numerics with MidNum/MidNumLet links
    "1,000.50": ["1,000.50"],
    "3.14 v2.0": ["3.14", " ", "v2.0"],
    "1a.2": ["1a", ".", "2"],
    # WB13a/b: ExtendNumLet joins
    "__init__": ["__init__"],
    "foo_bar 1_000": ["foo_bar", " ", "1_000"],
    # WB13 Katakana chains; Han and Hiragana break per character (WB999)
    "カタカナ": ["カタカナ"],
    "漢字": ["漢", "字"],
    "ひらがな": ["ひ", "ら", "が", "な"],
    # WB7a/b/c Hebrew quotes
    'אבג"דה': ['אבג"דה'],
    "אב'": ["אב'"],
    # WB3c ZWJ emoji sequences stay single segments
    "👩‍👩‍👧‍👦": ["👩‍👩‍👧‍👦"],
    # WB15/16: regional indicators pair up; odd one stands alone
    "🇺🇸🇫🇷🇩": ["🇺🇸", "🇫🇷", "🇩"],
    # WB3/3a/3b newlines
    "a\r\nb\nc": ["a", "\r\n", "b", "\n", "c"],
    # WB3d whitespace runs are single segments
    "  two  spaces  ": ["  ", "two", "  ", "spaces", "  "],
    # mixed letters+digits adjoin freely (WB9/WB10)
    "abc123def": ["abc123def"],
}


@pytest.mark.parametrize("text", list(CASES))
def test_curated(text):
    assert segment(text) == CASES[text]
    assert segment_slow(text) == CASES[text]


def test_partition_property():
    """Segments always reassemble to the original text."""
    for text in CASES:
        assert "".join(segment(text)) == text


def test_empty():
    assert segment("") == []
    assert segment_slow("") == []


def test_wordlike_filter():
    toks = segment("Hello, world! 42")
    assert wordlike(toks) == ["Hello", "world", "42"]


def test_differential_ascii_fuzz():
    rng = random.Random(1234)
    for _ in range(400):
        s = "".join(rng.choices(string.printable, k=rng.randint(0, 80)))
        assert segment(s) == segment_slow(s), repr(s)


def test_differential_unicode_fuzz():
    rng = random.Random(99)
    alphabet = (
        string.ascii_letters
        + string.digits
        + " .,;:'\"-_!?\r\n"
        + "àéîöüßñ"
        + "אבגדה"
        + "カタカナ"
        + "漢字中文"
        + "ひらが"
        + "👍😀🐶"
        + "‍́­"  # ZWJ, combining acute (Extend), soft hyphen (Format)
        + "🇺🇸"
    )
    for _ in range(400):
        s = "".join(rng.choices(alphabet, k=rng.randint(0, 40)))
        assert segment(s) == segment_slow(s), repr(s)


def test_ascii_path_matches_general_path():
    """text.isascii() routes to the specialized pattern; both patterns must
    implement the same grammar."""
    from comet_tpu.indexes.uax29 import _PATTERN

    rng = random.Random(7)
    for _ in range(300):
        s = "".join(rng.choices(string.printable, k=rng.randint(0, 80)))
        assert segment(s) == _PATTERN.findall(s), repr(s)


def test_tables_match_regex_properties():
    """The committed code-point tables equal the `regex` package's
    Word_Break / Extended_Pictographic properties (checked where `regex`
    is installed; the library itself never imports it)."""
    import importlib.util
    import os

    pytest.importorskip("regex")
    from comet_tpu.indexes import uax29_tables

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scripts", "gen_uax29_tables.py",
    )
    spec = importlib.util.spec_from_file_location("gen_uax29_tables", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    wb, ext_pict = gen.all_tables()
    assert wb == uax29_tables.WORD_BREAK
    assert ext_pict == uax29_tables.EXTENDED_PICTOGRAPHIC


def test_import_without_regex_package():
    """`import comet_tpu` and BM25 segmentation work where `regex` is not
    installed."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys; sys.modules['regex'] = None\n"
        "import comet_tpu\n"
        "from comet_tpu.indexes.uax29 import segment\n"
        "print(segment(\"don't \\u05d0\\u05d1'\"))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(["don't", " ", "אב'"])


def test_differential_hebrew_quote_fuzz():
    """WB7a/b/c (Hebrew letters with single/double quotes, with and without
    combining marks in between) — the fast path attaches the terminal
    single quote after matching, so fuzz exactly that neighbourhood."""
    rng = random.Random(2024)
    alphabet = "אבג'\"ְ́­‍ a1.,_カ"
    for _ in range(3000):
        s = "".join(rng.choices(alphabet, k=rng.randint(0, 24)))
        assert segment(s) == segment_slow(s), repr(s)


def test_wordlike_unicode_letters_and_digits():
    toks = segment("Grüße, ١٢٣ — 東京!")
    assert wordlike(toks) == ["Grüße", "١٢٣", "東", "京"]

"""Generate comet_tpu/indexes/uax29_tables.py from the `regex` package.

The word segmenter (comet_tpu/indexes/uax29.py) needs two Unicode
properties that the standard library does not expose: Word_Break and
Extended_Pictographic. This script reads them once from the `regex`
package's Unicode database and writes them out as code-point ranges, so the
library itself runs on the standard `re` module alone.

Run by hand where `regex` is installed, then commit the output:

    python scripts/gen_uax29_tables.py

tests/test_uax29.py checks the committed tables against `regex` whenever
that package is importable.
"""

from __future__ import annotations

import pathlib

# the Word_Break values the segmenter distinguishes; every other code point
# is "Other"
WB_CLASSES = (
    "CR", "LF", "Newline", "Extend", "ZWJ", "Regional_Indicator", "Format",
    "Katakana", "Hebrew_Letter", "ALetter", "Single_Quote", "Double_Quote",
    "MidNumLet", "MidLetter", "MidNum", "Numeric", "ExtendNumLet",
    "WSegSpace",
)

OUT = (
    pathlib.Path(__file__).resolve().parent.parent
    / "comet_tpu" / "indexes" / "uax29_tables.py"
)


def property_ranges(prop: str) -> tuple[tuple[int, int], ...]:
    """Inclusive (lo, hi) code-point ranges where `regex` matches \\p{prop}."""
    import regex

    every = "".join(map(chr, range(0x110000)))
    return tuple(
        (m.start(), m.end() - 1)
        for m in regex.finditer(rf"\p{{{prop}}}+", every)
    )


def all_tables() -> tuple[dict[str, tuple[tuple[int, int], ...]], tuple]:
    wb = {name: property_ranges(f"Word_Break={name}") for name in WB_CLASSES}
    return wb, property_ranges("Extended_Pictographic")


def _fmt(ranges, indent: str) -> str:
    """A tuple literal of ranges, wrapped at 79 columns under `indent`."""
    items = [f"(0x{lo:X}, 0x{hi:X})," for lo, hi in ranges]
    lines, cur = [], indent + "    "
    for it in items:
        if len(cur) + len(it) + 1 > 79:
            lines.append(cur.rstrip())
            cur = indent + "    "
        cur += it + " "
    lines.append(cur.rstrip())
    return "(\n" + "\n".join(lines) + "\n" + indent + ")"


def render() -> str:
    import regex

    wb, ext_pict = all_tables()
    out = [
        '"""Unicode word-break tables for comet_tpu/indexes/uax29.py.',
        "",
        "GENERATED by scripts/gen_uax29_tables.py from the `regex` package",
        f"({regex.__version__}); do not edit by hand. Each entry is a tuple of",
        'inclusive (first, last) code-point ranges."""',
        "",
        "WORD_BREAK = {",
    ]
    for name, ranges in wb.items():
        out.append(f'    "{name}": {_fmt(ranges, "    ")},')
    out.append("}")
    out.append("")
    out.append(f"EXTENDED_PICTOGRAPHIC = {_fmt(ext_pict, '')}")
    return "\n".join(out) + "\n"


if __name__ == "__main__":
    OUT.write_text(render())
    print(f"wrote {OUT}")

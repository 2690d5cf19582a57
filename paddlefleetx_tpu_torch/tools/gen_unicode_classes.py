"""Write the code-point table of the GPT pre-tokenizer's character classes.

    python -m paddlefleetx_tpu_torch.tools.gen_unicode_classes [--check]

The GPT-2 word pattern (JAX ``data/tokenizers/gpt_tokenizer.py:20``) uses
``\\p{L}``, ``\\p{N}`` and ``\\s`` of the third-party ``regex`` module.
Python's ``re`` has no ``\\p{...}``, and ``unicodedata`` disagrees with
``regex`` on both the letters (its Unicode version is older) and the
spaces (``regex``'s ``\\s`` leaves out U+001C-U+001F).  So the port keeps
the classes as inclusive code-point ranges derived from ``regex`` itself,
in ``data/tokenizers/unicode_classes.py``, and builds its pattern with
``re`` from them.  This script re-derives that file; it needs ``regex``,
which the port itself never imports.  ``--check`` compares the derived
ranges with the committed file instead and exits 1 when they differ.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Tuple

TARGET = Path(__file__).resolve().parents[1] / "data" / "tokenizers" / "unicode_classes.py"
CLASSES = (("LETTER", r"\p{L}+"), ("NUMBER", r"\p{N}+"), ("SPACE", r"\s+"))


def derive() -> Tuple[Dict[str, List[Tuple[int, int]]], str]:
    """The inclusive ranges of every class over all of U+0000-U+10FFFF, and
    the ``regex`` version they came from."""
    import regex

    text = "".join(chr(c) for c in range(0x110000))
    table = {name: [(m.start(), m.end() - 1) for m in regex.finditer(pat, text)]
             for name, pat in CLASSES}
    return table, regex.__version__


def render(table: Dict[str, List[Tuple[int, int]]], version: str) -> str:
    lines = [
        '"""Code-point ranges of the GPT pre-tokenizer\'s character classes.',
        "",
        "Generated by ``python -m paddlefleetx_tpu_torch.tools.gen_unicode_classes``",
        f"from the ``regex`` module {version}: ``LETTER`` is ``\\\\p{{L}}``, ``NUMBER``",
        "``\\\\p{N}`` and ``SPACE`` ``\\\\s``, each a tuple of inclusive (first, last)",
        'code points.  Do not edit by hand."""',
        "",
    ]
    for name, _ in CLASSES:
        lines.append(f"{name} = (")
        ranges = table[name]
        for i in range(0, len(ranges), 4):
            lines.append("    " + " ".join(f"(0x{a:04X}, 0x{b:04X})," for a, b in ranges[i:i + 4]))
        lines.append(")")
        lines.append("")
    return "\n".join(lines)


def committed() -> Dict[str, List[Tuple[int, int]]]:
    from paddlefleetx_tpu_torch.data.tokenizers import unicode_classes as uc

    return {name: [tuple(r) for r in getattr(uc, name)] for name, _ in CLASSES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddlefleetx_tpu_torch.tools.gen_unicode_classes")
    ap.add_argument("--check", action="store_true",
                    help="compare with the committed table instead of writing it")
    args = ap.parse_args(argv)
    table, version = derive()
    if args.check:
        have = committed()
        bad = [name for name, _ in CLASSES if have[name] != table[name]]
        print("table matches regex " + version if not bad else f"differs: {bad}")
        return 1 if bad else 0
    TARGET.write_text(render(table, version))
    print(f"wrote {TARGET}: " + ", ".join(f"{n} {len(table[n])} ranges" for n, _ in CLASSES))
    return 0


if __name__ == "__main__":
    sys.exit(main())

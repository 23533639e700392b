#!/usr/bin/env python3
"""Compare the checks of two ``chip_smoke.py`` logs, phase by phase.

    python scripts/smoke_log_diff.py OLD.txt NEW.txt

A check line ("PASS ..." or "FAIL ...") prints its measured error in its
text, so a line of OLD found word for word in NEW gave the same error to
the printed digits; so does a ``pair check: {json}`` line with the same
``check`` and ``err``. For each phase both logs ran (the lines up to its
``phase <name>: ...`` line) this prints how many of OLD's check lines NEW
repeats exactly, OLD's lines NEW does not repeat, and how many lines NEW
adds; the exit code is 1 if any of OLD's lines is missing from NEW.
"""

from __future__ import annotations

import collections
import json
import re
import sys

PHASE = re.compile(r"^phase (\w+): ")


def phases(path: str) -> dict:
    """{phase: [check lines]} of one log (pair checks as 'pair check: name = err')."""
    out, lines = {}, []
    with open(path, errors="replace") as f:
        for raw in f:
            line = raw.rstrip("\n")
            m = PHASE.match(line)
            if m:
                out[m.group(1)] = lines
                lines = []
            elif line.startswith(("PASS ", "FAIL ")):
                lines.append(line)
            elif line.startswith("pair check: "):
                d = json.loads(line[len("pair check: "):])
                lines.append(f"pair check: {d['check']} = {d['err']!r}")
    return out


def main(argv: list) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = phases(argv[0]), phases(argv[1])
    missing_any = False
    for name in old:
        if name not in new:
            continue
        a, b = collections.Counter(old[name]), collections.Counter(new[name])
        missing = a - b
        added = b - a
        same = sum((a & b).values())
        print(f"{name}: {same} of {sum(a.values())} check lines repeated exactly, "
              f"{sum(missing.values())} not repeated, {sum(added.values())} added")
        for line in sorted(missing):
            print(f"  not repeated: {line}")
        missing_any |= bool(missing)
    return 1 if missing_any else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Time the port's question-tar index, the C++ indexer against the Python
scanner, at the member counts of GQA's balanced question splits.

The predict and eval CLIs open the question tar once (``data/tar_reader.py:
TarIndex``), one member per question. This script writes such a tar for
each count into a temporary directory (JSON members of the fixture's size),
then times ``TarIndex(path, prefer_native=True)`` and ``prefer_native=False``
(best of 3, the tar in the page cache). The C++ library is built with g++
first, if it is not built yet, and that time is printed apart. Host code
only: no device is used.

    python3 scripts/tar_index_time.py            # testdev and val counts
    python3 scripts/tar_index_time.py 943000     # the train split's count

Prints the host's CPU count and, per count, both times in ms and their
ratio.
"""

from __future__ import annotations

import io
import json
import os
import platform
import sys
import tarfile
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from structured_alignment_vqa_tpu_torch.data.tar_reader import TarIndex  # noqa: E402
from structured_alignment_vqa_tpu_torch.native import tar_index  # noqa: E402

# GQA balanced questions: testdev 12,578, val 132,062 (train 943,000)
COUNTS = (12578, 132062)
REPS = 3


def write_question_tar(path: str, n: int) -> None:
    with tarfile.open(path, "w") as tar:
        for qi in range(n):
            data = json.dumps({"imageId": f"n{qi % 10000:06d}", "question":
                               "What color is the large object to the left of the table?",
                               "answer": "brown", "semantic": [], "types": {}}).encode()
            info = tarfile.TarInfo(f"val/q{qi:07d}.json")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def best_ms(fn) -> float:
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def main(argv: list) -> int:
    counts = tuple(int(a) for a in argv) or COUNTS
    t0 = time.perf_counter()
    native = tar_index.available()
    print(f"host: {os.cpu_count()} CPUs, {platform.machine()}, python {platform.python_version()}; "
          f"native indexer {'built or found' if native else 'unavailable (no g++)'} in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for n in counts:
            path = os.path.join(tmp, f"q{n}.tar")
            write_question_tar(path, n)
            size = os.path.getsize(path) / 2 ** 20
            python_ms = best_ms(lambda: TarIndex(path, prefer_native=False))
            line = f"tar of {n} questions ({size:.1f} MiB): python {python_ms:.1f} ms"
            if native:
                index = TarIndex(path)
                assert index.indexed_by == "native" and len(index) == n
                native_ms = best_ms(lambda: TarIndex(path))
                line += f", native {native_ms:.1f} ms ({python_ms / native_ms:.1f}x)"
            print(line, flush=True)
            os.unlink(path)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

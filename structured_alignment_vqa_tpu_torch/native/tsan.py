"""The native tar indexer under ThreadSanitizer: the port's counterpart of
the TPU package's ``make -C native tsan``.

:func:`build` compiles ``tsan_test.cpp`` with ``tar_index.cpp`` by g++ with
``-fsanitize=thread`` into ``build/`` at the root of the checkout (keyed by
a hash of both sources and the flags, beside the indexer's library);
:func:`run` runs it on a fixture tar it writes and raises when it fails or
ThreadSanitizer reports a race. Usage:

    python -m structured_alignment_vqa_tpu_torch.native.tsan [fixture.tar]
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

from structured_alignment_vqa_tpu_torch.native import BUILD_DIR

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "tar_index.cpp", _HERE / "tsan_test.cpp")
FLAGS = ("-O1", "-g", "-std=c++17", "-fsanitize=thread")


def binary_path() -> Path:
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in SOURCES)
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"tsan_test-{digest}"


def build() -> Path:
    """The harness's binary, built with g++ if it is not there yet."""
    path = binary_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), *map(str, SOURCES), "-lpthread"],
                       check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, path)
    return path


def run(fixture: "str | None" = None) -> str:
    """Build and run the harness (its fixture tar at ``fixture``, else in a
    temporary directory); returns its output line. Raises ``RuntimeError``
    when it exits non-zero or ThreadSanitizer prints a warning."""
    binary = build()
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([str(binary), fixture or os.path.join(tmp, "tsan_fixture.tar")],
                              capture_output=True, text=True, timeout=300)
    if proc.returncode or "ThreadSanitizer" in proc.stderr:
        raise RuntimeError(f"tsan harness failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    return proc.stdout.strip()


if __name__ == "__main__":
    print(run(sys.argv[1] if len(sys.argv) > 1 else None))

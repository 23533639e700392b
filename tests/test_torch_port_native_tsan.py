"""The port's native tar indexer under ThreadSanitizer: its copy of the TPU
package's harness (``native/tsan_test.cpp``: one shared index handle, eight
threads reading entries and ``pread``-ing payloads) built with g++
``-fsanitize=thread`` into ``build/`` and run, as the TPU package's ``make
-C native tsan`` does. Skips only where g++ is missing."""

import shutil

import pytest

from structured_alignment_vqa_tpu_torch.native import BUILD_DIR, tsan


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ to build the harness")
def test_tsan_harness_builds_and_reports_no_race(tmp_path):
    binary = tsan.build()
    assert binary.parent == BUILD_DIR and binary.exists()
    assert tsan.run(str(tmp_path / "fixture.tar")).startswith("tsan harness OK (checksum ")
    assert (tmp_path / "fixture.tar").stat().st_size == 1024 * 501

"""Indexed, random-access tar reading: the port's own copy of the TPU
package's ``data/tar_reader.py``.

The reference re-opens and linearly scans the tar archive for *every sample*
(`data_loader_itp_bbox_super_node_onlyobj.py:246,258,266`) — far too slow to
feed an accelerator. Here each archive is indexed exactly once (member name -> byte
offset/size) and member reads are `os.pread` calls on a persistent fd, which
is thread-safe and allocation-free, so a thread pool can stream samples while
the device computes.

When the C++ native tier builds (`native/`, see `tar_index.cpp`; g++ at
first use), its indexer is used for the initial scan — the read path is
identical. ``TarIndex.indexed_by`` says which one served.
"""

from __future__ import annotations

import io
import json
import os
import struct
import tarfile
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

# (data offset, size) per member
Entry = Tuple[int, int]

_ZIP_LOCAL_SIG = 0x04034B50
_ZIP_LOCAL_FMT = "<IHHHHHIIIHH"  # sig..crc32, csize, usize, nlen, elen
_ZIP_LOCAL_LEN = struct.calcsize(_ZIP_LOCAL_FMT)


def _parse_npz(buf: bytes, allow_pickle: bool) -> Dict[str, np.ndarray]:
    """Decode an in-memory .npz by walking its local zip headers (no CRC)."""
    out: Dict[str, np.ndarray] = {}
    off = 0
    n = len(buf)
    while off + _ZIP_LOCAL_LEN <= n:
        (sig, _ver, flags, comp, _mt, _md, _crc, csize, _usize,
         nlen, elen) = struct.unpack_from(_ZIP_LOCAL_FMT, buf, off)
        if sig != _ZIP_LOCAL_SIG:
            break  # central directory: done
        if flags & 0x8:
            raise ValueError("zip data descriptor (sizes unknown up front)")
        name = buf[off + _ZIP_LOCAL_LEN: off + _ZIP_LOCAL_LEN + nlen].decode()
        if csize == 0xFFFFFFFF or _usize == 0xFFFFFFFF:
            # np.savez opens members with force_zip64: the real sizes live in
            # the zip64 extended-info extra field (tag 0x0001: usize, csize)
            ep = off + _ZIP_LOCAL_LEN + nlen
            end = ep + elen
            while ep + 4 <= end:
                tag, tlen = struct.unpack_from("<HH", buf, ep)
                if tag == 0x0001:
                    fp = ep + 4
                    if _usize == 0xFFFFFFFF:
                        (_usize,) = struct.unpack_from("<Q", buf, fp)
                        fp += 8
                    if csize == 0xFFFFFFFF:
                        (csize,) = struct.unpack_from("<Q", buf, fp)
                    break
                ep += 4 + tlen
            else:
                raise ValueError("zip64 sizes missing")
        start = off + _ZIP_LOCAL_LEN + nlen + elen
        data = buf[start: start + csize]
        if comp == 8:
            data = zlib.decompress(data, -15)
        elif comp != 0:
            raise ValueError(f"unsupported zip compression {comp}")
        if name.endswith(".npy"):
            name = name[:-4]
        out[name] = np.lib.format.read_array(
            io.BytesIO(data), allow_pickle=allow_pickle
        )
        off = start + csize
    if not out:
        raise ValueError("no zip members found")
    return out


def _python_index(path: str) -> List[Tuple[str, int, int]]:
    """Scan the archive once with the stdlib tarfile reader."""
    out = []
    with tarfile.open(path) as tf:
        for m in tf.getmembers():
            if m.isfile():
                out.append((m.name, m.offset_data, m.size))
    return out


def _native_index(path: str) -> Optional[List[Tuple[str, int, int]]]:
    """Use the C++ indexer when available (an order of magnitude faster on
    large archives); returns None to fall back."""
    try:
        from structured_alignment_vqa_tpu_torch.native import tar_index
    except Exception:
        return None
    try:
        return tar_index.index_tar(path)
    except Exception:
        return None


class TarIndex:
    """Random-access view of a tar archive, indexed once at construction."""

    def __init__(self, path: str, prefer_native: bool = True):
        self.path = path
        entries = _native_index(path) if prefer_native else None
        self.indexed_by = "native"
        if entries is None:
            entries = _python_index(path)
            self.indexed_by = "python"
        self._entries: List[Tuple[str, int, int]] = entries
        # key = basename without extension, as the reference keys feature/graph
        # members by image id (`data_loader...onlyobj.py:104-107`)
        self._by_key: Dict[str, Entry] = {}
        for name, off, size in entries:
            key = os.path.splitext(os.path.basename(name))[0]
            self._by_key[key] = (off, size)
        self._fd = os.open(path, os.O_RDONLY)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._by_key

    def keys(self):
        return self._by_key.keys()

    def members(self, suffix: Optional[str] = None) -> List[str]:
        """Member names in archive order (optionally filtered by suffix),
        mirroring `load_tar_infos_list` (`...onlyobj.py:111-121`)."""
        names = [n for n, _, _ in self._entries]
        if suffix:
            names = [n for n in names if n.endswith(suffix)]
        return names

    def read(self, key: str) -> bytes:
        off, size = self._by_key[key]
        return os.pread(self._fd, size, off)

    def read_by_name(self, name: str) -> bytes:
        for n, off, size in self._entries:
            if n == name:
                return os.pread(self._fd, size, off)
        raise KeyError(name)

    def read_npz(self, key: str, allow_pickle: bool = False):
        """Decode an .npz member into {name: array}.

        Fast path: walk the zip *local* file headers directly and hand each
        stored .npy slice to ``np.lib.format.read_array`` — no ``zipfile``
        object churn and, decisively, no CRC32 pass over the (hundreds of KB)
        feature arrays. np.savez writes STORED members with sizes in the
        local header; anything surprising (compression, data descriptors)
        falls back to ``np.load``.
        """
        buf = self.read(key)
        try:
            return _parse_npz(buf, allow_pickle)
        except Exception:
            return np.load(io.BytesIO(buf), allow_pickle=allow_pickle)

    def read_json(self, key: str):
        return json.loads(self.read(key))

    def close(self):
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass


class TarMemberList:
    """Ordered member list with offset-based reads — the question archive view
    (one JSON per question, dataset index == member position)."""

    def __init__(self, index: TarIndex, suffix: str = ".json"):
        self._index = index
        self._members = [
            (n, off, size) for (n, off, size) in index._entries if n.endswith(suffix)
        ]

    def __len__(self) -> int:
        return len(self._members)

    def read_json(self, i: int):
        _, off, size = self._members[i]
        return json.loads(os.pread(self._index._fd, size, off))

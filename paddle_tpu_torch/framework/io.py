"""Single-process save/load: atomic, verified checkpoints (counterpart of
``paddle_tpu/framework/io.py``, the JAX package's code and byte layout).

The pickled structure stays small: every array of at least
``_SEG_THRESHOLD`` bytes, and every bf16 array whatever its size, is
replaced by an indexed placeholder and its bytes are streamed to the same
file in ``_CHUNK``-sized pieces after the pickle blob, so a multi-GB state
never materializes a second copy in memory and no pickle frame approaches
the 4 GB limits of old protocols.

Durability contract (format v2), the JAX package's:

- **Atomic publish**: ``save`` writes to a same-directory temp file,
  flushes and fsyncs it, then ``os.replace``\\ s it onto the destination
  and fsyncs the directory. A crash at any instant leaves the destination
  absent or holding the complete previous checkpoint, never a torn file.
- **Verified load**: the v2 footer carries a CRC32 per raw segment, a
  CRC32 of the pickle blob and a whole-blob digest over everything before
  the footer; ``load(path, verify=True)`` (the default) detects truncation
  and bit-rot with a :class:`CheckpointCorruptError` naming the damaged
  section (``header`` / ``pickle`` / ``segment i ('key')`` / ``footer`` /
  ``trailer`` / ``digest``).

Layout (v2): ``magic2 | u64 pickle_len | pickle | raw segments... | footer
pickle | u64 footer_off | u64 footer_len | u32 footer_crc | end-magic``.
The footer maps a placeholder index to (offset, nbytes, dtype, shape,
crc) plus each segment's key path. Legacy v1 (``PTCKPT01``) and plain
pickle files still load, with bounds checks instead of checksums.

bfloat16 without ``ml_dtypes``: numpy has no bf16 of its own, and the
port does not import ``ml_dtypes``. A bf16 tensor is written as a raw
segment of its 16-bit patterns whose footer dtype is ``"bfloat16"``, the
name the JAX package's ``ml_dtypes`` arrays carry, so the JAX loader
reads it as bf16. On load a ``"bfloat16"`` segment is read as 16-bit
patterns, and an inline ``ml_dtypes.bfloat16`` array in a JAX-written
pickle unpickles as the structured dtype ``_BF16`` (two bytes a value);
both become ``torch.bfloat16`` tensors with the same bits.

``save`` takes the port's ``Tensor``s, plain ``torch.Tensor``s (on the CPU
or the card) and numpy arrays; ``load`` gives ``Tensor``s on the current
device, as the JAX package gives ``jnp`` arrays on its default one.
"""
from __future__ import annotations

import contextlib
import io
import os
import pickle
import struct
import time
import zlib

import numpy as np
import torch

from ..core.place import current_device
from ..core.tensor import Tensor
from ..fault import inject as _inject
from ..observability import metrics as _metrics

_BF16_TAG = "__bf16__"
_EXT_TAG = "__ext_seg__"
_MAGIC = b"PTCKPT01"            # legacy v1: no checksums
_MAGIC2 = b"PTCKPT02"           # v2: per-segment CRC32 + whole-blob digest
_END_MAGIC = b"PTCKEND2"
_TRAILER = struct.Struct("<QQI")  # footer_off, footer_len, footer_crc
_SEG_THRESHOLD = 1 << 20        # arrays >= 1 MB stream as raw segments
_CHUNK = 64 << 20               # 64 MB write/read granularity
#: numpy stand-in for bf16: the 16-bit patterns, never arithmetic
_BF16 = np.dtype([("bf16", "<u2")])
_BF16_NAME = "bfloat16"

_m_save_seconds = _metrics.histogram(
    "paddle_tpu_ckpt_save_seconds", "Wall time of framework.io.save.")
_m_save_bytes = _metrics.counter(
    "paddle_tpu_ckpt_save_bytes_total", "Bytes written by framework.io.save.")
_m_load_seconds = _metrics.histogram(
    "paddle_tpu_ckpt_load_seconds", "Wall time of framework.io.load.")
_m_corruption = _metrics.counter(
    "paddle_tpu_ckpt_corruption_detected_total",
    "Checkpoint loads rejected by integrity checking, per section.",
    labelnames=("section",))


class CheckpointCorruptError(ValueError):
    """A checkpoint failed structural or checksum validation. ``section``
    names the damaged region precisely enough to tell truncation (trailer/
    segment bounds) from bit-rot (checksum mismatch)."""

    def __init__(self, path, section, detail):
        self.path = str(path)
        self.section = section
        self.detail = detail
        super().__init__(
            f"corrupt checkpoint {str(path)!r}: {section}: {detail}")

    def __reduce__(self):
        # Exception.__reduce__ would replay args=(message,) into the
        # 3-arg __init__ and break crossing process boundaries
        return (type(self), (self.path, self.section, self.detail))


def _corrupt(path, section, detail) -> CheckpointCorruptError:
    """Count the detection and build the error (the metric lives at the
    raise site, so unpickling a propagated error never double-counts)."""
    _m_corruption.inc(section=section.split(" ")[0])
    return CheckpointCorruptError(path, section, detail)


# ------------------------------------------------------------------ packing
def _host(t: torch.Tensor):
    """(host array, footer dtype name) of a tensor; bf16 as its 16-bit
    patterns under the name ``bfloat16``."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).cpu().numpy(), _BF16_NAME
    arr = t.contiguous().cpu().numpy()
    return arr, str(arr.dtype)


def _pack(obj, segments, names, prefix=""):
    is_tensor = isinstance(obj, Tensor)
    if is_tensor or isinstance(obj, (torch.Tensor, np.ndarray)):
        if is_tensor:
            obj = obj._data
        arr, dtype = ((obj, str(obj.dtype)) if isinstance(obj, np.ndarray)
                      else _host(obj))
        # bf16 always goes to a segment: a pickled array would need a
        # numpy bf16 dtype, which only ml_dtypes has
        if arr.nbytes >= _SEG_THRESHOLD or dtype == _BF16_NAME:
            segments.append((arr, dtype))
            names.append(prefix or f"<segment {len(segments) - 1}>")
            return {_EXT_TAG: len(segments) - 1, "tensor": is_tensor}
        return {"__tensor__": True, "data": arr} if is_tensor else arr
    if isinstance(obj, dict):
        return {k: _pack(v, segments, names,
                         f"{prefix}.{k}" if prefix else str(k))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_pack(v, segments, names, f"{prefix}[{i}]")
                 for i, v in enumerate(obj))
    return obj


def _rehydrate_array(arr: np.ndarray, device) -> Tensor:
    """Every loaded array becomes a Tensor on ``device``, whatever its
    size: the load contract must not depend on the save-side threshold."""
    if arr.dtype == _BF16:
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    return Tensor(t.to(device))


def _unpack(obj, seg_arrays, device):
    if isinstance(obj, dict):
        if _EXT_TAG in obj:
            return _rehydrate_array(seg_arrays[obj[_EXT_TAG]], device)
        if obj.get(_BF16_TAG):  # legacy round-2 bf16 encoding
            return Tensor(_rehydrate_array(np.asarray(obj["data"]),
                                           device)._data.to(torch.bfloat16))
        if obj.get("__tensor__"):
            return _rehydrate_array(obj["data"], device)
        return {k: _unpack(v, seg_arrays, device) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return _rehydrate_array(obj, device)
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_unpack(v, seg_arrays, device) for v in obj)
    return obj


class _Unpickler(pickle.Unpickler):
    """Reads ``ml_dtypes.bfloat16`` arrays of JAX-written files as
    ``_BF16`` arrays with the same bytes."""

    def find_class(self, module, name):
        if module == "ml_dtypes" and name == _BF16_NAME:
            return _BF16
        return super().find_class(module, name)


def _loads(data: bytes):
    return _Unpickler(io.BytesIO(data)).load()


# ------------------------------------------------------------------ writing
class _CheckedWriter:
    """Write-through wrapper that maintains the whole-blob digest and a
    resettable per-region CRC, and honors the
    ``io.write_truncate_after_bytes`` fault point: once the armed byte
    budget is exhausted the writer persists only the prefix that fits and
    raises; the torn temp file this leaves behind is exactly what a crash
    or full disk produces, which the atomic-publish path must survive."""

    def __init__(self, f):
        self._f = f
        self.digest = 0
        self.region_crc = 0
        self.written = 0
        params = _inject.peek("io.write_truncate_after_bytes")
        self._truncate_after = None if params is None else \
            int(params.get("after_bytes", 0))

    def begin_region(self):
        self.region_crc = 0

    def write(self, data):
        data = memoryview(data)
        if self._truncate_after is not None and \
                self.written + len(data) > self._truncate_after:
            keep = max(self._truncate_after - self.written, 0)
            if keep:
                self._f.write(data[:keep])
                self.written += keep
            self._f.flush()
            _inject.fire("io.write_truncate_after_bytes")
            raise _inject.InjectedFault(
                "io.write_truncate_after_bytes",
                f"write truncated after {self.written} bytes")
        self._f.write(data)
        self.digest = zlib.crc32(data, self.digest)
        self.region_crc = zlib.crc32(data, self.region_crc)
        self.written += len(data)

    def tell(self):
        return self._f.tell()


def _write_segment(w: _CheckedWriter, arr: np.ndarray, dtype: str) -> tuple:
    offset = w.tell()
    w.begin_region()
    view = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    for pos in range(0, len(view), _CHUNK):
        w.write(view[pos:pos + _CHUNK])
    if not len(view):
        w.write(b"")
    return (offset, arr.nbytes, dtype, tuple(arr.shape), w.region_crc)


def _read_segment(f, offset, nbytes, dtype, shape, want_crc=True):
    """Read one raw segment; returns (array, crc32 of its bytes, or 0 when
    ``want_crc`` is off: verify=False must not pay for checksums)."""
    np_dtype = _BF16 if dtype == _BF16_NAME else np.dtype(dtype)
    out = np.empty(int(np.prod(shape)) if shape else 1, np_dtype)
    buf = out.view(np.uint8).reshape(-1)
    f.seek(offset)
    pos = 0
    crc = 0
    while pos < nbytes:
        n = f.readinto(memoryview(buf)[pos:pos + _CHUNK])
        if not n:
            raise EOFError(f"truncated checkpoint segment at {offset}")
        if want_crc:
            crc = zlib.crc32(memoryview(buf)[pos:pos + n], crc)
        pos += n
    return out.reshape(shape), crc


def _fsync_dir(dirname):
    """Durably record the rename in the directory (POSIX crash-consistency
    contract); best-effort on platforms without directory fds."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_replace(tmp: str, dst: str):
    """The shared publish step of every atomic write: ``io.rename_fail``
    guard, ``os.replace``, directory fsync."""
    _inject.check("io.rename_fail", exc=OSError)
    os.replace(tmp, dst)
    _fsync_dir(os.path.dirname(dst))


@contextlib.contextmanager
def atomic_file(dst: str, tmp_suffix: str = ""):
    """Yield a same-directory temp path; on clean exit publish it onto
    ``dst`` via :func:`atomic_replace`, on any error unlink it and
    re-raise. The caller writes and fsyncs the temp file inside the block
    (``tmp_suffix`` serves writers that dictate an extension)."""
    tmp = f"{dst}.tmp.{os.getpid()}{tmp_suffix}"
    try:
        yield tmp
        atomic_replace(tmp, dst)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save(obj, path, protocol=4, **configs):
    """Persist ``obj`` (state dicts, nested containers, Tensors, torch
    tensors, numpy arrays) atomically: temp file, flush/fsync,
    ``os.replace``, directory fsync. The destination never holds a torn
    checkpoint.

    ``protocol`` is pinned to the 2..5 range (the reference io.py
    contract); large arrays bypass pickle entirely, so any allowed
    protocol handles arbitrarily large checkpoints.
    """
    if not 2 <= int(protocol) <= pickle.HIGHEST_PROTOCOL:
        raise ValueError(
            f"pickle protocol must be in [2, {pickle.HIGHEST_PROTOCOL}], "
            f"got {protocol}")
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    segments, names = [], []
    packed = _pack(obj, segments, names)
    blob = pickle.dumps(packed, protocol=int(protocol))
    t0 = time.perf_counter()
    with atomic_file(path) as tmp:
        with open(tmp, "wb") as raw:
            w = _CheckedWriter(raw)
            w.write(_MAGIC2)
            w.write(struct.pack("<Q", len(blob)))
            w.write(blob)
            pickle_crc = zlib.crc32(blob)
            index = [_write_segment(w, arr, dtype)
                     for arr, dtype in segments]
            footer = pickle.dumps(
                {"format": 2, "index": index, "seg_names": names,
                 "pickle_crc": pickle_crc, "digest": w.digest},
                protocol=int(protocol))
            footer_off = w.tell()
            w.write(footer)
            w.write(_TRAILER.pack(footer_off, len(footer),
                                  zlib.crc32(footer)))
            w.write(_END_MAGIC)
            total = w.written
            raw.flush()
            _inject.check("io.fsync_fail", exc=OSError)
            os.fsync(raw.fileno())
    _m_save_seconds.observe(time.perf_counter() - t0)
    _m_save_bytes.inc(total)


# ------------------------------------------------------------------ reading
def load(path, verify=True, **configs):
    """Load a checkpoint as Tensors on the current device. ``verify=True``
    (default) checks the v2 footer CRC, the pickle-blob CRC, every segment
    CRC and the whole-blob digest, raising :class:`CheckpointCorruptError`
    that names the damaged section. Structural bounds are validated in
    every mode and for every format, so truncated files fail with a clear
    error instead of ``struct.error``/``EOFError``."""
    path = str(path)
    device = current_device()
    t0 = time.perf_counter()
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        magic = f.read(len(_MAGIC2))
        if magic == _MAGIC2:
            out = _load_v2(f, size, path, verify, device)
        elif magic == _MAGIC:
            out = _load_v1(f, size, path, device)
        else:
            out = _load_legacy(f, size, path, device)
    _m_load_seconds.observe(time.perf_counter() - t0)
    return out


def _load_v2(f, size, path, verify, device):
    header_len = len(_MAGIC2) + 8
    trailer_len = _TRAILER.size + len(_END_MAGIC)
    if size < header_len + trailer_len:
        raise _corrupt(
            path, "trailer", f"file is {size} bytes — truncated below the "
            f"minimum v2 layout ({header_len + trailer_len} bytes)")
    (blob_len,) = struct.unpack("<Q", f.read(8))
    if header_len + blob_len > size - trailer_len:
        raise _corrupt(
            path, "pickle", f"pickle length {blob_len} exceeds file bounds "
            f"(file is {size} bytes) — truncated or corrupt header")
    blob = f.read(blob_len)
    f.seek(size - trailer_len)
    trailer = f.read(_TRAILER.size)
    if f.read(len(_END_MAGIC)) != _END_MAGIC:
        raise _corrupt(
            path, "trailer", "end marker missing — file truncated "
            "mid-write or trailing bytes corrupted")
    footer_off, footer_len, footer_crc = _TRAILER.unpack(trailer)
    if footer_off < header_len + blob_len or \
            footer_off + footer_len != size - trailer_len:
        raise _corrupt(
            path, "footer", f"footer bounds (offset={footer_off}, "
            f"length={footer_len}) inconsistent with file size {size}")
    f.seek(footer_off)
    footer_bytes = f.read(footer_len)
    if zlib.crc32(footer_bytes) != footer_crc:
        raise _corrupt(path, "footer", "checksum mismatch")
    try:
        meta = _loads(footer_bytes)
        index = meta["index"]
        seg_names = meta.get("seg_names", [])
    except Exception as e:
        raise _corrupt(
            path, "footer", f"undecodable footer: {e}") from e
    if verify and zlib.crc32(blob) != meta["pickle_crc"]:
        raise _corrupt(path, "pickle", "checksum mismatch")
    try:
        packed = _loads(blob)
    except Exception as e:
        raise _corrupt(
            path, "pickle", f"undecodable pickle blob: {e}") from e
    digest = zlib.crc32(blob, zlib.crc32(
        _MAGIC2 + struct.pack("<Q", blob_len))) if verify else 0
    seg_arrays = []
    for i, entry in enumerate(index):
        offset, nbytes, dtype, shape, crc = entry
        name = seg_names[i] if i < len(seg_names) else f"<segment {i}>"
        label = f"segment {i} ({name!r})"
        if offset + nbytes > footer_off:
            raise _corrupt(
                path, label, f"segment bounds (offset={offset}, "
                f"nbytes={nbytes}) overrun the data region — truncated "
                "or corrupt footer")
        try:
            arr, got_crc = _read_segment(f, offset, nbytes, dtype, shape,
                                         want_crc=verify)
        except (EOFError, OSError, ValueError) as e:
            raise _corrupt(
                path, label, f"unreadable segment: {e}") from e
        if verify:
            if got_crc != crc:
                raise _corrupt(path, label, "checksum mismatch")
            if arr.size:
                digest = zlib.crc32(arr.reshape(-1).view(np.uint8), digest)
        seg_arrays.append(arr)
    if verify and digest != meta["digest"]:
        raise _corrupt(
            path, "digest", "whole-blob digest mismatch — data region "
            "altered outside any segment")
    return _unpack(packed, seg_arrays, device)


def _load_v1(f, size, path, device):
    """Legacy v1 (no checksums): structural bounds validation so a
    truncated file raises a clear corruption error instead of a confusing
    ``struct.error``/``EOFError``."""
    header_len = len(_MAGIC) + 8
    if size < header_len + 8:
        raise _corrupt(
            path, "header", f"file is {size} bytes — truncated below the "
            f"minimum v1 layout ({header_len + 8} bytes)")
    (blob_len,) = struct.unpack("<Q", f.read(8))
    if header_len + blob_len > size - 8:
        raise _corrupt(
            path, "pickle", f"pickle length {blob_len} exceeds file bounds "
            f"(file is {size} bytes) — truncated or corrupt header")
    blob = f.read(blob_len)
    try:
        packed = _loads(blob)
    except Exception as e:
        raise _corrupt(
            path, "pickle", f"undecodable pickle blob: {e}") from e
    f.seek(size - 8)
    (footer_off,) = struct.unpack("<Q", f.read(8))
    if not header_len + blob_len <= footer_off <= size - 8:
        raise _corrupt(
            path, "footer", f"footer offset {footer_off} out of bounds "
            f"(file is {size} bytes) — truncated or corrupt trailer")
    f.seek(footer_off)
    try:
        index = _loads(f.read(size - 8 - footer_off))
    except Exception as e:
        raise _corrupt(
            path, "footer", f"undecodable footer: {e}") from e
    seg_arrays = []
    for i, entry in enumerate(index):
        offset, nbytes, dtype, shape = entry
        if offset + nbytes > footer_off:
            raise _corrupt(
                path, f"segment {i}", f"segment bounds (offset={offset}, "
                f"nbytes={nbytes}) overrun the data region")
        try:
            arr, _ = _read_segment(f, offset, nbytes, dtype, shape,
                                   want_crc=False)   # v1 has no checksums
        except (EOFError, OSError, ValueError) as e:
            raise _corrupt(
                path, f"segment {i}", f"unreadable segment: {e}") from e
        seg_arrays.append(arr)
    return _unpack(packed, seg_arrays, device)


def _load_legacy(f, size, path, device):
    # no magic: a plain pickle; but a v2 file whose header magic was
    # bit-flipped still carries the end marker: report that as
    # corruption, not as an unpicklable legacy file
    if size >= len(_END_MAGIC):
        f.seek(size - len(_END_MAGIC))
        if f.read(len(_END_MAGIC)) == _END_MAGIC:
            raise _corrupt(
                path, "header", "magic bytes corrupted (v2 end marker "
                "present but header does not match)")
    f.seek(0)
    try:
        obj = _Unpickler(f).load()
    except Exception as e:
        raise _corrupt(
            path, "header", f"not a paddle_tpu checkpoint and not a "
            f"legacy pickle: {e}") from e
    return _unpack_legacy(obj, device)


def _unpack_legacy(obj, device):
    if isinstance(obj, dict):
        if obj.get(_BF16_TAG):
            return Tensor(_rehydrate_array(np.asarray(obj["data"]),
                                           device)._data.to(torch.bfloat16))
        return {k: _unpack_legacy(v, device) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return _rehydrate_array(obj, device)
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_unpack_legacy(v, device) for v in obj)
    return obj

"""The port's ``framework.io`` against the JAX package's.

Files cross both ways: what one package's ``save`` writes, the other's
``load`` reads with every value bit for bit the same (bf16 inline in a
JAX pickle, bf16 in raw segments, >1 MB segments, every integer width,
bool, empty arrays, nested containers and scalars). The JAX package runs
with x64 off, so an int64 array it loads comes back as int32 with the
same values; everything else keeps its dtype. The JAX package's
``tests/test_fault.py::TestV2Format`` truncation matrix and byte flips
run on one file in both packages, which must raise
``CheckpointCorruptError`` naming the same section. Beside them: crash
mid-save, ``rename_fail`` and ``fsync_fail`` leave the destination
intact; JAX-layout v1 and plain-pickle files load; the protocol bound;
``verify=False`` skips the checksums; the error crosses a process.
"""
import base64
import os
import pickle
import struct
import subprocess
import sys
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.fault import inject as j_inject
from paddle_tpu.framework import io as jio
import paddle_tpu_torch as tp
from paddle_tpu_torch.fault import inject as t_inject
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.observability import REGISTRY as T_REGISTRY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG = tio._SEG_THRESHOLD // 4 + 7        # fp32 values: a raw segment


@pytest.fixture(autouse=True)
def _clean():
    t_inject.disarm_all()
    j_inject.disarm_all()
    tp.set_flags({"FLAGS_enable_metrics": False})
    T_REGISTRY.reset()
    with tp.device_guard("cpu"):
        yield
    t_inject.disarm_all()
    j_inject.disarm_all()
    tp.set_flags({"FLAGS_enable_metrics": False})
    T_REGISTRY.reset()


def _bits(v):
    """(dtype name, shape, raw bytes) of a loaded value of either package,
    or the value itself when it is not an array."""
    if isinstance(v, tp.Tensor):
        d = v._data
        if d.dtype == torch.bfloat16:
            return ("bfloat16", tuple(d.shape),
                    d.view(torch.int16).numpy().tobytes())
        a = d.numpy()
    elif isinstance(v, jp.Tensor):
        a = np.asarray(v._data)
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        return _bits(tp.Tensor(torch.as_tensor(v)) if isinstance(
            v, torch.Tensor) else tp.Tensor(torch.from_numpy(v)))
    elif isinstance(v, dict):
        return {k: _bits(x) for k, x in v.items()}
    elif isinstance(v, (list, tuple)):
        return type(v)(_bits(x) for x in v)
    else:
        return v
    name = "bfloat16" if a.dtype == ml_dtypes.bfloat16 else str(a.dtype)
    if name == "int64":         # the JAX package loads x64-off: int32
        a = a.astype(np.int32)
        name = "int32"
    return (name, tuple(a.shape), a.tobytes())


def _arrays():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 4).astype(np.float32),
        "f16": rng.randn(5, 2).astype(np.float16),
        "bf16_small": rng.randn(7).astype(np.float32),     # cast below
        "bf16_big": rng.randn(BIG * 2).astype(np.float32),  # cast below
        "i8": rng.randint(-128, 128, (9,)).astype(np.int8),
        "i32": rng.randint(-2 ** 31, 2 ** 31 - 1, (4,)).astype(np.int32),
        "i64": rng.randint(-2 ** 31, 2 ** 31 - 1, (3, 2)).astype(np.int64),
        "bool": rng.rand(6) > 0.5,
        "empty": np.zeros((0, 3), np.float32),
        "scalar0d": np.asarray(2.5, np.float32),
        "big": rng.randn(BIG).astype(np.float32),
        "nan_inf": np.asarray([np.nan, np.inf, -np.inf, -0.0], np.float32),
    }


def _jax_state():
    a = _arrays()
    t = {k: jp.to_tensor(v) for k, v in a.items()
         if k not in ("i64",)}
    t["bf16_small"] = t["bf16_small"].astype("bfloat16")
    t["bf16_big"] = t["bf16_big"].astype("bfloat16")
    t["i64"] = a["i64"]                 # a numpy array keeps its int64
    t["nested"] = {"list": [t["f32"], 3, "x"], "tuple": (1.5, t["i8"]),
                   "none": None, "deep": {"x": {"y": t["bool"]}}}
    t["step"] = 7
    t["lr"] = 0.125
    return t


def _port_state():
    a = _arrays()
    t = {k: tp.to_tensor(v) for k, v in a.items()}
    t["bf16_small"] = t["bf16_small"].astype("bfloat16")
    t["bf16_big"] = t["bf16_big"].astype("bfloat16")
    t["i64"] = torch.from_numpy(a["i64"])          # a plain torch.Tensor
    t["bf16_torch"] = torch.from_numpy(a["f32"]).to(torch.bfloat16)
    t["np_f32"] = a["f32"]                          # a numpy array
    t["nested"] = {"list": [t["f32"], 3, "x"], "tuple": (1.5, t["i8"]),
                   "none": None, "deep": {"x": {"y": t["bool"]}}}
    t["step"] = 7
    t["lr"] = 0.125
    return t


def test_jax_written_file_loads_in_the_port_bitwise(tmp_path):
    path = str(tmp_path / "j.pdparams")
    state = _jax_state()
    jio.save(state, path)
    got = tio.load(path)
    assert _bits(got) == _bits(jio.load(path)) == _bits(state)
    assert got["bf16_small"].dtype == torch.bfloat16
    assert got["i64"].dtype == torch.int64          # numpy int64 kept
    assert all(v._data.device.type == "cpu" for v in got.values()
               if isinstance(v, tp.Tensor))


def test_port_written_file_loads_in_jax_bitwise(tmp_path):
    path = str(tmp_path / "t.pdparams")
    state = _port_state()
    tio.save(state, path)
    got = jio.load(path)
    assert np.asarray(got["bf16_small"]._data).dtype == ml_dtypes.bfloat16
    assert _bits(got) == _bits(state)
    assert _bits(tio.load(path)) == _bits(state)
    # the port sends every bf16 array to a segment tagged "bfloat16"
    with open(path, "rb") as f:
        raw = f.read()
    size, _, footer_off = _layout(path)
    footer = pickle.loads(raw[footer_off:size - jio._TRAILER.size
                              - len(jio._END_MAGIC)])
    names = dict(zip(footer["seg_names"], footer["index"]))
    assert names["bf16_small"][2] == "bfloat16"
    assert names["bf16_torch"][2] == "bfloat16"


def test_plain_pickle_with_ml_dtypes_bf16_loads(tmp_path):
    """A round-2 plain pickle from the JAX package holds ml_dtypes bf16
    arrays and the legacy ``__bf16__`` tag."""
    a = np.asarray([1.5, -2.0, 3.25, np.nan], np.float32)
    path = str(tmp_path / "legacy.pdparams")
    # the tag's data is cast on load, and a cast NaN's bf16 pattern is the
    # library's own (torch 0xffff, XLA 0x7fc0): the tag holds no NaN
    with open(path, "wb") as f:
        pickle.dump({"bf": a.astype(ml_dtypes.bfloat16),
                     "tag": {"__bf16__": True, "data": a[:3]},
                     "w": [a]}, f, protocol=4)
    got, ref = tio.load(path), jio.load(path)
    assert _bits(got) == _bits(ref)
    assert got["bf"].dtype == got["tag"].dtype == torch.bfloat16


# ------------------------------------------- the JAX package's TestV2Format
def _state(pkg):
    big = pkg.to_tensor(np.arange(BIG, dtype=np.float32))
    return {"w": big,
            "b": pkg.to_tensor(np.asarray([1.5, -2.0], np.float32)),
            "step": 3}


def _assert_roundtrip(out):
    assert out["step"] == 3
    np.testing.assert_array_equal(np.asarray(out["b"].numpy()), [1.5, -2.0])
    np.testing.assert_array_equal(np.asarray(out["w"].numpy()),
                                  np.arange(BIG, dtype=np.float32))


def _layout(path):
    """(size, pickle_end, footer_off) of a v2 checkpoint."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        assert f.read(8) == jio._MAGIC2
        (blob_len,) = struct.unpack("<Q", f.read(8))
        f.seek(size - jio._TRAILER.size - len(jio._END_MAGIC))
        footer_off, _, _ = jio._TRAILER.unpack(f.read(jio._TRAILER.size))
    return size, 16 + blob_len, footer_off


def _sections(path):
    """The section each package's load names for the file at ``path``."""
    out = []
    for load, err in ((jio.load, jio.CheckpointCorruptError),
                      (tio.load, tio.CheckpointCorruptError)):
        with pytest.raises(err) as ei:
            load(path)
        assert path in str(ei.value)
        out.append(ei.value.section)
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_roundtrip_and_verify_default(tmp_path, writer):
    p = str(tmp_path / "a.pdckpt")
    (jio if writer == "jax" else tio).save(
        _state(jp if writer == "jax" else tp), p)
    for load in (jio.load, tio.load):
        _assert_roundtrip(load(p))
        _assert_roundtrip(load(p, verify=False))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("cut", ["mid-magic", "mid-length", "mid-pickle",
                                 "mid-segment", "mid-footer", "mid-trailer",
                                 "no-end-magic"])
def test_truncation_matrix_names_the_same_section(tmp_path, writer, cut):
    p = str(tmp_path / "a.pdckpt")
    (jio if writer == "jax" else tio).save(
        _state(jp if writer == "jax" else tp), p)
    size, pickle_end, footer_off = _layout(p)
    at = {"mid-magic": 4, "mid-length": 12,
          "mid-pickle": (16 + pickle_end) // 2,
          "mid-segment": (pickle_end + footer_off) // 2,
          "mid-footer": footer_off + 5, "mid-trailer": size - 10,
          "no-end-magic": size - 3}[cut]
    q = str(tmp_path / "cut.pdckpt")
    with open(p, "rb") as f, open(q, "wb") as g:
        g.write(f.read()[:at])
    j_section, t_section = _sections(q)
    assert t_section == j_section


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("where,expect", [
    ("pickle", "pickle"), ("segment", "segment 0 ('w')"),
    ("footer", "footer"), ("header", "header")])
def test_single_byte_flips_name_the_same_section(tmp_path, writer, where,
                                                 expect):
    p = str(tmp_path / "a.pdckpt")
    (jio if writer == "jax" else tio).save(
        _state(jp if writer == "jax" else tp), p)
    size, pickle_end, footer_off = _layout(p)
    off = {"pickle": 20, "segment": (pickle_end + footer_off) // 2,
           "footer": footer_off + 3, "header": 2}[where]
    body = bytearray(open(p, "rb").read())
    body[off] ^= 0x40
    q = str(tmp_path / "flip.pdckpt")
    with open(q, "wb") as f:
        f.write(bytes(body))
    j_section, t_section = _sections(q)
    assert t_section == j_section
    assert expect in t_section


def test_corruption_metric_counts(tmp_path):
    p = str(tmp_path / "a.pdckpt")
    tio.save(_state(tp), p)
    body = bytearray(open(p, "rb").read())
    body[len(body) // 2] ^= 0x01
    open(p, "wb").write(bytes(body))
    tp.set_flags({"FLAGS_enable_metrics": True})
    with pytest.raises(tio.CheckpointCorruptError):
        tio.load(p)
    m = T_REGISTRY.get("paddle_tpu_ckpt_corruption_detected_total")
    assert m is not None and m.total() >= 1


@pytest.mark.parametrize("point", ["io.write_truncate_after_bytes",
                                   "io.rename_fail", "io.fsync_fail"])
def test_failed_save_leaves_destination_intact(tmp_path, point):
    """A crash mid-write, a failed rename or a failed fsync: the
    destination keeps the previous checkpoint's bytes, no temp file
    survives, and both packages still load it."""
    p = str(tmp_path / "a.pdckpt")
    tio.save(_state(tp), p)
    old = open(p, "rb").read()
    params = {"after_bytes": len(old) // 2} if "truncate" in point else {}
    with t_inject.armed(point, **params):
        with pytest.raises((t_inject.InjectedFault, OSError)):
            tio.save({"other": tp.to_tensor(
                np.zeros(tio._SEG_THRESHOLD // 2, np.float32))}, p)
        assert t_inject.fired_count(point) == 1
    assert open(p, "rb").read() == old
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]
    _assert_roundtrip(tio.load(p))
    _assert_roundtrip(jio.load(p))


def _write_v1(path, obj, segments=()):
    """The v1 layout of the JAX package's pre-v2 writer: magic, pickle,
    raw segments, the footer index, the footer offset."""
    blob = pickle.dumps(obj, protocol=4)
    with open(path, "wb") as f:
        f.write(jio._MAGIC)
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        index = []
        for arr in segments:
            index.append((f.tell(), arr.nbytes, str(arr.dtype),
                          tuple(arr.shape)))
            f.write(arr.tobytes())
        off = f.tell()
        f.write(pickle.dumps(index, protocol=4))
        f.write(struct.pack("<Q", off))


def test_legacy_v1_and_plain_pickle_still_load(tmp_path):
    small = np.asarray([[1.0, 2.0]], np.float32)
    seg = np.arange(10, dtype=np.int32)
    p1 = str(tmp_path / "v1.pdparams")
    _write_v1(p1, {"w": small, "s": {jio._EXT_TAG: 0, "tensor": True}},
              [seg])
    got, ref = tio.load(p1), jio.load(p1)
    assert _bits(got) == _bits(ref)
    np.testing.assert_array_equal(got["w"].numpy(), [[1.0, 2.0]])
    np.testing.assert_array_equal(got["s"].numpy(), seg)
    p2 = str(tmp_path / "legacy.pdparams")
    with open(p2, "wb") as f:
        pickle.dump({"b": small}, f, protocol=4)
    np.testing.assert_array_equal(tio.load(p2)["b"].numpy(), [[1.0, 2.0]])


def test_truncated_v1_raises_clear_error(tmp_path):
    p = str(tmp_path / "v1.pdparams")
    _write_v1(p, {"a": 1})
    raw = open(p, "rb").read()
    for cut in (10, 18, len(raw) - 4):
        q = str(tmp_path / f"cut{cut}")
        open(q, "wb").write(raw[:cut])
        j_section, t_section = _sections(q)
        assert t_section == j_section


@pytest.mark.parametrize("protocol", [2, 5])
def test_protocol_bound(tmp_path, protocol):
    p = str(tmp_path / "a.pdckpt")
    for bad in (1, pickle.HIGHEST_PROTOCOL + 1):
        with pytest.raises(ValueError, match="protocol"):
            tio.save({"x": 1}, p, protocol=bad)
    assert not os.path.exists(p)
    tio.save(_state(tp), p, protocol=protocol)
    _assert_roundtrip(jio.load(p))


def test_load_verify_false_skips_checksum_work(tmp_path, monkeypatch):
    p = str(tmp_path / "a.pdckpt")
    tio.save(_state(tp), p)
    calls = {"n": 0}
    real = zlib.crc32

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tio.zlib, "crc32", counting)
    tio.load(p, verify=False)
    unverified = calls["n"]
    calls["n"] = 0
    tio.load(p, verify=True)
    assert unverified < calls["n"]
    assert unverified <= 1   # the footer's crc only


_CHILD = """
import base64, pickle, sys
import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import io
tp.set_device("cpu")
try:
    io.load(sys.argv[1])
except io.CheckpointCorruptError as e:
    print(base64.b64encode(pickle.dumps(e)).decode())
"""


def test_corrupt_error_crosses_a_process(tmp_path):
    """The error a child process raises unpickles in the parent with its
    path, section and detail."""
    p = str(tmp_path / "a.pdckpt")
    tio.save(_state(tp), p)
    body = bytearray(open(p, "rb").read())
    body[len(body) // 2] ^= 0x01
    open(p, "wb").write(bytes(body))
    proc = subprocess.run([sys.executable, "-c", _CHILD, p], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    e = pickle.loads(base64.b64decode(proc.stdout.split()[-1]))
    assert isinstance(e, tio.CheckpointCorruptError)
    assert (e.path, e.section) == (p, "segment 0 ('w')")
    assert str(e) == f"corrupt checkpoint {p!r}: {e.section}: {e.detail}"
    e2 = pickle.loads(pickle.dumps(e))
    assert (e2.path, e2.section, e2.detail) == (e.path, e.section, e.detail)


def test_top_level_save_load(tmp_path):
    p = str(tmp_path / "m.pdparams")
    net = tp.nn.Linear(3, 2)
    tp.save(net.state_dict(), p)
    back = tp.load(p)
    assert set(back) == set(net.state_dict())
    for k, v in net.state_dict().items():
        torch.testing.assert_close(back[k]._data, v._data, atol=0, rtol=0)

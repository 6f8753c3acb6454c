"""The xplane.pb reader behind the device-timeline measurements
(kernels/xplane.py).  The wire bytes are hand-assembled here from the
protobuf encoding spec, so the test pins the exact subset of
tensorflow/core/profiler/protobuf/xplane.proto the parser relies on —
if upstream renumbers a field, this fails loudly instead of the bench
silently reading zero device time."""

import os

import jax
import jax.numpy as jnp

from ogl_tpu.kernels import xplane


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _vint(fno: int, v: int) -> bytes:
    return _varint(fno << 3 | 0) + _varint(v)


def _blob(fno: int, payload: bytes) -> bytes:
    return _varint(fno << 3 | 2) + _varint(len(payload)) + payload


def _event(mid: int, off_ps: int, dur_ps: int) -> bytes:
    return _vint(1, mid) + _vint(2, off_ps) + _vint(3, dur_ps)


def _build_space(plane_name: bytes, ts_ns: int, events, meta) -> bytes:
    line = _blob(2, b"XLA Ops") + _vint(3, ts_ns)
    for e in events:
        line += _blob(4, _event(*e))
    plane = _blob(2, plane_name) + _blob(3, line)
    for mid, name in meta.items():
        entry = _vint(1, mid) + _blob(2, _vint(1, mid) + _blob(2, name))
        plane += _blob(4, entry)
    return _blob(1, plane)


def _write_capture(tmp_path, space: bytes) -> str:
    run = tmp_path / "plugins" / "profile" / "run1"
    os.makedirs(run)
    p = run / "host.xplane.pb"
    p.write_bytes(space)
    return str(tmp_path)


def test_parse_synthetic_space(tmp_path):
    space = _build_space(
        b"/device:GPU:0", ts_ns=1000,
        events=[(1, 0, 2000), (2, 1000, 2000), (1, 10_000, 1000)],
        meta={1: b"fusion.1", 2: b"copy.2"})
    d = _write_capture(tmp_path, space)
    planes = xplane.parse_xspace(xplane.latest_xplane_file(d))
    assert len(planes) == 1
    (p,) = planes
    assert p.name == "/device:GPU:0"
    assert p.event_names == {1: "fusion.1", 2: "copy.2"}
    (ln,) = p.lines
    assert ln.timestamp_ns == 1000 and len(ln.events) == 3
    assert ln.events[0].duration_ps == 2000


def test_busy_union_collapses_overlap(tmp_path):
    # events 1+2 overlap ([0,2000] U [1000,3000] = 3000 ps); event 3 is
    # disjoint (1000 ps) -> union 4000 ps, raw sum 5000 ps
    space = _build_space(
        b"/device:GPU:0", ts_ns=1000,
        events=[(1, 0, 2000), (2, 1000, 2000), (1, 10_000, 1000)],
        meta={1: b"fusion.1", 2: b"copy.2"})
    d = _write_capture(tmp_path, space)
    busy = xplane.device_busy_seconds(d)
    assert busy == {"/device:GPU:0": 4000 / 1e12}
    raw = xplane.device_busy_seconds(d, collapse_overlap=False)
    assert raw == {"/device:GPU:0": 5000 / 1e12}


def test_busy_name_filter(tmp_path):
    space = _build_space(
        b"/device:GPU:0", ts_ns=0,
        events=[(1, 0, 2000), (2, 5000, 500)],
        meta={1: b"fusion.1", 2: b"copy.2"})
    d = _write_capture(tmp_path, space)
    busy = xplane.device_busy_seconds(d, name_contains="copy")
    assert busy == {"/device:GPU:0": 500 / 1e12}


def test_line_counts_per_device_line(tmp_path):
    # kernel count per stream line = event count (the per-iteration kernel
    # count of a traced solve divides this by its iteration count)
    space = (_build_space(b"/host:CPU", 0, [(1, 0, 9000)], {1: b"py"})
             + _build_space(b"/device:GPU:0", 0,
                            [(1, 0, 100), (2, 200, 300), (1, 900, 100)],
                            {1: b"k1", 2: b"k2"}))
    d = _write_capture(tmp_path, space)
    summary = xplane.device_line_summary(d)
    assert summary == {("/device:GPU:0", "XLA Ops"): (
        3, 500 / 1e12, {"k1": (2, 200 / 1e12), "k2": (1, 300 / 1e12)})}


def test_host_planes_excluded(tmp_path):
    space = (_build_space(b"/host:CPU", 0, [(1, 0, 9000)], {1: b"py"})
             + _build_space(b"/device:GPU:0", 0, [(1, 0, 100)], {1: b"k"}))
    d = _write_capture(tmp_path, space)
    busy = xplane.device_busy_seconds(d)
    assert list(busy) == ["/device:GPU:0"]


def test_live_capture_parses(tmp_path):
    """A real jax.profiler capture on this backend parses without error
    (schema drift guard); busy time, when a device plane exists, is
    positive and bounded by the wall clock."""
    import time

    f = jax.jit(lambda x: jnp.sum(x * 2.0 + 1.0))
    x = jnp.ones((1 << 16,), jnp.float32)
    float(f(x))  # compile outside the trace
    t0 = time.perf_counter()
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(4):
            float(f(x))
    wall = time.perf_counter() - t0
    planes = xplane.parse_xspace(xplane.latest_xplane_file(str(tmp_path)))
    assert planes, "capture produced an empty XSpace"
    busy = xplane.device_busy_seconds(str(tmp_path))
    for name, sec in busy.items():
        assert 0 <= sec <= wall * 2, (name, sec, wall)

"""Minimal XSpace/XPlane protobuf reader — device-side kernel timings from
a `jax.profiler.trace` capture, with no tensorflow/tensorboard dependency.

Host-clock timing of a chained device program includes dispatch and any
idle gaps; this module reads the DEVICE timeline (what the accelerator
executed, in picoseconds, from the profiler's xplane.pb) so kernel time,
busy time and kernel counts come from the device clock.  The trace
arrives as a TensorBoard `plugins/profile/<run>/<host>.xplane.pb` whose
schema is small and stable (tensorflow/core/profiler/protobuf/xplane.proto)
— a hand-rolled wire-format walk is ~100 lines and avoids shipping
tensorflow.

Wire format facts used (protobuf encoding spec):
  key = (field_number << 3) | wire_type
  wire types: 0 = varint, 1 = fixed64, 2 = length-delimited, 5 = fixed32

Schema subset (field numbers from xplane.proto):
  XSpace:  planes = 1 (repeated XPlane)
  XPlane:  id = 1, name = 2, lines = 3 (repeated XLine),
           event_metadata = 4 (map<int64, XEventMetadata>)
  XLine:   id = 1, name = 2, timestamp_ns = 3, events = 4 (repeated XEvent),
           duration_ps = 9, display_name = 11
  XEvent:  metadata_id = 1, offset_ps = 2, duration_ps = 3,
           num_occurrences = 5
  XEventMetadata: id = 1, name = 2
"""

from __future__ import annotations

import dataclasses
import glob
import os

__all__ = ["XEvent", "XLine", "XPlane", "parse_xspace", "latest_xplane_file",
           "device_planes", "device_busy_seconds", "device_line_summary"]


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes.
    LEN fields yield the raw sub-buffer; varints yield ints; fixed widths
    yield raw bytes (unused here but kept for forward-compat)."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:  # wire types 3/4 (groups) do not occur in xplane.proto
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, v


@dataclasses.dataclass
class XEvent:
    metadata_id: int
    offset_ps: int
    duration_ps: int


@dataclasses.dataclass
class XLine:
    name: str
    timestamp_ns: int
    events: list


@dataclasses.dataclass
class XPlane:
    name: str
    lines: list
    event_names: dict  # metadata_id -> kernel/op name


def _parse_event(buf: bytes) -> XEvent:
    mid = off = dur = 0
    for fno, _, v in _fields(buf):
        if fno == 1:
            mid = v
        elif fno == 2:
            off = v
        elif fno == 3:
            dur = v
    return XEvent(mid, off, dur)


def _parse_line(buf: bytes) -> XLine:
    name, ts, events = "", 0, []
    for fno, _, v in _fields(buf):
        if fno == 2:
            name = v.decode("utf-8", "replace")
        elif fno == 3:
            ts = v
        elif fno == 4:
            events.append(_parse_event(v))
    return XLine(name, ts, events)


def _parse_event_metadata_entry(buf: bytes) -> tuple[int, str]:
    """One map<int64, XEventMetadata> entry -> (id, name)."""
    key, name = 0, ""
    for fno, _, v in _fields(buf):
        if fno == 1:
            key = v
        elif fno == 2:  # XEventMetadata
            for f2, _, v2 in _fields(v):
                if f2 == 2:
                    name = v2.decode("utf-8", "replace")
    return key, name


def _parse_plane(buf: bytes) -> XPlane:
    name, lines, enames = "", [], {}
    for fno, _, v in _fields(buf):
        if fno == 2:
            name = v.decode("utf-8", "replace")
        elif fno == 3:
            lines.append(_parse_line(v))
        elif fno == 4:
            k, nm = _parse_event_metadata_entry(v)
            enames[k] = nm
    return XPlane(name, lines, enames)


def parse_xspace(path: str) -> list:
    with open(path, "rb") as f:
        buf = f.read()
    planes = []
    for fno, _, v in _fields(buf):
        if fno == 1:
            planes.append(_parse_plane(v))
    return planes


def latest_xplane_file(trace_dir: str) -> str:
    """The xplane.pb of the most recent run under a jax.profiler.trace
    logdir (<dir>/plugins/profile/<run>/<host>.xplane.pb)."""
    cands = glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb"))
    if not cands:
        raise FileNotFoundError(f"no xplane.pb under {trace_dir}")
    return max(cands, key=os.path.getmtime)


def device_planes(planes: list) -> list:
    """Accelerator planes (named '/device:GPU:<n>' on a GPU; the host plane
    is '/host:CPU' and python/thread planes carry neither prefix)."""
    return [p for p in planes if p.name.startswith("/device:")]


def device_busy_seconds(trace_dir: str, name_contains: str | None = None,
                        collapse_overlap: bool = True) -> dict:
    """Total device-busy seconds per plane from a trace capture.

    Events overlap across a plane's lines (XLA modules nest: module >
    fusion > op), so summing raw durations double-counts; with
    `collapse_overlap` the per-plane busy time is the measure of the UNION
    of event intervals — exactly 'time the device was executing anything'.
    `name_contains` restricts to events whose kernel/op name matches
    (useful to isolate one program in a multi-program capture)."""
    out = {}
    for p in device_planes(parse_xspace(latest_xplane_file(trace_dir))):
        ivals = []
        for ln in p.lines:
            for ev in ln.events:
                if name_contains is not None and name_contains not in \
                        p.event_names.get(ev.metadata_id, ""):
                    continue
                start = ln.timestamp_ns * 1000 + ev.offset_ps
                ivals.append((start, start + ev.duration_ps))
        if not collapse_overlap:
            out[p.name] = sum(e - s for s, e in ivals) / 1e12
            continue
        ivals.sort()
        busy = 0
        cur_s = cur_e = None
        for s, e in ivals:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        out[p.name] = busy / 1e12
    return out


def device_line_summary(trace_dir: str) -> dict:
    """{(plane, line): (n_events, busy_seconds, {name: (count, seconds)})}
    for every line of every device plane.  On a GPU the stream lines carry
    one event per kernel launch or copy, so a line's event count over a
    known number of solver iterations is the launches per iteration, and
    the name table shows which kernels and copies they are."""
    out = {}
    for p in device_planes(parse_xspace(latest_xplane_file(trace_dir))):
        for ln in p.lines:
            names: dict = {}
            for ev in ln.events:
                nm = p.event_names.get(ev.metadata_id, "?")
                c, d = names.get(nm, (0, 0))
                names[nm] = (c + 1, d + ev.duration_ps)
            out[(p.name, ln.name)] = (
                len(ln.events),
                sum(ev.duration_ps for ev in ln.events) / 1e12,
                {k: (c, d / 1e12) for k, (c, d) in names.items()})
    return out

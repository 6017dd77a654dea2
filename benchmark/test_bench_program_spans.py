"""The readers of the program's spans (``run_host_ms``, ``upload_ms``,
``download_ms``, ``vco_scan_host_us``) on hand-made span lists: only the
``pi.run`` spans inside the run's ``traced`` span count (CPU)."""

from __future__ import annotations

import pytest

from benchmark.harness import core

MS = 1_000_000
US = 1_000


class Ctx:
    def __init__(self, t0=1.0, t1=2.0):
        self.spans = core.Spans()
        self.spans.records += [("warmup", 0.1, 0.2), ("traced", t0, t1),
                               ("episode", t0 + 0.05, t0 + 0.1)]


def episode(at, upload, calls, wait, download, tail=0):
    """One pi.run at ``at`` ns with its children in order, as (name,
    parent offset, start, end) rows; the parent's end leaves ``tail``
    ns after the last child."""
    rows, t = [], at
    for name, dur in [("pi.upload", upload),
                      *(("vco_scan.call", c) for c in calls),
                      ("pi.wait", wait), ("pi.download", download)]:
        rows.append((name, t, t + dur))
        t += dur
    return [("pi.run", at, t + tail)] + rows


def span_list(episodes):
    from sspslam_tpu_torch.utils.profiling import Span
    out = []
    for rows in episodes:
        top = len(out)
        out.append(Span(rows[0][0], -1, rows[0][1], rows[0][2]))
        out += [Span(n, top, a, b) for n, a, b in rows[1:]]
    return out


SPANS = [
    # an earlier run's episode, before the slice
    episode(500 * MS, 3 * MS, [900 * US, 900 * US], 20 * MS, 3 * MS),
    # the slice's two episodes
    episode(1100 * MS, 2 * MS, [100 * US, 300 * US], 20 * MS, 1 * MS,
            tail=50 * US),
    episode(1500 * MS, 1 * MS, [200 * US, 200 * US], 21 * MS, 2 * MS),
    # one that runs past the slice's end, and one after it
    episode(1990 * MS, 5 * MS, [5 * MS, 5 * MS], 20 * MS, 5 * MS),
    episode(2500 * MS, 5 * MS, [5 * MS, 5 * MS], 20 * MS, 5 * MS),
]


@pytest.fixture
def spans(monkeypatch):
    from sspslam_tpu_torch.utils import profiling
    recs = span_list(SPANS)
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    return recs


@pytest.mark.parametrize("metric, want", [
    # (2 + 0.1 + 0.3 + 1 + 0.05) and (1 + 0.2 + 0.2 + 2) ms outside pi.wait
    ("run_host_ms", (3.45 + 3.4) / 2),
    ("upload_ms", 1.5),
    ("download_ms", 1.5),
    ("vco_scan_host_us", 200.0),
])
def test_reader_takes_the_slice_only(spans, metric, want):
    assert core.reader(metric).read(Ctx()) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["run_host_ms", "upload_ms",
                                    "download_ms", "vco_scan_host_us"])
def test_reader_without_a_run_in_the_slice(spans, metric, monkeypatch):
    from sspslam_tpu_torch.utils import profiling
    # a slice with no pi.run inside it, then a program without spans
    assert core.reader(metric).read(Ctx(3.0, 4.0)) is None
    monkeypatch.delattr(profiling, "spans")
    assert core.reader(metric).read(Ctx()) is None

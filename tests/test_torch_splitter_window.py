"""The general MGKN's splitter, one compiled pass a window
(graph/window_graphs.cpp through ``native.native_window_graphs``),
against the numpy chain it replaces (``radius_connectivity``,
``edge_attributes``, ``build_multilevel_graph``): the same
MultiLevelGraphs, field by field and dtype for dtype, and the same caps.

The cell's own shape: s = 85, points 400/100/25, radii 0.25/0.5/1.0
inner and 0.125/0.25 between levels, 19 windows (the last wraps the
permutation). There r = 0.25 is exactly 21 grid spacings, so pairs at the
boundary decide the edge set. Other level counts and d = 1, 3 at small
shapes. Imports the port only."""
import dataclasses

import numpy as np
import pytest

from graph_pde_tpu_torch.graph import native
from graph_pde_tpu_torch.graph.splitters import RandomMultiMeshSplitter
from graph_pde_tpu_torch.utils import tracing

S = 85
POINTS = [400, 100, 25]
R_INNER = [0.25, 0.5, 1.0]
R_INTER = [0.125, 0.25]


@pytest.fixture(scope="module", autouse=True)
def native_ok():
    if not native.available():
        pytest.skip("no C++ toolchain: the compiled builder is unavailable")


def _refuse(*args, **kwargs):
    raise RuntimeError("window pass refused")


def _fields(seed=1, s=S, d=2):
    rng = np.random.default_rng(seed)
    n = s ** d
    theta_all = rng.normal(size=(n, 4)).astype(np.float32)
    return theta_all[:, 0], theta_all


def _split(monkeypatch, path, caps=None, s=S, d=2, points=POINTS,
           r_inner=R_INNER, r_inter=R_INTER, seed=5):
    """(graphs, caps, recording) of one splitter call on a fresh splitter
    of ``seed``. path: 'native' (the window pass), 'radius' (the numpy
    chain on the compiled radius graphs) or 'nolib' (the library made
    unavailable: the numpy chain on cKDTree)."""
    with monkeypatch.context() as mp:
        if path == "radius":
            mp.setattr(native, "native_window_graphs", _refuse)
        elif path == "nolib":
            mp.setattr(native, "_load", lambda: None)
        sp = RandomMultiMeshSplitter([[0, 1]] * d, [s] * d,
                                     level=len(points),
                                     sample_sizes=points, seed=seed)
        theta_a, theta_all = _fields(s=s, d=d)
        with tracing.recording() as rec:
            graphs, caps = sp.splitter(r_inner, r_inter, theta_a,
                                       theta_all, caps=caps)
    return graphs, caps, rec


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
                assert np.array_equal(a, b), f.name
            else:
                assert a == b, f.name


@pytest.mark.parametrize("caps", ["none", "given", "grown"])
def test_window_pass_matches_numpy_chain(monkeypatch, caps):
    """The cell's 19 windows: caps None, caps above every window's
    edges, and caps below them, which both paths grow alike."""
    given = {"none": None,
             "given": ((32768, 8192, 1024), (2048, 512), (2560, 768)),
             "grown": ((256,) * 3, (256,) * 2, (256,) * 2)}[caps]
    got, got_caps, _ = _split(monkeypatch, "native", given)
    want, want_caps, _ = _split(monkeypatch, "radius", given)
    assert len(got) == -(-S * S // POINTS[0]) == 19
    assert got_caps == want_caps
    assert all(type(c) is int for part in got_caps for c in part)
    if caps == "given":
        assert got_caps == given
    if caps == "grown":
        assert all(g > s for a, b in zip(got_caps, given)
                   for g, s in zip(a, b))
    _equal(got, want)
    # the last window wraps the permutation (its finest level runs past
    # the permutation's end), and the finest levels tile the grid
    assert 19 * POINTS[0] > S * S
    idxs = np.concatenate([g.sample_idx for g in got])
    assert np.array_equal(np.unique(idxs), np.arange(S * S))


def test_pairs_at_exactly_r_fall_alike(monkeypatch):
    """Level-0 pairs 21 grid spacings apart along one axis, at distance
    r = 0.25 up to rounding, are edges in the window pass exactly where
    they are in the numpy chain: where the float64 test
    (x_i - x_j)^2 <= r^2 holds."""
    got, _, _ = _split(monkeypatch, "native")
    want, _, _ = _split(monkeypatch, "radius")
    n0 = POINTS[0]
    grid = np.linspace(0.0, 1.0, S)     # the box grid's axis
    pairs = inside_pairs = 0
    for g, w in zip(got, want):
        lo, hi = g.mid_ranges[0]
        edges = {(s, r) for s, r, m in zip(g.mid_senders[lo:hi],
                                           g.mid_receivers[lo:hi],
                                           g.mid_mask[lo:hi]) if m}
        ref = {(s, r) for s, r, m in zip(w.mid_senders[lo:hi],
                                         w.mid_receivers[lo:hi],
                                         w.mid_mask[lo:hi]) if m}
        idx = g.sample_idx[:n0]
        ij = np.stack([idx % S, idx // S], axis=1)   # grid column, row
        for axis in (0, 1):
            other = 1 - axis
            same = ij[:, None, other] == ij[None, :, other]
            apart = np.abs(ij[:, None, axis] - ij[None, :, axis]) == 21
            for s, r in zip(*np.nonzero(same & apart)):
                diff = grid[ij[s, axis]] - grid[ij[r, axis]]
                inside = diff * diff <= R_INNER[0] * R_INNER[0]
                assert ((s, r) in edges) == ((s, r) in ref) == inside
                pairs += 1
                inside_pairs += int(inside)
    assert pairs > 0
    print(f"{pairs} pairs at 21 spacings, {inside_pairs} of them edges")


@pytest.mark.parametrize("d,s,points,r_inner,r_inter", [
    (2, 16, [24], [0.3], []),
    (2, 16, [24, 12], [0.25, 0.5], [0.2]),
    (2, 20, [40, 20, 10, 5], [0.2, 0.3, 0.5, 1.0], [0.1, 0.2, 0.4]),
    (1, 90, [30, 10], [0.1, 0.3], [0.05]),
    (3, 8, [64, 16, 4], [0.3, 0.5, 1.0], [0.2, 0.4]),
])
def test_window_pass_levels_and_dims(monkeypatch, d, s, points, r_inner,
                                     r_inter):
    """One level to four, and d = 1, 2, 3."""
    kw = dict(s=s, d=d, points=points, r_inner=r_inner, r_inter=r_inter)
    got, got_caps, rec = _split(monkeypatch, "native", **kw)
    want, want_caps, _ = _split(monkeypatch, "radius", **kw)
    assert rec.counters["split_native"] == len(got)
    assert got_caps == want_caps
    _equal(got, want)


def test_fallback_and_counters(monkeypatch):
    """Without the library the splitter gives the same graphs through the
    numpy chain; the counters say which path built each window, and the
    spans are the same on both."""
    got, got_caps, rec = _split(monkeypatch, "native")
    want, want_caps, rec_np = _split(monkeypatch, "nolib")
    windows = len(got)
    assert got_caps == want_caps
    _equal(got, want)
    assert rec.counters.get("split_native") == windows
    assert "split_numpy" not in rec.counters
    assert rec_np.counters.get("split_numpy") == windows
    assert "split_native" not in rec_np.counters
    for r in (rec, rec_np):
        (root,) = [i for i, sp in enumerate(r.spans) if sp[1] is None]
        assert r.spans[root][0] == "split"
        kids = [sp[0] for sp in r.spans if sp[1] == root]
        assert kids == ["split.connect"] * windows + ["split.pad"]


def test_library_hash_covers_both_sources(monkeypatch, tmp_path):
    """An edit to either source names another library."""
    before = native.library_path()
    for k in range(len(native.SOURCES)):
        copies = []
        for j, src in enumerate(native.SOURCES):
            dst = tmp_path / f"{k}-{j}-{src.name}"
            dst.write_bytes(src.read_bytes() + (b"\n" if j == k else b""))
            copies.append(dst)
        monkeypatch.setattr(native, "SOURCES", tuple(copies))
        assert native.library_path() != before


def test_place_refuses_what_the_slot_does_not_hold():
    """A capacity below a list's count, another list count, another
    attribute width or a slot never built raise."""
    sp = RandomMultiMeshSplitter([[0, 1]] * 2, [16, 16], level=2,
                                 sample_sizes=[24, 12], seed=5)
    _, idx_all = sp.sample()
    counts = native.native_window_graphs(
        sp.grid[idx_all], sp.ms, [0.25, 0.5], [0.2],
        np.linspace(0.0, 1.0, 36), slot=0)
    caps = [int(c) for c in counts]
    parks = [24, 12, 36, 36]
    senders, receivers, attr, mask = native.native_place_windows(
        [0], caps, parks, 6)
    assert mask.sum() == counts.sum() and senders.shape == (1, sum(caps))
    for args in (([0], [caps[0] - 1] + caps[1:], parks, 6),
                 ([0], caps[:3], parks[:3], 6),
                 ([0], caps, parks, 8),
                 ([1000], caps, parks, 6)):
        with pytest.raises(RuntimeError):
            native.native_place_windows(*args)

"""The frozen kernel costs and the model FLOP counts against hand
counts at two shapes."""
from __future__ import annotations

import pytest

from benchmark import cost


@pytest.mark.parametrize("layers,e,n,w", [((6, 128, 256, 4096), 1000, 500,
                                           64),
                                          ((6, 16, 32, 256), 77, 33, 16)])
def test_k1_cost(layers, e, n, w):
    a, h1, h2, c = layers
    wbytes = 4 * (a * h1 + h1 + h1 * h2 + h2 + h2 * c + c)
    nbytes = 4 * n * w + 8 * e + 4 * e * a + wbytes + 4 * e * w
    tc = cost.k1_cost(layers, e, n, tc=True, w=w)
    assert tc["flops"] == 2 * e * a * h1 + 2 * e * c
    assert tc["bf16_flops"] == 2 * e * (h1 * h2 + h2 * c)
    assert tc["bytes"] == nbytes
    assert tc["bound_s"] == pytest.approx(max(
        tc["flops"] / 67e12, tc["bf16_flops"] / 989e12, nbytes / 3.35e12))
    simt = cost.k1_cost(layers, e, n, tc=False, w=w)
    assert simt["flops"] == 2 * e * (a * h1 + h1 * h2 + h2 * c) + 2 * e * c
    assert "bf16_flops" not in simt


@pytest.mark.parametrize("kw,c,e,n,w", [(256, 4096, 1000, 500, 64),
                                        (32, 256, 77, 33, 16)])
def test_b1_bwd_cost(kw, c, e, n, w):
    nbytes = (4 * (e * kw + n * w + e * w + kw * c) + 8 * e
              + 4 * (e * w + e * kw + kw * c + c))
    bf = cost.b1_bwd_cost(kw, c, e, n, bf16=True, w=w)
    assert (bf["bf16_flops"], bf["flops"], bf["bytes"]) == (
        6 * e * kw * c, 3 * e * c, nbytes)
    f32 = cost.b1_bwd_cost(kw, c, e, n, bf16=False, w=w)
    assert f32["flops"] == 6 * e * kw * c + 3 * e * c
    assert f32["bound_by"] == "operations"


@pytest.mark.parametrize("w,layers,depth,n,e", [
    (64, (6, 128, 256, 4096), 4, 58081, 1216000),
    (8, (6, 8, 16, 64), 2, 441, 9000)])
def test_gkn_flops(w, layers, depth, n, e):
    f = cost.gkn_forward_flops(6, w, layers, depth, 1, n, e)
    a, h1, h2, c = layers
    assert f["kappa"] == 2 * e * (a * h1 + h1 * h2 + h2 * c)
    assert f["contraction"] == 2 * e * w * w * depth
    assert f["node"] == 2 * n * (6 * w + depth * w * w + w)


@pytest.mark.parametrize("kw,points", [(256, (400, 100, 25)),
                                       (16, (40, 12, 4))])
def test_mgkn_flops(kw, points):
    cfg = {"width": 64, "depth": 5, "ker_in": 6, "in_width": 6,
           "ker_width": kw, "points": list(points)}
    edges = {"mid": [1000, 200, 30], "down": [50, 10], "up": [50, 10]}
    w2 = 64 * 64
    mlp = lambda k, hid: 6 * k + (k * k if hid == 2 else 0) + k * w2
    want = 0.0
    for l, e in enumerate(edges["mid"]):
        want += 2 * e * mlp(kw // 2 ** l, 2) + 2 * e * w2 * 5
    for kind in ("down", "up"):
        for l, e in enumerate(edges[kind]):
            want += 2 * e * mlp(kw // 2 ** (l + 1), 1) + 2 * e * w2 * 5
    want += 2 * sum(points) * w2 * 5 + 2 * sum(points) * 6 * 64
    want += 2 * points[0] * (64 * kw + kw)
    assert cost.mgkn_forward_flops(cfg, edges) == pytest.approx(want,
                                                                rel=1e-12)


def test_min_time_takes_the_longer_unit():
    assert cost.min_time_s(989e12, 0.0) == pytest.approx(1.0)
    assert cost.min_time_s(989e12, 134e12) == pytest.approx(2.0)

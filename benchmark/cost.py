"""The yardstick's arithmetic: published peaks, kernel bounds and model
FLOPs, computed from shapes alone.

``set_bound``, ``k1_cost`` and ``b1_bwd_cost`` are frozen copies of the
arithmetic ``chip_smoke.py`` uses for its kernel table (``set_bound``,
``k1_cost``, the B1-bwd record of ``backward_times``), taking layer
widths instead of parameter tensors. ``gkn_forward_flops`` and
``mgkn_forward_flops`` count a model's useful work on valid edges and
nodes only, whatever implements it: each kappa once a forward (K
depends only on the edge features), the contraction once a conv
application, the node-wise layers. The backward counts twice the
forward.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates: fp32 outside the tensor
# cores, bf16 on the tensor cores, HBM3 bandwidth. They assume the full
# 700 W power limit; the harness prints the card's limit beside them.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def set_bound(r: dict) -> dict:
    """Adds bound_s and bound_by to a record of ``flops`` (fp32 SIMT),
    optional ``bf16_flops`` (tensor cores) and ``bytes``: the larger of
    the bytes over the memory rate and the operations over their type's
    peak (the two kinds of unit run at once, so the operations take the
    longer of the two)."""
    t_ops = max(r.get("flops", 0.0) / PEAK_F32_FLOPS,
                r.get("bf16_flops", 0.0) / PEAK_BF16_FLOPS)
    t_bytes = r["bytes"] / PEAK_BYTES
    r["bound_s"] = max(t_ops, t_bytes)
    r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return r


def _products(layers) -> float:
    return float(sum(a * b for a, b in zip(layers[:-1], layers[1:])))


def k1_cost(layers, e: int, n: int, tc: bool, w: int = 64,
            w_in: int = None) -> dict:
    """K1's operations and bytes on e edges of an n-node graph, kappa
    widths ``layers`` (attr, hidden..., in * out): the MLP's products
    and the contraction, every input read once (x, senders, attr,
    weights), the messages written once. With ``tc`` (the bf16
    tensor-core form) the products after the first layer count as
    ``bf16_flops``; attr @ W0 and the contraction stay fp32."""
    mlp = [2.0 * e * a * b for a, b in zip(layers[:-1], layers[1:])]
    fold = 2.0 * e * layers[-1]
    wbytes = 4 * sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))
    nbytes = (4 * n * (w_in or w) + 8 * e + 4 * e * layers[0] + wbytes
              + 4 * e * w)
    if tc:
        return set_bound(dict(flops=mlp[0] + fold,
                              bf16_flops=sum(mlp[1:]), bytes=nbytes))
    return set_bound(dict(flops=sum(mlp) + fold, bytes=nbytes))


def b1_bwd_cost(kw: int, c: int, e: int, n: int, bf16: bool,
                w: int = 64) -> dict:
    """B1-bwd's operations and bytes: three products of e * kw * c
    multiply-adds (dx through K, dh2, dWl), plus dpre, the dx fold and
    dbl (3 per element of [e, c]); every input read once and every
    output written once. In bf16 mode the products' operands are bf16,
    so their peak is the tensor-core rate."""
    prods, elems = 6.0 * e * kw * c, 3.0 * e * c
    nbytes = (4 * (e * kw + n * w + e * w + kw * c) + 8 * e
              + 4 * (e * w + e * kw + kw * c + c))
    ops = (dict(bf16_flops=prods, flops=elems) if bf16
           else dict(flops=prods + elems))
    return set_bound(dict(bytes=nbytes, **ops))


def gkn_forward_flops(in_width: int, width: int, kernel_layers, depth: int,
                      out_width: int, n: int, e: int) -> dict:
    """A GKN forward on n valid nodes and e valid edges, split by where
    the configuration computes it: ``kappa`` (the kernel MLP, once) and
    ``contraction`` (x_j @ K_e, every depth step) in the compute dtype,
    ``node`` (fc1, the root weight every step, the decoder) in fp32."""
    return {
        "kappa": 2.0 * e * _products(kernel_layers),
        "contraction": 2.0 * e * width * width * depth,
        "node": 2.0 * n * (in_width * width + width * width * depth
                           + width * out_width),
    }


def mgkn_forward_flops(cfg: dict, edges: dict) -> float:
    """A general-MGKN ('mkgn') forward: ``edges`` holds the valid edge
    counts of each conv, {"mid": [e_0, ...], "down": [...], "up":
    [...]}. Each kappa runs once; each conv's contraction once a V-cycle
    (depth times); the root weight of every mid conv; fc_in on every
    node and the two-layer decoder on the finest level."""
    w, depth, ker_in = cfg["width"], cfg["depth"], cfg["ker_in"]
    points = cfg["points"]
    total = 0.0
    for kind, ks in edges.items():
        for l, e in enumerate(ks):
            level = l if kind == "mid" else l + 1
            kw = cfg["ker_width"] // 2 ** level
            hidden = [kw, kw] if kind == "mid" else [kw]
            total += 2.0 * e * _products([ker_in, *hidden, w * w])
            total += 2.0 * e * w * w * depth
    total += 2.0 * sum(points) * w * w * depth          # mid roots
    total += 2.0 * sum(points) * cfg["in_width"] * w
    total += 2.0 * points[0] * (w * cfg["ker_width"] + cfg["ker_width"])
    return total


def min_time_s(bf16_flops: float, f32_flops: float) -> float:
    """The least time the chip needs for these model FLOPs: each kind at
    its own peak, the two kinds of unit running at once."""
    return max(bf16_flops / PEAK_BF16_FLOPS, f32_flops / PEAK_F32_FLOPS)

"""Bounds of the cached-K iteration kernels, K2 (``fused_iterate_total``)
and B2-bwd (``fused_iterate_bwd``), from shapes alone, under
``cost.set_bound``'s convention: the bytes that must move over the
memory rate, against the operations over the fp32 peak. The same counts
as ``chip_smoke.py``'s K2 and B2-bwd records.

On e edges (``valid`` of them unmasked) of an n-node graph, width
w_in -> w_out, C = w_in * w_out and a K element of ``k_bytes``:

- K2 reads each valid edge's K row once, the mask and senders (9 bytes
  an edge), x once (n * w_in floats) and the row pointer (n + 1 int64),
  and writes the n * w_out sums once;
- B2-bwd reads each valid edge's K row once, the mask and receivers,
  the cotangent dtotal once (n * w_out floats), and writes dxj and dmsg
  (e * (w_in + w_out) floats);
- each multiplies every K element read by one value and adds it: 2 FLOPs.
"""
from __future__ import annotations

from .cost import set_bound


def k2_cost(e: int, valid: int, n: int, w_in: int, w_out: int,
            k_bytes: int = 4) -> dict:
    c = w_in * w_out
    return set_bound(dict(
        flops=2.0 * valid * c,
        bytes=(k_bytes * valid * c + 9 * e + 4 * n * w_in + 8 * (n + 1)
               + 4 * n * w_out)))


def b2_bwd_cost(e: int, valid: int, n: int, w_in: int, w_out: int,
                k_bytes: int = 4) -> dict:
    c = w_in * w_out
    return set_bound(dict(
        flops=2.0 * valid * c,
        bytes=(k_bytes * valid * c + 9 * e + 4 * n * w_out
               + 4 * e * (w_in + w_out))))

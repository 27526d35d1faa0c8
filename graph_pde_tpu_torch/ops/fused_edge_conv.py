"""Fused edge messages and their gradient (counterpart of
graph_pde_tpu/ops/pallas_edge_conv.py).

    msg[e, o] = sum_i x[senders[e], i] * kappa(edge_attr[e])[i * out + o]

with kappa the edge-kernel DenseNet. The forward CUDA kernel (``csrc/
fused_edge_conv.cu``, K1) runs the whole MLP and the contraction per tile
of edges, so the [E, in * out] kernel matrices never reach device memory.
It has three forms, picked by ``k1_form``: on the GKN shapes in bf16 its
MLP products run on the tensor cores ('tc'), in float32 (and on
single-launch shapes the tensor-core tiles do not take) on the fp32 SIMT
units ('simt'), and a general form takes every other shape the JAX gate
admits (see the source).

``fused_edge_messages`` is a ``torch.autograd.Function``, as the JAX
version is a ``custom_vjp``. The backward recomputes the small kappa
layers in float32 with torch matmuls, runs the backward kernel (``csrc/
fused_edge_conv_bwd.cu``, B1-bwd) for the last layer and the contraction
(dx_src, dh2, dWl, dbl; neither [E, in * out] intermediate reaches
device memory) in the form ``b1_bwd_form`` picks by shape and compute
dtype (bf16 tensor cores for the GKN kappas in bf16, else fp32 SIMT
units), adds the last bias's term g @ b_mat^T, backprops the
small layers with torch matmuls, and scatter-adds dx_src onto the
senders. The same Function runs on both devices: CUDA tensors launch the
kernels (or raise, never falling back), CPU tensors take the plain
PyTorch versions ``edge_messages_plain`` and ``edge_messages_bwd_plain``.
K1's SIMT and general forms and B1-bwd's SIMT form spread a call with
few edges (the multipole levels) over every SM, on grids that
``k1_simt_groups`` (clusters of blocks over channel pairs, summed
through distributed shared memory), ``k1_general_groups`` and
``b1_bwd_simt_grid`` pick from the edge count and the card.

``compute_dtype='bfloat16'`` rounds as the JAX kernels do. Forward: GEMM
operands are bf16 with fp32 accumulation, biases stay fp32, and each
K * x product is rounded to bf16 before the sum over i. Backward (the
merged o-major kernel): the operands of h2 @ Wl, dpre @ Wl^T and
h2^T @ dpre are bf16, dpre = bf16(x) * g is kept in fp32 for dbl, and
g and the dx sums stay fp32.

The JAX kernel's selector GEMMs, o/i-major layouts, resident/streamed Wl
split and VMEM fit gates work around Mosaic and have no counterpart here.
"""
from __future__ import annotations

import ctypes

import torch

from .dense import flatten_params, layer_dims, unflatten_params
from . import kernels

C_CHUNK = 1024          # the JAX gate's column chunk
_MAX_SHARED = 232448    # bytes of shared memory one block may use
_PLAIN_CHUNK = 32768    # edges per step of the plain version
_SCRATCH_ELEMS = 1 << 26  # floats per small-activation buffer, general form
_PART_ELEMS = 1 << 24   # floats per partial-sum buffer (64 MiB), see _split
_TILE = 128             # edges of a block tile; columns of a K tile
_SLAB = 16              # depth of one staged slab of the SIMT kernels
# resident blocks an SM of K1 general's last-layer kernel and B1-bwd's
# SIMT product kernels (__launch_bounds__(256, 2), 128 registers)
_RESIDENT = 2


def fused_path_supported(kernel_params, in_channels: int,
                         out_channels: int) -> bool:
    """The JAX package's fused-path gate (pallas_edge_conv.py:61-73).
    The CUDA kernel takes every shape it admits."""
    dims = layer_dims(kernel_params)
    c = in_channels * out_channels
    if dims[-1][1] != c:
        return False
    chunk = min(C_CHUNK, c)
    if c % chunk != 0 or chunk % out_channels != 0:
        return False
    return dims[-1][0] <= 2048


def kernel_shape_supported(dims, in_channels: int, out_channels: int) -> bool:
    """Shapes the kernel's single-launch form takes: two small ReLU
    layers, attr width <= 16, kw1 % 16 == 0, kw2 % 128 == 0,
    out_channels == 64, an even in_channels, and a tile that fits shared
    memory. Other shapes take its general form."""
    if len(dims) != 3 or dims[-1][1] != in_channels * out_channels:
        return False
    (a_dim, kw1), (kw1b, kw2), (kw2b, _) = dims
    smem = 4 * (128 * (kw2 + max(kw1, in_channels)) + 2 * 16 * 128)
    return (kw1 == kw1b and kw2 == kw2b and a_dim <= 16
            and kw1 % 16 == 0 and kw2 % 128 == 0 and out_channels == 64
            and in_channels % 2 == 0 and smem <= _MAX_SHARED)


# the tensor-core form holds h1 as wgmma fragments in registers, so kw1
# <= 128 (tc::MAX_KW1 in csrc/fused_edge_conv.cu, whose entry point also
# refuses shapes whose shared memory would not fit)
_K1_TC_MAX_KW1 = 128


def k1_form(dims, in_channels: int, out_channels: int, compute_dtype) -> str:
    """The K1 kernel form a shape takes: 'tc' (bf16 tensor cores) for
    compute_dtype='bfloat16' on the single-launch shapes
    (``kernel_shape_supported``: out 64, kw1 % 16 == 0, kw2 % 128 == 0)
    with kw1 <= 128; 'simt' (fp32 FMAs) for the other single-launch
    shapes, float32 among them; 'general' for every other shape."""
    if not kernel_shape_supported(dims, in_channels, out_channels):
        return "general"
    if _is_bf16(compute_dtype) and dims[0][1] <= _K1_TC_MAX_KW1:
        return "tc"
    return "simt"


def _is_bf16(compute_dtype) -> bool:
    return compute_dtype in ("bfloat16", torch.bfloat16)


def _rounder(compute_dtype):
    if _is_bf16(compute_dtype):
        return lambda t: t.to(torch.bfloat16).to(torch.float32)
    return lambda t: t


def edge_messages_plain(x, senders, edge_attr, kernel_params, *,
                        in_channels: int, out_channels: int,
                        compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [E, out] float32 messages,
    computed in edge chunks so that K exists one chunk at a time."""
    rnd = _rounder(compute_dtype)
    small, last = kernel_params[:-1], kernel_params[-1]
    wl, bl = rnd(last["w"]), last["b"]
    ws = [(rnd(p["w"]), p["b"]) for p in small]
    e = senders.shape[0]
    out = torch.empty((e, out_channels), dtype=torch.float32,
                      device=x.device)
    for s0 in range(0, e, _PLAIN_CHUNK):
        s1 = min(e, s0 + _PLAIN_CHUNK)
        h = edge_attr[s0:s1]
        for w, b in ws:
            h = torch.relu(rnd(h) @ w + b)
        k = (rnd(h) @ wl + bl).view(s1 - s0, in_channels, out_channels)
        xs = rnd(x.index_select(0, senders[s0:s1]))
        out[s0:s1] = rnd(k * xs[:, :, None]).sum(dim=1)
    return out


def edge_messages_bwd_plain(x, senders, h2, g, wl, *, in_channels: int,
                            out_channels: int, compute_dtype=None):
    """Plain PyTorch version of the backward kernel, in edge chunks:
    (dx_src [E, in], dh2 [E, kw], dWl [kw, in * out], dbl [in * out]),
    all float32, from the last hidden activations h2 [E, kw], the
    messages' cotangent g [E, out] and the last weight Wl. dx_src holds
    the h2 @ Wl term only (no bias)."""
    rnd = _rounder(compute_dtype)
    e, kw = h2.shape
    c = in_channels * out_channels
    wlr = rnd(wl)
    dev = h2.device
    dx_src = torch.empty((e, in_channels), dtype=torch.float32, device=dev)
    dh2 = torch.empty((e, kw), dtype=torch.float32, device=dev)
    dwl = torch.zeros((kw, c), dtype=torch.float32, device=dev)
    dbl = torch.zeros((c,), dtype=torch.float32, device=dev)
    for s0 in range(0, e, _PLAIN_CHUNK):
        s1 = min(e, s0 + _PLAIN_CHUNK)
        h2c, gc = rnd(h2[s0:s1]), g[s0:s1]
        h3 = (h2c @ wlr).view(s1 - s0, in_channels, out_channels)
        dx_src[s0:s1] = torch.einsum("eio,eo->ei", h3, gc)
        xs = rnd(x.index_select(0, senders[s0:s1]))
        dpre = (xs[:, :, None] * gc[:, None, :]).reshape(s1 - s0, c)
        dpre_r = rnd(dpre)
        dh2[s0:s1] = dpre_r @ wlr.T
        dwl += h2c.T @ dpre_r
        dbl += dpre.sum(dim=0)
    return dx_src, dh2, dwl, dbl


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_FAST_ARGS = [_P] * 10 + [_I64] + [_I] * 7 + [_P]
_TC_FWD_ARGS = [_P] * 10 + [_I64, _I, _I, _I, _I, _P]
_DENSE_ARGS = [_P, _I64, _I, _P, _P, _I, _P, _I, _P]
_LAST_ARGS = [_P, _I64, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_MAX_CLUSTER = 16       # blocks a K1 SIMT cluster (csrc MAX_CLUSTER)
_clusters_seen = {}     # (device, kw1, kw2, in, rb) -> {G: clusters}


def k1_simt_clusters(dims, in_channels: int, rb: int, device) -> dict:
    """{G: clusters of G blocks the card keeps resident at once} of K1's
    SIMT form at the kappa ``dims`` and ``in_channels``, for G = 1 ..
    min(16, in_channels // 2), as cudaOccupancyMaxActiveClusters on
    ``device`` reports them; asked once per device and shape."""
    kw1, kw2 = dims[0][1], dims[1][1]
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    key = (index, kw1, kw2, in_channels, rb)
    if key not in _clusters_seen:
        most = max(1, min(_MAX_CLUSTER, in_channels // 2))
        out = (ctypes.c_int * most)()
        fn = kernels.fn("fused_edge_conv", "gpde_edge_messages_clusters",
                        [_I, _I, _I, _I, _I, _P])
        with torch.cuda.device(index):
            kernels.check(fn(kw1, kw2, in_channels, rb, most, out),
                          "K1 SIMT cluster occupancy")
        _clusters_seen[key] = {g + 1: out[g] for g in range(most)}
    return _clusters_seen[key]


def k1_simt_groups(e: int, in_ch: int, sms: int, clusters):
    """(G, per) of K1's SIMT form on ``e`` edges: clusters of G blocks a
    128-edge tile, each block ``per`` of the in_ch // 2 channel pairs
    (the last the rest). ``clusters[G]`` is the clusters of G blocks the
    card keeps resident (``k1_simt_clusters``); G runs up to the largest
    with one resident, and up to the pairs. G = 1 where the tiles alone
    fill the card twice (one block an SM on ``sms`` SMs). Else, among G
    up to the fewest whose grid reaches two waves of resident clusters,
    the G whose waves x pairs a block is least (a block's time is about
    its pairs, and a cluster takes one resident slot a wave), the fewest
    G of equal cost: fewer blocks recompute the h2 tile less. Only G
    that split the pairs into G non-empty runs are taken."""
    tiles = -(-e // _TILE)
    pairs = max(1, in_ch // 2)
    if tiles >= 2 * sms:
        return 1, pairs
    runs = [g for g in range(1, pairs + 1)
            if clusters.get(g, 0) >= 1 and -(-pairs // -(-pairs // g)) == g]
    if not runs:
        raise ValueError("the card keeps no K1 SIMT block resident")
    two = next((g for g in runs if tiles >= 2 * clusters[g]), runs[-1])
    groups = min((g for g in runs if g <= two),
                 key=lambda g: (-(-tiles // clusters[g]) * -(-pairs // g), g))
    return groups, -(-pairs // groups)


def _launch_fast(x, senders, edge_attr, weights, msg, dims, in_channels,
                 rb, stream, groups=None) -> int:
    """The SIMT form on the grid ``k1_simt_groups`` picks, or with
    ``groups`` blocks a cluster where given (each ceil(pairs / groups)
    pairs; the kernel refuses a count that leaves a block none)."""
    ptrs = [x, senders, edge_attr, *weights, msg]
    if any(t.data_ptr() % 16 for t in ptrs):
        raise ValueError("edge-message kernel needs 16-byte aligned tensors")
    e, pairs = senders.shape[0], in_channels // 2
    if groups is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        groups, per = k1_simt_groups(
            e, in_channels, sms,
            k1_simt_clusters(dims, in_channels, rb, x.device))
    else:
        per = -(-pairs // max(1, groups))
    fn = kernels.fn("fused_edge_conv", "gpde_edge_messages", _FAST_ARGS)
    return fn(*[t.data_ptr() for t in ptrs], e, in_channels, dims[0][0],
              dims[0][1], dims[1][1], groups, per, rb, stream)


def simt_edge_messages(x, senders, edge_attr, kernel_params, *,
                       in_channels: int, compute_dtype=None,
                       groups=None) -> torch.Tensor:
    """K1's SIMT form on CUDA tensors whatever form ``k1_form`` picks
    (in bf16 the tensor-core form's predecessor), on the grid
    ``k1_simt_groups`` picks or with ``groups`` blocks a cluster: for
    holding one form or grid against another on the card. Not counted,
    not differentiable; raises where the kernel refuses the shape or the
    grid."""
    dims = layer_dims(kernel_params)
    if not kernel_shape_supported(dims, in_channels, 64):
        raise ValueError("not a shape of K1's SIMT form")
    weights = [t.contiguous() for t in flatten_params(kernel_params)]
    x, senders = x.contiguous(), senders.contiguous()
    edge_attr = edge_attr.contiguous()
    msg = torch.empty((senders.shape[0], 64), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launch_fast(x, senders, edge_attr, weights, msg, dims,
                           in_channels, int(_is_bf16(compute_dtype)), stream,
                           groups)
    kernels.check(err, "K1 SIMT form launch")
    return msg


def _launch_tc(x, senders, edge_attr, weights, msg, dims, in_channels,
               stream) -> int:
    """The tensor-core form: bf16 W1^T and Wl^T, cast once per call."""
    w0, b0, w1, b1, wl, bl = weights
    w1t = w1.to(torch.bfloat16).t().contiguous()
    wlt = wl.to(torch.bfloat16).t().contiguous()
    ptrs = [x, senders, edge_attr, w0, b0, w1t, b1, wlt, bl, msg]
    if any(t.data_ptr() % 16 for t in ptrs):
        raise ValueError("edge-message kernel needs 16-byte aligned tensors")
    fn = kernels.fn("fused_edge_conv", "gpde_edge_messages_tc", _TC_FWD_ARGS)
    return fn(*[t.data_ptr() for t in ptrs], senders.shape[0], in_channels,
              dims[0][0], dims[0][1], dims[1][1], stream)


def k1_tc_occupancy(kw2: int, in_channels: int):
    """(dynamic shared memory bytes a block, resident blocks an SM) of
    the tensor-core form at (kw2, in_channels), as the current CUDA
    device reports them."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    fn = kernels.fn("fused_edge_conv", "gpde_edge_messages_tc_occupancy",
                    [_I, _I, _P, _P])
    kernels.check(fn(kw2, in_channels, ctypes.byref(smem),
                     ctypes.byref(blocks)), "K1 tc occupancy")
    return smem.value, blocks.value


def _split(units: int, blocks: int, sms: int, cap: int):
    """(per, groups): ``units`` (K tiles, channels, slabs) cut into
    ``groups`` contiguous runs of ``per`` (the last may be shorter) for
    a grid of ``blocks`` blocks a group. The fewest groups whose grid
    reaches two waves of _RESIDENT blocks on each of ``sms`` SMs, at
    most ``cap`` and ``units`` of them; one where ``blocks`` alone
    reach it."""
    want = -(-2 * _RESIDENT * sms // max(1, blocks))
    most = max(1, min(cap, units))
    g = min(want, most)
    if g <= 1 or blocks == 0:
        return units, 1
    per = -(-units // g)
    # equal runs can fall short of g groups: one less a run reaches
    # `want` (per - 1 < units / (want - 1)), if the cap allows it
    if per > 1 and -(-units // per) < want and -(-units // (per - 1)) <= most:
        per -= 1
    return per, -(-units // per)


def k1_general_groups(e: int, in_ch: int, out_ch: int, sms: int):
    """(G, per) of K1 general's last-layer kernel on ``e`` edges and a
    card of ``sms`` SMs: G groups of ``per`` input channels, each group
    whole K tiles (a tile holds 128 // ow channels, ow = out_ch rounded
    up to a power of two, at most 128), so that the grid (edge tiles, G,
    output tiles) reaches two waves where the tiles allow (``_split``).
    The G partial messages take G * e * out_ch floats, at most
    _PART_ELEMS; G = 1 writes the messages directly."""
    ow = 1
    while ow < out_ch and ow < _TILE:
        ow *= 2
    p = _TILE // ow
    blocks = -(-e // _TILE) * -(-out_ch // _TILE)
    per, groups = _split(-(-in_ch // p), blocks, sms,
                         _PART_ELEMS // max(1, e * out_ch))
    return groups, per * p


def _launch_general(x, senders, edge_attr, weights, msg, in_channels,
                    out_channels, rb, stream) -> int:
    """Per chunk of edges: one dense_relu launch per small layer (the
    activations live in a scratch buffer), then the last layer and the
    contraction in one launch over the channel groups that
    ``k1_general_groups`` picks (and, with several, their sum)."""
    dense = kernels.fn("fused_edge_conv", "gpde_dense_relu", _DENSE_ARGS)
    last = kernels.fn("fused_edge_conv", "gpde_last_contract",
                      _LAST_ARGS)
    small = [(weights[2 * j], weights[2 * j + 1])
             for j in range(len(weights) // 2 - 1)]
    wl, bl = weights[-2], weights[-1]
    e = senders.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    widest = max([w.shape[1] for w, _ in small], default=1)
    chunk = max(128, _SCRATCH_ELEMS // widest // 128 * 128)
    for s0 in range(0, e, chunk):
        s1 = min(e, s0 + chunk)
        h = edge_attr[s0:s1]
        for w, b in small:
            nxt = torch.empty((s1 - s0, w.shape[1]), dtype=torch.float32,
                              device=x.device)
            err = dense(h.data_ptr(), s1 - s0, w.shape[0], w.data_ptr(),
                        b.data_ptr(), w.shape[1], nxt.data_ptr(), rb, stream)
            if err:
                return err
            h = nxt
        groups, per = k1_general_groups(s1 - s0, in_channels, out_channels,
                                        sms)
        part = None
        if groups > 1:
            part = torch.empty((groups, s1 - s0, out_channels),
                               dtype=torch.float32, device=x.device)
        err = last(h.data_ptr(), s1 - s0, wl.shape[0], wl.data_ptr(),
                   bl.data_ptr(), x.data_ptr(), senders[s0:s1].data_ptr(),
                   msg[s0:s1].data_ptr(),
                   None if part is None else part.data_ptr(), in_channels,
                   out_channels, per, rb, stream)
        if err:
            return err
    return 0


def _launch(x, senders, edge_attr, weights, in_channels,
            out_channels, compute_dtype) -> torch.Tensor:
    dims = layer_dims(unflatten_params(weights))
    dev = x.device
    for t in [x, edge_attr, *weights]:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("edge-message kernel takes float32 tensors on "
                             "one CUDA device")
    if senders.device != dev or senders.dtype != torch.int64:
        raise ValueError("senders must be int64 on the features' device")
    x, edge_attr = x.contiguous(), edge_attr.contiguous()
    weights = [t.contiguous() for t in weights]
    senders = senders.contiguous()
    if (x.shape[1] != in_channels or edge_attr.shape[0] != senders.shape[0]
            or edge_attr.shape[1] != dims[0][0]):
        raise ValueError("x / edge_attr / senders shapes disagree")
    msg = torch.empty((senders.shape[0], out_channels), dtype=torch.float32,
                      device=dev)
    rb = int(_is_bf16(compute_dtype))
    form = k1_form(dims, in_channels, out_channels, compute_dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if form == "tc":
            err = _launch_tc(x, senders, edge_attr, weights, msg, dims,
                             in_channels, stream)
        elif form == "simt":
            err = _launch_fast(x, senders, edge_attr, weights, msg, dims,
                               in_channels, rb, stream)
        else:
            err = _launch_general(x, senders, edge_attr, weights, msg,
                                  in_channels, out_channels, rb, stream)
    kernels.check(err, "edge-message kernel launch")
    fused_edge_messages.launches += 1
    attr = f"{form}_launches"
    setattr(fused_edge_messages, attr, getattr(fused_edge_messages, attr) + 1)
    return msg


_BWD_ARGS = [_P] * 12 + [_I64] + [_I] * 8 + [_P]
_BWD_TC_ARGS = [_P] * 12 + [_I64, _I, _I, _I, _I, _P]


def bwd_splits(e: int, kw: int, c: int, sms: int):
    """(dWl splits, dbl splits) of the backward kernel on a card with
    ``sms`` multiprocessors: as many dWl partial slabs as keep the split-K
    grid at or under four waves of two blocks per SM (a whole number of
    waves where the tiles divide it), each over at least 1024 edges; and
    one dbl partial row per 4096 edges."""
    tiles = -(-kw // 128) * -(-c // 128)
    splits = max(1, min(32, 8 * sms // tiles, -(-e // 1024)))
    return splits, max(1, -(-e // 4096))


def b1_bwd_tc_splits(e: int, kw: int, c: int, sms: int) -> int:
    """dWl splits of B1-bwd's tensor-core form on a card with ``sms``
    multiprocessors: its dw kernel runs one block an SM over 128 x 256
    tiles of dWl, so as many edge ranges as keep the grid at or under
    four waves, no more than one per 1024 edges, at most 32."""
    tiles = -(-kw // 128) * -(-c // 256)
    return max(1, min(32, 4 * sms // tiles, -(-e // 1024)))


def b1_bwd_simt_grid(e: int, kw: int, in_ch: int, out_ch: int, sms: int):
    """(Gx, x_per, S, depth) of B1-bwd's SIMT form on ``e`` edges and a
    card of ``sms`` SMs, each grid chosen by ``_split``: the dx kernel's
    Gx groups of ``x_per`` input channels (a multiple of 128 // out_ch,
    or of one where out_ch > 128: whole 128-column tiles where out_ch
    divides 128), over the edge tiles; the dh kernel's S splits of the
    depth C = in_ch *
    out_ch into runs of ``depth`` (whole 16-deep slabs), over the edge
    tiles times the 128-column tiles of kw. The S partial slabs take S *
    e * kw floats, at most _PART_ELEMS; S = 1 writes dh2 directly."""
    et = -(-e // _TILE)
    q = max(1, _TILE // out_ch)
    per_x, gx = _split(-(-in_ch // q), et, sms, in_ch)
    per_h, s = _split(-(-in_ch * out_ch // _SLAB), et * -(-kw // _TILE), sms,
                      _PART_ELEMS // max(1, e * kw))
    return gx, per_x * q, s, per_h * _SLAB


# the tensor-core form's tile columns and in_channels bound (tc::BN and
# tc::MAX_IN in csrc/fused_edge_conv_bwd.cu, which asserts that the bound
# fits shared memory and refuses wider shapes)
_TC_COLS = 128
_TC_MAX_IN = 256


def b1_bwd_form(kw: int, in_channels: int, out_channels: int,
                compute_dtype) -> str:
    """The B1-bwd kernel form a shape takes: 'tc' (bf16 tensor cores)
    for compute_dtype='bfloat16' where kw % 8 == 0, out % 8 == 0, out
    divides 128 (a 128-column tile holds whole channels), in * out % 128
    == 0 and in <= 256 (the tile's g and x fit shared memory); else
    'simt' (fp32 FMAs, bit for bit the float32 form's arithmetic)."""
    c = in_channels * out_channels
    if (_is_bf16(compute_dtype) and kw % 8 == 0 and out_channels % 8 == 0
            and _TC_COLS % out_channels == 0 and c % _TC_COLS == 0
            and in_channels <= _TC_MAX_IN):
        return "tc"
    return "simt"


def _launch_bwd(x, senders, h2, g, wl, in_channels, out_channels,
                compute_dtype):
    dev = x.device
    for t in (x, h2, g, wl):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError("edge-message backward kernel takes float32 "
                             "tensors on one CUDA device")
    if senders.device != dev or senders.dtype != torch.int64:
        raise ValueError("senders must be int64 on the features' device")
    e, kw = h2.shape
    c = in_channels * out_channels
    if (x.shape[1] != in_channels or senders.shape != (e,)
            or g.shape != (e, out_channels) or wl.shape != (kw, c)):
        raise ValueError("x / senders / h2 / g / Wl shapes disagree")
    if c >= 2 ** 31:
        raise ValueError("edge-message backward kernel takes in * out "
                         "< 2^31")
    x, senders, h2, g, wl = (t.contiguous() for t in (x, senders, h2, g, wl))
    if any(t.data_ptr() % 16 for t in (x, h2, g, wl)):
        raise ValueError("edge-message backward kernel needs 16-byte "
                         "aligned tensors")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    form = b1_bwd_form(kw, in_channels, out_channels, compute_dtype)
    if form == "tc":
        splits = b1_bwd_tc_splits(e, kw, c, sms)
    else:
        splits, dbl_splits = bwd_splits(e, kw, c, sms)

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dh2, dwl, dbl = new(e, kw), new(kw, c), new(c)
    part_w = new(splits, kw, c)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if form == "tc":
            # bf16 operands, rounded to nearest even once per call; the
            # senders are read by TMA, which wants 16-byte alignment
            h2b, wlb = h2.to(torch.bfloat16), wl.to(torch.bfloat16)
            wlt = wlb.t().contiguous()
            if senders.data_ptr() % 16:
                senders = senders.clone()
            dx_src, part_b = new(e, in_channels), new(splits, c)
            fn = kernels.fn("fused_edge_conv_bwd", "gpde_edge_messages_bwd_tc",
                            _BWD_TC_ARGS)
            err = fn(*[t.data_ptr() for t in (h2b, wlt, wlb, x, senders, g,
                                              dx_src, dh2, dwl, dbl, part_w,
                                              part_b)],
                     e, kw, in_channels, out_channels, splits, stream)
        else:
            gx, x_per, hs, depth = b1_bwd_simt_grid(e, kw, in_channels,
                                                    out_channels, sms)
            dx_src, part_b = new(e, in_channels), new(dbl_splits, c)
            part_h = new(hs, e, kw) if hs > 1 else None
            fn = kernels.fn("fused_edge_conv_bwd", "gpde_edge_messages_bwd",
                            _BWD_ARGS)
            err = fn(*[t.data_ptr() for t in (h2, x, senders, g, wl, dx_src,
                                              dh2, dwl, dbl, part_w, part_b)],
                     None if part_h is None else part_h.data_ptr(), e, kw,
                     in_channels, out_channels, splits, dbl_splits, x_per,
                     depth, int(_is_bf16(compute_dtype)), stream)
    kernels.check(err, "edge-message backward kernel launch")
    fused_edge_messages_bwd.launches += 1
    attr = f"{form}_launches"
    setattr(fused_edge_messages_bwd, attr,
            getattr(fused_edge_messages_bwd, attr) + 1)
    return dx_src, dh2, dwl, dbl


def fused_edge_messages_bwd(x, senders, h2, g, wl, *, in_channels: int,
                            out_channels: int, compute_dtype=None):
    """The backward of the last kappa layer and the contraction:
    (dx_src, dh2, dWl, dbl) as ``edge_messages_bwd_plain`` defines them.

    CUDA tensors launch the B1-bwd kernel in the form ``b1_bwd_form``
    picks (counted in ``fused_edge_messages_bwd.launches`` and in
    ``tc_launches`` or ``simt_launches``); CPU tensors take the plain
    version."""
    if x.is_cuda:
        return _launch_bwd(x, senders, h2, g, wl, in_channels, out_channels,
                           compute_dtype)
    return edge_messages_bwd_plain(x, senders, h2, g, wl,
                                   in_channels=in_channels,
                                   out_channels=out_channels,
                                   compute_dtype=compute_dtype)


fused_edge_messages_bwd.launches = 0
fused_edge_messages_bwd.tc_launches = 0
fused_edge_messages_bwd.simt_launches = 0


class _FusedEdgeMessages(torch.autograd.Function):
    """msg = x[senders] @ kappa(edge_attr), with the JAX custom_vjp's
    backward (pallas_edge_conv.py:826-857). ``weights`` is the kappa
    DenseNet flattened as (w0, b0, w1, b1, ..., Wl, bl)."""

    @staticmethod
    def forward(ctx, x, senders, edge_attr, in_channels, out_channels,
                compute_dtype, *weights):
        ctx.save_for_backward(x, senders, edge_attr, *weights)
        ctx.shape = (in_channels, out_channels, compute_dtype)
        if x.is_cuda:
            return _launch(x, senders, edge_attr, weights, in_channels,
                           out_channels, compute_dtype)
        return edge_messages_plain(x, senders, edge_attr,
                                   unflatten_params(weights),
                                   in_channels=in_channels,
                                   out_channels=out_channels,
                                   compute_dtype=compute_dtype)

    @staticmethod
    def backward(ctx, g):
        x, senders, attr, *weights = ctx.saved_tensors
        in_channels, out_channels, compute_dtype = ctx.shape
        n_small = len(weights) // 2 - 1
        # the small layers, recomputed in float32 (as the JAX backward
        # does, whatever the compute dtype)
        hs = [attr]
        for j in range(n_small):
            hs.append(torch.relu(hs[-1] @ weights[2 * j]
                                 + weights[2 * j + 1]))
        g = g.contiguous().to(torch.float32)
        wl, bl = weights[-2], weights[-1]
        dx_src, dcur, dwl, dbl = fused_edge_messages_bwd(
            x, senders, hs[-1], g, wl, in_channels=in_channels,
            out_channels=out_channels, compute_dtype=compute_dtype)
        # K = h2 @ Wl + bl: the bias's share of dx_src
        dx_src = dx_src + g @ bl.view(in_channels, out_channels).T
        grads = [None] * len(weights)
        grads[-2], grads[-1] = dwl, dbl
        for j in reversed(range(n_small)):
            dpre = dcur * (hs[j + 1] > 0)
            grads[2 * j] = hs[j].T @ dpre
            grads[2 * j + 1] = dpre.sum(dim=0)
            dcur = dpre @ weights[2 * j].T
        dx = None
        if ctx.needs_input_grad[0]:
            dx = torch.zeros_like(x).index_add_(0, senders, dx_src)
        dattr = dcur if ctx.needs_input_grad[2] else None
        return (dx, None, dattr, None, None, None, *grads)


def fused_edge_messages(x, senders, edge_attr, kernel_params, *,
                        in_channels: int, out_channels: int,
                        compute_dtype=None) -> torch.Tensor:
    """[E, out] float32 messages x[senders] @ kappa(edge_attr), fused,
    differentiable in x, edge_attr and every kappa parameter.

    CUDA tensors launch the K1 kernel in the form ``k1_form`` picks
    (counted in ``fused_edge_messages.launches``, once per call, and in
    ``tc_launches``, ``simt_launches`` or ``general_launches``) and,
    in the backward, the B1-bwd kernel; CPU tensors take the plain
    versions."""
    if not fused_path_supported(kernel_params, in_channels, out_channels):
        raise ValueError("fused path unsupported for this kernel shape; "
                         "use impl='scan'")
    return _FusedEdgeMessages.apply(x, senders, edge_attr, in_channels,
                                    out_channels, compute_dtype,
                                    *flatten_params(kernel_params))


fused_edge_messages.launches = 0
fused_edge_messages.tc_launches = 0
fused_edge_messages.simt_launches = 0
fused_edge_messages.general_launches = 0

__all__ = ["fused_edge_messages", "edge_messages_plain",
           "fused_edge_messages_bwd", "edge_messages_bwd_plain",
           "fused_path_supported", "kernel_shape_supported", "bwd_splits",
           "b1_bwd_tc_splits", "b1_bwd_form", "b1_bwd_simt_grid", "k1_form",
           "k1_general_groups",
           "k1_simt_groups", "k1_simt_clusters", "simt_edge_messages",
           "C_CHUNK"]

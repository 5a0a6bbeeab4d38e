"""The one-pass RMSNorm backward (``csrc/rmsnorm.cu``: ``rmsnorm_bwd_kernel``
or ``rmsnorm_bwd_wide_kernel``, then ``rmsnorm_dscale_sum_kernel``)
repeated in numpy, operation by operation and in the kernels' order, for
the CPU tests and for the card's test that the kernels meet it. No jax,
no torch.

The kernel pins every float operation (``__fmul_rn``, ``__fadd_rn``,
``__fdiv_rn``, ``__fsqrt_rn``, ``fmaf``), so each is one numpy f32
operation here; a fused multiply-add is the f64 product (exact for f32
operands) plus the addend, rounded to f32 (it can differ from the card's
single rounding in a double-rounding tie, which f32 data all but never
meets). The geometry comes from ``plan`` (the kernel's own choice, given
the clusters the card holds at once), or from the card's launch itself
(``rmsnorm_bwd(..., plan=[])``).

What is summed in which order, with r = 1 / sqrt(sum(x²)/D + eps):
- a row's sum(x²) and sum((dy·scale)·x): each of G lanes over its packs
  lane, lane + G, ... (V elements a pack, in order), then a butterfly over
  the lanes (G ≤ 32), or over a warp's 32 lanes and the 8 warps in order
  (G = 256);
- dscale: each (block, row group, column) over the block's runs of rows
  in order (run u = block + i·grid, its row u·(256/G) + group), acc =
  fma(dy, x·r, acc); the row groups in a tree (group g + h into g, h = 8,
  4, 2, 1 for 16 groups); the 8 blocks of a cluster in rank order; then,
  in the second launch, the clusters' partials j = ty, ty + 8, ... in
  order for each warp ty of 8, and the 8 sums in warp order.
"""
from __future__ import annotations

import numpy as np

f32, f64 = np.float32, np.float64
THREADS = 256
CLUSTER = 8
WARP_ROWS_MAX_D = 1024      # csrc/rmsnorm.cu: kWarpRowsMaxD (the pair)
LANE_ROWS_MAX_D = 512       # kLaneRowsMaxD (one tensor, 16-byte packs)
LANE_ROWS_MAX_D1 = 128      # kLaneRowsMaxD1 (one element a pack)
REG_MAX_D = 8192            # kRegMaxD: wider rows are reread for dx
WIDE_BLOCKS_PER_SM = 2      # kWideBlocksPerSM


def fma(a, b, c):
    return (np.asarray(a, f64) * np.asarray(b, f64)
            + np.asarray(c, f64)).astype(f32)


def plan(rows: int, D: int, itemsize: int, vec: bool = True,
         pair: bool = False, clusters: int = 32, sms: int = 132) -> dict:
    """The launch's geometry as the kernel chooses it for ``rows`` rows (of
    the pair together) of width D: V elements a pack (1 unless vec and D a
    multiple of 16 bytes), G lanes a row (16 or 32 for the pair's rows and
    a single tensor's up to LANE_ROWS_MAX_D, or LANE_ROWS_MAX_D1 with one
    element a pack; else 256), the grid (as few whole clusters of 8, at
    most ``clusters``, as give each block the fewest runs of 256/G rows;
    on the card ``clusters`` is as many as it holds at once), and whether
    the row is reread for dx (D > REG_MAX_D, at most WIDE_BLOCKS_PER_SM
    blocks of ``sms`` SMs)."""
    V = 16 // itemsize
    V = V if vec and D % V == 0 else 1
    lanes_max = WARP_ROWS_MAX_D if pair else (
        LANE_ROWS_MAX_D if V > 1 else LANE_ROWS_MAX_D1)
    G = (16 if V > 1 and D // V <= 16 else 32) if D <= lanes_max else THREADS
    reread = D > REG_MAX_D
    if reread:
        clusters = sms * WIDE_BLOCKS_PER_SM // CLUSTER
    units = -(-rows // (THREADS // G))
    runs = -(-units // (CLUSTER * max(1, clusters)))    # runs a block
    grid = CLUSTER * -(-(-(-units // runs)) // CLUSTER)
    return dict(V=V, G=G, grid=grid, reread=reread)


def _lane_sum(v, G: int):
    """The butterfly over G lanes (axis -1), every lane ending with the same
    value; for G = 256, over each warp's 32 lanes, then the 8 warps'
    sums in order. Returns the row's sum (lane 0's)."""
    n = min(G, 32)
    v = v.reshape(*v.shape[:-1], G // n, n)
    idx = np.arange(n)
    o = n // 2
    while o:
        v = v + v[..., idx ^ o]
        o //= 2
    w = v[..., 0]
    out = w[..., 0]
    for i in range(1, w.shape[-1]):
        out = out + w[..., i]
    return out


def _row_terms(x, s, dy, D: int, V: int, G: int, eps: float):
    """(r, c, dx in f32) of each row of x (rows, D), in the kernel's
    order: per lane over its packs, then the lanes."""
    rows = x.shape[0]
    npk = D // V
    pl = -(-npk // G)
    pad = pl * G * V - D

    def packs(a):                       # (rows, PL, G, V): pack k·G + lane
        a = np.pad(a, ((0, 0), (0, pad)))
        return a.reshape(rows, pl, G, V)
    X, Y = packs(x), packs(dy)
    S = np.pad(s, (0, pad)).reshape(pl, G, V)
    ss = np.zeros((rows, G), f32)
    sg = np.zeros((rows, G), f32)
    for k in range(pl):
        for j in range(V):
            xv = X[:, k, :, j]
            ss = fma(xv, xv, ss)
            sg = fma(Y[:, k, :, j] * S[k, :, j], xv, sg)
    ss, sg = _lane_sum(ss, G), _lane_sum(sg, G)
    d = f32(D)
    r = f32(1) / np.sqrt(ss / d + f32(eps))
    c = r * r * r * (sg / d)
    r, c = r[:, None], c[:, None]
    dx = fma(-x, c, r * (dy * s))
    return r, dx


def emulate(tensors, eps: float = 1e-5, *, V: int, G: int, grid: int,
            reread: bool = False):
    """tensors: [(x, scale, dy)] (one, or the pair's q and k), x and dy
    (rows, D) f32 numpy arrays holding the kernel's inputs (bf16 values
    already rounded), scale (D,) f32. Returns [(dx f32, dscale f32)], dx
    before its cast to the input's type. ``reread`` changes nothing in the
    arithmetic (its block partials sit in device memory, summed alike)."""
    del reread
    D = tensors[0][0].shape[1]
    ng = THREADS // G
    out, rts = [], []
    for x, s, dy in tensors:
        r, dx = _row_terms(x, s, dy, D, V, G, eps)
        out.append(dx)
        rts.append(r)
    # every row's term dy·(x·r), rows of the tensors one after the other
    which = np.concatenate([np.full(t[0].shape[0], i)
                            for i, t in enumerate(tensors)])
    local = np.concatenate([np.arange(t[0].shape[0]) for t in tensors])
    runs = -(-len(which) // ng)
    acc = np.zeros((len(tensors), grid, ng, D), f32)
    for start in range(0, runs, grid):
        u = np.arange(start, min(start + grid, runs))
        b = u - start
        row = u[:, None] * ng + np.arange(ng)[None, :]          # (blocks, ng)
        live = row < len(which)
        rr = np.where(live, row, 0)
        for t, (x, _, dy) in enumerate(tensors):
            mine = live & (which[rr] == t)
            li = np.where(mine, local[rr], 0)
            term_x = x[li] * rts[t][li]                           # x·r
            new = fma(dy[li], term_x, acc[t, b])
            acc[t, b] = np.where(mine[..., None], new, acc[t, b])
    n = ng
    while n > 1:                        # the row groups' tree
        h = n // 2
        acc = acc[:, :, :h] + acc[:, :, h:n]
        n = h
    block = acc[:, :, 0]                                          # (T, grid, D)
    ranks = block.reshape(len(tensors), grid // CLUSTER, CLUSTER, D)
    cl = ranks[:, :, 0]
    for q in range(1, CLUSTER):
        cl = cl + ranks[:, :, q]
    nc = grid // CLUSTER
    lanes = []
    for ty in range(8):
        v = np.zeros((len(tensors), D), f32)
        for j in range(ty, nc, 8):
            v = v + cl[:, j]
        lanes.append(v)
    ds = lanes[0]
    for v in lanes[1:]:
        ds = ds + v
    return [(dx, ds[t]) for t, dx in enumerate(out)]


def to_bf16(a):
    """f32 -> bf16 values (round to nearest even), kept in f32."""
    u = np.asarray(a, f32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16
    return u.astype(np.uint32).view(f32)


def exact(x, s, dy, eps: float = 1e-5):
    """dx and dscale of the norm at x in f64 from the same inputs."""
    x, s, dy = (np.asarray(a, f64) for a in (x, s, dy))
    r = 1 / np.sqrt((x * x).mean(-1, keepdims=True) + eps)
    g = dy * s
    dx = r * g - x * (r ** 3 * (g * x).mean(-1, keepdims=True))
    return dx, (dy * x * r).sum(0)

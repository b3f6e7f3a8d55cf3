"""On-device keypoint rasterizer, face path (counterpart of the JAX
package's `data/rasterize_jax.py`: `_exists_int`, `_stamp_cover`,
`_stamp_cover_quad` and `rasterize_face_clip`).

Every edge of the face's part lists is a curve; a pixel is an edge pixel
when some edge covers it. Coverage is the JAX package's closed form of
the host tier's discrete stamping (`data/face.py:render_face_edges`): a
curve sampled at `ceil(span)` points along its longer axis, each sample
int-cast and stamped with a square brush [-bw, bw). "Some sample covers
pixel p" becomes "an integer sample index lies in a closed-form interval
set", evaluated per (pixel, edge) as dense torch math:

- landmarks group in threes (edge_len=3, stride 2): 28 three-point edges
  whose minor coordinate is the Lagrange parabola through the points,
  edges with |a| > 1 dropped (the reference's wild-quadratic rejection);
- 6 two-point tails drawn as linear strokes.

The expressions copy the JAX ones term for term (the same `eps`, the
same `where` guards and operation order), since coverage is `ceil` /
`floor` of fp32 values and another order can move a sample exactly onto
a window edge. Eager PyTorch materialises every temporary that XLA
fuses, so frames go through in groups of about `_BUDGET` (pixel, edge)
elements (16 MB a fp32 temporary); each group's coverage is OR-ed over
its edges into one (F, H*W) map. No Pallas kernel stood here, and none
stands here: this is torch ops on whatever device the keypoints live.

The pose path (`rasterize_pose_clip`) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .face import FACE_PART_LIST

_INF = float("inf")
_BUDGET = 1 << 22


def _face_edges() -> tuple[np.ndarray, np.ndarray]:
    """(28, 3) three-point and (6, 2) two-point landmark index groups."""
    tris, pairs = [], []
    edge_len = 3
    for part in FACE_PART_LIST:
        for edge in part:
            for i in range(0, max(1, len(edge) - 1), edge_len - 1):
                sub = edge[i:i + edge_len]
                if len(sub) == 3:
                    tris.append(tuple(sub))
                elif len(sub) == 2:
                    pairs.append(tuple(sub))
    return np.asarray(tris, np.int64), np.asarray(pairs, np.int64)


FACE_TRIS, FACE_PAIRS = _face_edges()


def _exists_int(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Does [lo, hi] (real bounds) contain an integer?"""
    return torch.ceil(lo) <= torch.floor(hi)


def _stamp_cover(px, py, a, b, bw) -> torch.Tensor:
    """Exact coverage of the host tier's stamping for 2-point edges.

    px, py (1, P, 1) pixel coordinates; a, b (F, E, 2) endpoints; bw
    (F, 1, 1) brush widths -> (F, P, E) bool. Main axis the larger
    |delta|, t sorted ascending, n = ceil(span) samples ts_i = t0 + i*dt,
    dt = span / (n - 1), the minor coordinate linear in i; sample i
    covers p iff both floored coordinates land in [p - bw + 1, p + bw].
    """
    ax, ay = a[:, None, :, 0], a[:, None, :, 1]            # (F, 1, E)
    bx, by = b[:, None, :, 0], b[:, None, :, 1]

    main_y = torch.abs(bx - ax) < torch.abs(by - ay)
    am = torch.where(main_y, ay, ax)
    an = torch.where(main_y, ax, ay)
    bm = torch.where(main_y, by, bx)
    bn = torch.where(main_y, bx, by)
    pm = torch.where(main_y, py, px)                        # (F, P, E)
    pn = torch.where(main_y, px, py)

    swap = am > bm
    t0 = torch.where(swap, bm, am)
    t1 = torch.where(swap, am, bm)
    v0 = torch.where(swap, bn, an)
    v1 = torch.where(swap, an, bn)
    span = t1 - t0
    n = torch.ceil(span)                                    # sample count

    # per-axis half-open windows (integer bounds: pixel and bw are ints)
    lo_w_m = pm - bw + 1.0
    hi_w_m = pm + bw + 1.0                                  # exclusive
    lo_w_n = pn - bw + 1.0
    hi_w_n = pn + bw + 1.0

    nm1 = torch.clamp(n - 1.0, min=1.0)
    dt = span / nm1
    dv = (v1 - v0) / nm1
    safe_dt = torch.where(dt == 0, 1.0, dt)
    # main: ts_i in [lo_w_m, hi_w_m)  (dt > 0 whenever n >= 2)
    i_lo_m = torch.ceil((lo_w_m - t0) / safe_dt)
    i_hi_m = torch.ceil((hi_w_m - t0) / safe_dt) - 1.0
    # minor: v0 + i*dv in [lo_w_n, hi_w_n); sign of dv flips/opens bounds
    pos = dv > 0
    neg = dv < 0
    safe_dv = torch.where(dv == 0, 1.0, dv)
    q_lo = (lo_w_n - v0) / safe_dv
    q_hi = (hi_w_n - v0) / safe_dv
    zero_ok = (v0 >= lo_w_n) & (v0 < hi_w_n)
    i_lo_n = torch.where(pos, torch.ceil(q_lo),
                         torch.where(neg, torch.floor(q_hi) + 1.0,
                                     torch.where(zero_ok, 0.0, n)))
    i_hi_n = torch.where(pos, torch.ceil(q_hi) - 1.0,
                         torch.where(neg, torch.floor(q_lo),
                                     torch.where(zero_ok, n - 1.0, -1.0)))
    ilo = torch.clamp(torch.maximum(i_lo_m, i_lo_n), min=0.0)
    ihi = torch.minimum(torch.minimum(i_hi_m, i_hi_n), n - 1.0)
    cover_multi = ilo <= ihi

    # n == 1: the single sample sits at (t0, v0)
    cover_one = ((t0 >= lo_w_m) & (t0 < hi_w_m)
                 & (v0 >= lo_w_n) & (v0 < hi_w_n))
    return torch.where(n >= 2.0, cover_multi,
                       torch.where(n == 1.0, cover_one, False))


def _stamp_cover_quad(px, py, p0, p1, p2, bw) -> torch.Tensor:
    """Exact coverage for 3-point edges: the minor coordinate is the
    Lagrange parabola through the three points (the host tier's degree-2
    fit of 3 points), quadratic in the sample index, edges with |a| > 1
    or coincident abscissae dropped.

    px, py (1, P, 1); p0/p1/p2 (F, E, 2); bw (F, 1, 1) -> (F, P, E) bool.
    """
    xs = torch.stack([p0[..., 0], p1[..., 0], p2[..., 0]])[:, :, None, :]
    ys = torch.stack([p0[..., 1], p1[..., 1], p2[..., 1]])[:, :, None, :]

    # axis choice: larger max-consecutive-diff (interp_curve)
    main_y = (torch.maximum(torch.abs(xs[1] - xs[0]), torch.abs(xs[2] - xs[1]))
              < torch.maximum(torch.abs(ys[1] - ys[0]),
                              torch.abs(ys[2] - ys[1])))
    t = torch.where(main_y, ys, xs)                         # (3, F, 1, E)
    v = torch.where(main_y, xs, ys)
    pm = torch.where(main_y, py, px)                        # (F, P, E)
    pn = torch.where(main_y, px, py)
    flip = t[0] > t[2]
    ta, tb, tc = (torch.where(flip, t[2], t[0]), t[1],
                  torch.where(flip, t[0], t[2]))
    va, vb, vc = (torch.where(flip, v[2], v[0]), v[1],
                  torch.where(flip, v[0], v[2]))
    span = tc - ta
    n = torch.ceil(span)

    # Lagrange coefficients of v(t) = alpha t^2 + beta t + gamma
    eps = 1e-6
    d0 = (ta - tb) * (ta - tc)
    d1 = (tb - ta) * (tb - tc)
    d2 = (tc - ta) * (tc - tb)
    degen = ((torch.abs(d0) < eps) | (torch.abs(d1) < eps)
             | (torch.abs(d2) < eps))
    sd0 = torch.where(torch.abs(d0) < eps, 1.0, d0)
    sd1 = torch.where(torch.abs(d1) < eps, 1.0, d1)
    sd2 = torch.where(torch.abs(d2) < eps, 1.0, d2)
    alpha = va / sd0 + vb / sd1 + vc / sd2
    beta = -(va * (tb + tc) / sd0 + vb * (ta + tc) / sd1
             + vc * (ta + tb) / sd2)
    gamma = (va * tb * tc / sd0 + vb * ta * tc / sd1 + vc * ta * tb / sd2)
    wild = torch.abs(alpha) > 1.0                           # ref :334 reject

    nm1 = torch.clamp(n - 1.0, min=1.0)
    dt = span / nm1
    # v as a function of the sample index i (t = ta + i*dt)
    a2 = alpha * dt * dt
    a1 = (2.0 * alpha * ta + beta) * dt
    a0 = (alpha * ta + beta) * ta + gamma

    lo_w_m = pm - bw + 1.0
    hi_w_m = pm + bw + 1.0
    lo_w_n = pn - bw + 1.0
    hi_w_n = pn + bw + 1.0
    safe_dt = torch.where(dt == 0, 1.0, dt)
    i_lo_m = torch.clamp(torch.ceil((lo_w_m - ta) / safe_dt), min=0.0)
    i_hi_m = torch.minimum(torch.ceil((hi_w_m - ta) / safe_dt) - 1.0,
                           n - 1.0)

    # ---- quadratic band {lo_w_n <= q(i) < hi_w_n} as <= 2 intervals ----
    lin = torch.abs(a2) < 1e-9
    sa2 = torch.where(lin, 1.0, a2)

    def roots(c):
        disc = a1 * a1 - 4.0 * sa2 * (a0 - c)
        s = torch.sqrt(torch.clamp(disc, min=0.0))
        r1 = (-a1 - s) / (2.0 * sa2)
        r2 = (-a1 + s) / (2.0 * sa2)
        return disc >= 0, torch.minimum(r1, r2), torch.maximum(r1, r2)

    okA, rA1, rA2 = roots(lo_w_n)
    okB, rB1, rB2 = roots(hi_w_n)
    posq = a2 > 0
    # A2 > 0: {q < B} = (rB1, rB2) [empty if !okB];
    #         {q >= A} = outside (rA1, rA2) [everything if !okA]
    pA1 = torch.where(okA, rA1, _INF)
    pA2 = torch.where(okA, rA2, _INF)
    pB1 = torch.where(okB, rB1, _INF)
    pB2 = torch.where(okB, rB2, -_INF)
    p_l1, p_h1 = pB1, torch.minimum(pA1, pB2)
    p_l2, p_h2 = torch.maximum(pA2, pB1), pB2
    # A2 < 0: {q < B} = (-inf, rB1) u (rB2, inf) [everything if !okB];
    #         {q >= A} = [rA1, rA2] [empty if !okA]
    nA1 = torch.where(okA, rA1, _INF)
    nA2 = torch.where(okA, rA2, -_INF)
    nB1 = torch.where(okB, rB1, _INF)
    nB2 = torch.where(okB, rB2, _INF)
    n_l1, n_h1 = nA1, torch.minimum(nA2, nB1)
    n_l2, n_h2 = torch.maximum(nB2, nA1), nA2
    l1 = torch.where(posq, p_l1, n_l1)
    h1 = torch.where(posq, p_h1, n_h1)
    l2 = torch.where(posq, p_l2, n_l2)
    h2 = torch.where(posq, p_h2, n_h2)
    # linear fallback (a2 ~ 0): one interval from the affine condition
    posl = a1 > 0
    negl = a1 < 0
    sa1 = torch.where(a1 == 0, 1.0, a1)
    q_lo = (lo_w_n - a0) / sa1
    q_hi = (hi_w_n - a0) / sa1
    zero_ok = (a0 >= lo_w_n) & (a0 < hi_w_n)
    lin_lo = torch.where(posl, q_lo, torch.where(negl, q_hi, torch.where(
        zero_ok, 0.0, _INF)))
    lin_hi = torch.where(posl, q_hi, torch.where(negl, q_lo, torch.where(
        zero_ok, n - 1.0, -_INF)))
    l1 = torch.where(lin, lin_lo, l1)
    h1 = torch.where(lin, lin_hi, h1)
    l2 = torch.where(lin, _INF, l2)
    h2 = torch.where(lin, -_INF, h2)

    cov = (_exists_int(torch.maximum(l1, i_lo_m), torch.minimum(h1, i_hi_m))
           | _exists_int(torch.maximum(l2, i_lo_m),
                         torch.minimum(h2, i_hi_m)))
    cover_one = ((ta >= lo_w_m) & (ta < hi_w_m)
                 & (a0 >= lo_w_n) & (a0 < hi_w_n))
    cov = torch.where(n >= 2.0, cov,
                      torch.where(n == 1.0, cover_one, False))
    return cov & torch.logical_not(wild) & torch.logical_not(degen)


def rasterize_face_clip(keypoints: torch.Tensor, bw: torch.Tensor,
                        h: int = 256, w: int = 256) -> torch.Tensor:
    """68-landmark clip (F, 68, 2) and brush widths (F,) -> (F, h, w)
    int32 edge maps (0 background, 1 edge), on the keypoints' device.
    Reproduces `render_face_edges` as the JAX `rasterize_face_clip`
    does."""
    dev = keypoints.device
    kp = keypoints.float()
    bw = bw.float()
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    px = gx.reshape(1, -1, 1)
    py = gy.reshape(1, -1, 1)
    tris = torch.as_tensor(FACE_TRIS, device=dev)
    pairs = torch.as_tensor(FACE_PAIRS, device=dev)
    group = max(1, _BUDGET // (h * w * len(FACE_TRIS)))
    out = []
    for lo in range(0, kp.shape[0], group):
        k = kp[lo:lo + group]
        b = bw[lo:lo + group, None, None]
        hit = _stamp_cover_quad(px, py, k[:, tris[:, 0]], k[:, tris[:, 1]],
                                k[:, tris[:, 2]], b).any(dim=2)
        hit |= _stamp_cover(px, py, k[:, pairs[:, 0]], k[:, pairs[:, 1]],
                            b).any(dim=2)
        out.append(hit)
    return torch.cat(out).reshape(-1, h, w).to(torch.int32)

"""Plain ORB front-end: the features the program's front-end must produce.

A frozen copy, in plain PyTorch, of the plain versions that the port's
hand-written kernels are held against (`ops/preprocess`, `ops/fast`,
`ops/nms`, `ops/patches`, `ops/orb`, `ops/align`, `models/stereo`): 3x3 blur
and the half-sampled pyramid as shifted slices in a fixed order, FAST with
the 16 ring terms summed in ring order, 3x3 local max, one winner a grid
cell (first index on ties), a stable top-K, 37x37 patches gathered from the
levels, intensity-centroid angles (moments summed in float64), rotated
BRIEF-256, and depth by a min-pool (RGB-D) or by the epipolar Hamming match
and the 1-D SAD polish (pre-rectified stereo).  Every step is exact or
order-fixed, so on one device it gives the program's features bit for bit.

`pixel_dtype=torch.bfloat16` computes the blur and the pyramid in bfloat16:
the control, one step of precision below the float32 the configuration
states for its pixel arithmetic.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
        (-3, -1))
PATTERN_SEED, PATTERN_CLIP = 0x0B5E55ED, 12


# -- tie-ordered reductions ---------------------------------------------------

def _first_index(x: Tensor, best: Tensor, dim: int) -> Tensor:
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    pos = torch.arange(n, device=x.device).reshape(shape)
    return torch.where(x == best.unsqueeze(dim), pos, n).amin(dim=dim)


def first_argmax(x: Tensor, dim: int) -> tuple[Tensor, Tensor]:
    best = x.amax(dim=dim)
    return best, _first_index(x, best, dim)


def first_argmin(x: Tensor, dim: int) -> tuple[Tensor, Tensor]:
    best = x.amin(dim=dim)
    return best, _first_index(x, best, dim)


# -- pyramid --------------------------------------------------------------------

def _blur_axis(x: Tensor, axis: int) -> Tensor:
    n = x.shape[axis]
    lo = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)
    hi = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], axis)
    return (0.25 * lo + 0.5 * x) + 0.25 * hi


def blur(img: Tensor) -> Tensor:
    """[1 2 1]/4 x [1 2 1]/4, edge-replicate, columns then rows."""
    return _blur_axis(_blur_axis(img, -1), -2)


def halfsample(img: Tensor) -> Tensor:
    h, w = img.shape[-2], img.shape[-1]
    if h % 2:
        img = torch.cat([img, img[..., -1:, :]], -2)
    if w % 2:
        img = torch.cat([img, img[..., :, -1:]], -1)
    s = ((img[..., 0::2, 0::2] + img[..., 0::2, 1::2])
         + img[..., 1::2, 0::2]) + img[..., 1::2, 1::2]
    return 0.25 * s


def pyramid(gray: Tensor, num_levels: int, pixel_dtype=torch.float32) -> list:
    """Blur, then level k = halfsample(blur(level k - 1)); float32 levels."""
    levels = [blur(gray.to(pixel_dtype))]
    for _ in range(num_levels - 1):
        levels.append(halfsample(blur(levels[-1])))
    return [lvl.to(torch.float32).contiguous() for lvl in levels]


# -- FAST and non-max suppression ---------------------------------------------

def _rot16(m: Tensor, k: int) -> Tensor:
    k %= 16
    return m if k == 0 else ((m >> k) | (m << (16 - k))) & 0xFFFF


def _has_arc(mask: Tensor, length: int) -> Tensor:
    p, k = {1: mask}, 1
    while k < 16:
        p[2 * k] = p[k] & _rot16(p[k], k)
        k *= 2
    run, offset = None, 0
    for k in (16, 8, 4, 2, 1):
        if length & k:
            piece = _rot16(p[k], offset)
            run = piece if run is None else (run & piece)
            offset += k
    return run != 0


def fast_score(img: Tensor, threshold: float, arc: int, border: int) -> Tensor:
    """FAST response: max(bright excess, dark excess) over the ring pixels
    beyond +-threshold, summed in ring order; 0 off corners and borders."""
    h, w = img.shape
    dev = img.device
    t = torch.full((), threshold, dtype=torch.float32, device=dev)
    pad = F.pad(img, (3, 3, 3, 3))
    bmask = torch.zeros((h, w), dtype=torch.int32, device=dev)
    dmask = torch.zeros_like(bmask)
    bsum, dsum = torch.zeros_like(img), torch.zeros_like(img)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for i, (dy, dx) in enumerate(RING):
        d = pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img
        bright, dark = d > t, d < -t
        bmask |= bright.to(torch.int32) << i
        dmask |= dark.to(torch.int32) << i
        bsum = bsum + torch.where(bright, d - t, zero)
        dsum = dsum + torch.where(dark, -d - t, zero)
    corner = _has_arc(bmask, arc) | _has_arc(dmask, arc)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    inside = ((yy >= border) & (yy < h - border)
              & (xx >= border) & (xx < w - border))
    return torch.where(corner & inside, torch.maximum(bsum, dsum), zero)


def local_max(resp: Tensor) -> Tensor:
    h, w = resp.shape
    pad = F.pad(resp, (1, 1, 1, 1))
    hood = resp
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                hood = torch.maximum(hood, pad[1 + dy:1 + dy + h,
                                               1 + dx:1 + dx + w])
    return torch.where(resp >= hood, resp, torch.zeros_like(resp))


def cell_winners(resp: Tensor, cell: int) -> tuple[Tensor, Tensor, Tensor]:
    """One winner a cell (first index on ties): flat (score, y, x)."""
    h, w = resp.shape
    rows, cols = -(-h // cell), -(-w // cell)
    resp = F.pad(resp, (0, cols * cell - w, 0, rows * cell - h))
    cells = resp.reshape(rows, cell, cols, cell).permute(0, 2, 1, 3)
    score, idx = first_argmax(cells.reshape(rows, cols, cell * cell), -1)
    idx = idx.to(torch.int32)
    cy = torch.arange(rows, dtype=torch.int32, device=resp.device)[:, None] * cell
    cx = torch.arange(cols, dtype=torch.int32, device=resp.device)[None, :] * cell
    return (score.reshape(-1), (cy + idx // cell).reshape(-1),
            (cx + idx % cell).reshape(-1))


def select(winners: list, shapes: list, k_max: int, min_score: float,
           border: int) -> dict:
    """Level-0 coordinates of every cell winner, then the stable top-K."""
    scores, xs, ys, levels, xl, yl = [], [], [], [], [], []
    for lvl, (score, y, x) in enumerate(winners):
        scale = float(2 ** lvl)
        h, w = shapes[lvl]
        inside = (x >= border) & (x < w - border) & (y >= border) & (y < h - border)
        xs.append((x.to(torch.float32) + 0.5) * scale - 0.5)
        ys.append((y.to(torch.float32) + 0.5) * scale - 0.5)
        scores.append(torch.where(inside, score, torch.zeros_like(score)))
        levels.append(torch.full_like(x, lvl, dtype=torch.int32))
        xl.append(x)
        yl.append(y)
    score, x, y = torch.cat(scores), torch.cat(xs), torch.cat(ys)
    level, xl, yl = torch.cat(levels), torch.cat(xl), torch.cat(yl)
    k = min(k_max, score.shape[0])
    order = torch.sort(score, descending=True, stable=True)
    top_score, top = order.values[:k], order.indices[:k]
    if k < k_max:
        top_score = F.pad(top_score, (0, k_max - k))
        top = F.pad(top, (0, k_max - k))
    return {"xy": torch.stack([x[top], y[top]], -1),
            "xy_level": torch.stack([xl[top], yl[top]], -1).to(torch.int32),
            "level": level[top], "score": top_score,
            "valid": top_score > min_score}


# -- patches, orientation, BRIEF ------------------------------------------------

def patches(levels: list, kp: dict, p: int) -> Tensor:
    r = p // 2
    dev = levels[0].device
    heights = [im.shape[0] for im in levels]
    widths = [im.shape[1] for im in levels]
    starts = [0]
    for h, w in zip(heights[:-1], widths[:-1]):
        starts.append(starts[-1] + h * w)
    flat = torch.cat([im.reshape(-1) for im in levels])
    layout = torch.tensor([starts, heights, widths], dtype=torch.int64, device=dev)
    lvl_start, lvl_h, lvl_w = layout[:, kp["level"].long()]
    yc = torch.minimum(torch.clamp_min(kp["xy_level"][:, 1].long(), r), lvl_h - 1 - r)
    xc = torch.minimum(torch.clamp_min(kp["xy_level"][:, 0].long(), r), lvl_w - 1 - r)
    offs = torch.arange(-r, r + 1, device=dev)
    ys, xs = yc[:, None] + offs[None, :], xc[:, None] + offs[None, :]
    idx = (lvl_start[:, None, None] + ys[:, :, None] * lvl_w[:, None, None]
           + xs[:, None, :])
    return flat[idx.clamp_(0, flat.numel() - 1)]


def orientation(patch: Tensor, disc_radius: int = 15) -> Tensor:
    k, p, _ = patch.shape
    coords = np.arange(p, dtype=np.float32) - (p // 2)
    dy, dx = coords[:, None], coords[None, :]
    disc = (dx * dx + dy * dy) <= float(disc_radius * disc_radius)
    wts = np.stack([np.where(disc, dx, np.float32(0)).reshape(-1),
                    np.where(disc, dy, np.float32(0)).reshape(-1)])
    w = torch.from_numpy(wts.astype(np.float64)).to(patch.device)
    m = (patch.reshape(k, p * p).double() @ w.T).float()
    return torch.atan2(m[:, 1], m[:, 0])


def rotated_pattern(num_bits: int, p: int, bins: int) -> np.ndarray:
    """(bins, 2, num_bits) flat patch indices of the BRIEF pairs under each
    rotation bin."""
    rng = np.random.RandomState(PATTERN_SEED)
    pts = np.clip(rng.randn(num_bits, 2, 2) * (p / 5.0), -PATTERN_CLIP,
                  PATTERN_CLIP).astype(np.float32)
    r = p // 2
    out = np.zeros((bins, 2, num_bits), dtype=np.int32)
    for b in range(bins):
        a = 2.0 * np.pi * b / bins
        c, s = np.cos(a), np.sin(a)
        x = pts[..., 0] * c - pts[..., 1] * s
        y = pts[..., 0] * s + pts[..., 1] * c
        xi = np.clip(np.rint(x).astype(np.int32) + r, 0, p - 1)
        yi = np.clip(np.rint(y).astype(np.int32) + r, 0, p - 1)
        out[b] = (yi * p + xi).T
    return out


def describe(patch: Tensor, angles: Tensor, num_bits: int, bins: int) -> Tensor:
    """Rotated BRIEF: (K, num_bits / 32) int32 words, bit i = I(p1) < I(p2)."""
    k, p, _ = patch.shape
    dev = patch.device
    table = torch.from_numpy(rotated_pattern(num_bits, p, bins).astype(np.int64)).to(dev)
    frac = torch.remainder(angles, 2.0 * math.pi) / (2.0 * math.pi)
    b = torch.round(frac * bins).to(torch.int32)
    b = torch.clamp(torch.remainder(b, bins), 0, bins - 1).long()
    idx = table[b].reshape(k, 2 * num_bits)
    vals = patch.reshape(k, p * p).gather(1, idx)
    bits = (vals[:, :num_bits] - vals[:, num_bits:] < 0).to(torch.int64)
    weights = torch.from_numpy(np.int64(1) << np.arange(32, dtype=np.int64)).to(dev)
    words = (bits.reshape(k, num_bits // 32, 32) * weights).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def level_shapes(fe: dict) -> list:
    shapes, h, w = [], fe["height"], fe["width"]
    for _ in range(fe["num_levels"]):
        shapes.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return shapes


def keypoints(gray: Tensor, fe: dict, pixel_dtype=torch.float32):
    """Detect and describe one image: (keypoints, angles, descriptors)."""
    levels = pyramid(gray, fe["num_levels"], pixel_dtype)
    thresholds = [fe["fast_threshold"]]
    if fe["fast_min_threshold"] > 0.0:
        thresholds.append(fe["fast_min_threshold"])
    winners = []
    for img in levels:
        resp = [local_max(fast_score(img, t, fe["fast_arc_length"],
                                     fe["fast_border"])) for t in thresholds]
        hi = cell_winners(resp[0], fe["cell_size"])
        if len(resp) > 1:
            lo = cell_winners(resp[1], fe["cell_size"])
            use = hi[0] > fe["min_score"]
            hi = tuple(torch.where(use, a, b) for a, b in zip(hi, lo))
        winners.append(hi)
    kp = select(winners, level_shapes(fe), fe["max_keypoints"],
                fe["min_score"], fe["fast_border"])
    patch = patches(levels, kp, fe["patch_size"])
    angles = orientation(patch)
    return kp, angles, describe(patch, angles, fe["descriptor_bits"],
                                fe["num_angle_bins"])


def deproject(xy: Tensor, z: Tensor, intr: Tensor) -> Tensor:
    x = (xy[..., 0] - intr[2]) / intr[0]
    y = (xy[..., 1] - intr[3]) / intr[1]
    return torch.stack([x * z, y * z, z], -1)


def _features(kp: dict, desc: Tensor, pts: Tensor, has_point: Tensor) -> dict:
    return {"xy": kp["xy"], "level": kp["level"], "valid": kp["valid"],
            "desc": desc, "has_point": has_point,
            "points": torch.where(has_point[:, None], pts, torch.zeros_like(pts))}


@torch.no_grad()
def features_rgbd(gray: Tensor, depth: Tensor, intr: Tensor, fe: dict,
                  min_depth: float, max_depth: float,
                  pixel_dtype=torch.float32) -> dict:
    """Keypoints of a registered RGB-D frame; a point's depth is the least
    valid depth of the 3x3 pixels around it."""
    kp, _, desc = keypoints(gray, fe, pixel_dtype)
    h, w = depth.shape
    neg = -torch.where(depth > 0, depth, torch.full_like(depth, float("inf")))
    pooled = -F.max_pool2d(neg[None, None], kernel_size=3, stride=1, padding=1)[0, 0]
    xi = torch.clamp(torch.round(kp["xy"][:, 0]).long(), 0, w - 1)
    yi = torch.clamp(torch.round(kp["xy"][:, 1]).long(), 0, h - 1)
    z = pooled[yi, xi]
    z = torch.where(torch.isfinite(z), z, torch.zeros_like(z))
    has = kp["valid"] & (z > min_depth) & (z < max_depth)
    return _features(kp, desc, deproject(kp["xy"], z, intr), has)


def _shift_tables(patch_w: int, search: int, step: float):
    shifts = np.arange(-search, search + 1e-6, step, dtype=np.float32)
    fl = np.floor(shifts)
    k0 = fl.astype(np.int64) + search
    k1 = np.minimum(k0 + 1, 2 * search)
    frac = (shifts - fl).astype(np.float32)
    c = np.arange(patch_w)
    base = -(patch_w // 2) - search
    cols = np.stack([k0[:, None] + c, k1[:, None] + c]) + base
    return shifts, cols, np.stack([np.float32(1.0) - frac, frac])


def _refine_disparity(left, right, xy_l, disp0, level, patch_h=5, patch_w=9,
                      search=3, step=0.25) -> Tensor:
    """1-D SAD polish on the left keypoint's row, linear interpolation along
    it, least SAD first on ties; untrusted results keep `disp0`."""
    dev = left.device
    H, W = left.shape
    ph2, pw2 = patch_h // 2, patch_w // 2
    shifts, cols, weights = (torch.from_numpy(a).to(dev)
                             for a in _shift_tables(patch_w, search, step))
    xl = torch.round(xy_l[:, 0]).to(torch.int32).long()
    yl = torch.round(xy_l[:, 1]).to(torch.int32).long()
    xr0 = (torch.round(xy_l[:, 0]).to(torch.int32)
           - torch.round(disp0).to(torch.int32)).long()
    dy = torch.arange(-ph2, ph2 + 1, device=dev)
    dxp = torch.arange(-pw2, pw2 + 1, device=dev)
    rows = torch.clamp(yl[:, None] + dy, 0, H - 1)
    cols_l = torch.clamp(xl[:, None] + dxp, 0, W - 1)
    patch_l = left[rows[:, :, None], cols_l[:, None, :]]
    cols_r = torch.clamp(xr0[:, None, None, None] + cols, 0, W - 1)
    pair = torch.take(right, rows[:, :, None, None, None] * W + cols_r[:, None])
    w = weights[:, :, None]
    win = w[0] * pair[:, :, 0] + w[1] * pair[:, :, 1]
    sad = torch.abs(patch_l[:, :, None, :] - win).sum(dim=(1, 3))
    _, best = first_argmin(sad, 1)
    s = shifts.index_select(0, best)
    inside = ((yl - ph2 >= 0) & (yl + ph2 < H) & (xl - pw2 >= 0)
              & (xl + pw2 < W) & (xr0 - pw2 - search >= 0)
              & (xr0 + pw2 + search < W))
    ok = (inside & (torch.abs(s) < (search - 0.5))
          & (torch.abs(s) <= torch.exp2(level.to(torch.float32)) * 0.75 + 0.25))
    xr = xr0.to(torch.float32) + s
    return torch.where(ok, xl.to(torch.float32) - xr, disp0)


def _unpack(desc: Tensor, num_bits: int) -> Tensor:
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], num_bits).to(torch.float32)


@torch.no_grad()
def features_stereo(left: Tensor, right: Tensor, intr: Tensor, fe: dict,
                    st: dict, min_depth: float, max_depth: float,
                    pixel_dtype=torch.float32) -> dict:
    """Keypoints of the left image of a pre-rectified pair; depth from the
    nearest right descriptor within the epipolar band and disparity range,
    polished by the SAD search, z = fx * baseline / disparity."""
    kp_l, _, desc_l = keypoints(left, fe, pixel_dtype)
    kp_r, _, desc_r = keypoints(right, fe, pixel_dtype)
    bits = fe["descriptor_bits"]
    a = _unpack(desc_l, bits) * 2.0 - 1.0
    b = _unpack(desc_r, bits) * 2.0 - 1.0
    d = (bits - a @ b.T) * 0.5
    xy_l, xy_r = kp_l["xy"], kp_r["xy"]
    dv = torch.abs(xy_l[:, None, 1] - xy_r[None, :, 1])
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    gate = ((~kp_l["valid"][:, None]) | (~kp_r["valid"][None, :])
            | (dv > st["epipolar_tol"]) | (disp <= 0.1)
            | (disp > st["max_disparity"]))
    d = torch.where(gate, torch.full_like(d, 1e9), d)
    best_d, best_j = first_argmin(d, 1)
    matched = (best_d <= st["max_hamming"]) & kp_l["valid"]
    disparity = xy_l[:, 0] - xy_r.index_select(0, best_j)[:, 0]
    disparity = _refine_disparity(left, right, xy_l, disparity, kp_l["level"])
    z = intr[0] * st["baseline"] / torch.clamp(disparity, min=1e-3)
    has = matched & (z > min_depth) & (z < max_depth)
    return _features(kp_l, desc_l, deproject(xy_l, z, intr), has)

"""A plain reference of the dense point tracker (ParticleSfM's
point_trajectory: `trajectory.py`, `track_optimize.py:31-50`,
`optimize/src/path_consistency_cost.h`), written from that description and
not from the program.

Given the flows of a sequence (stride-1 forward and backward, and with path
consistency stride-2 forward and backward), per frame f:
  1. spawn a trajectory on every free grid cell (every `ratio`-th pixel, row
     by row), ids in spawn order, at most `capacity` alive at once;
  2. step every live head by the bilinear stride-1 flow; it dies where the
     occlusion mask sampled there exceeds 0.1 or where it leaves the open
     interval (0, W-1) x (0, H-1);
  3. a grid cell is free for frame f+1 when no surviving head's pixel lies
     within Euclidean distance `ratio` of it;
  4. survivors that have a position at f-1 refine their positions at f and
     f+1 by Levenberg-Marquardt on the path-consistency cost: anchors at the
     stride-1 and stride-2 flow from f-1 (the second weighted by the stride-2
     visibility, and dropped where that flow is `upper_flow` px or longer),
     and the stride-1 flow from f to f+1 between them.
Positions are kept at 1/32 px as unsigned 16-bit numbers, and trajectories
observed in fewer than `min_len` frames are dropped.
"""
from __future__ import annotations

import numpy as np
import torch


def _sample(img, xy):
    """Bilinear sample of img [H, W, C] at xy [N, 2]; corners outside read 0."""
    H, W, C = img.shape
    x0, y0 = torch.floor(xy[:, 0]), torch.floor(xy[:, 1])
    fx, fy = xy[:, 0] - x0, xy[:, 1] - y0
    out = torch.zeros(xy.shape[0], C, dtype=img.dtype, device=img.device)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = (x0 + dx).long(), (y0 + dy).long()
            inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            v = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)] * inside[:, None]
            out = out + (wx * wy)[:, None] * v
    return out


def _clamped_sample_jac(img, xy):
    """Edge-clamped bilinear sample (Ceres' Grid2D) of img [H, W, 2] at xy
    [N, 2], and its derivative [N, 2, 2] (zero along an axis where xy lies
    outside the image)."""
    H, W, _ = img.shape
    x = xy[:, 0].clamp(0.0, W - 1.0)
    y = xy[:, 1].clamp(0.0, H - 1.0)
    x0 = torch.floor(x).clamp(0, W - 2)
    y0 = torch.floor(y).clamp(0, H - 2)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    xi, yi = x0.long(), y0.long()
    a, b = img[yi, xi], img[yi, xi + 1]
    c, d = img[yi + 1, xi], img[yi + 1, xi + 1]
    top, bot = a + fx * (b - a), c + fx * (d - c)
    val = top + fy * (bot - top)
    ddx = (1 - fy) * (b - a) + fy * (d - c)
    ddy = bot - top
    inx = ((xy[:, 0] >= 0) & (xy[:, 0] <= W - 1)).to(img.dtype)[:, None]
    iny = ((xy[:, 1] >= 0) & (xy[:, 1] <= H - 1)).to(img.dtype)[:, None]
    return val, torch.stack([ddx * inx, ddy * iny], dim=-1)


def occlusion(flow_f, flow_b, thres):
    """1 where the round trip f then b misses by more than `thres` px or the
    forward target leaves [0, W-1] x [0, H-1]; flows [T, H, W, 2]."""
    T, H, W, _ = flow_f.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=flow_f.device, dtype=flow_f.dtype),
                            torch.arange(W, device=flow_f.device, dtype=flow_f.dtype),
                            indexing="ij")
    out = []
    for t in range(T):
        tx, ty = xs + flow_f[t, ..., 0], ys + flow_f[t, ..., 1]
        back = _sample(flow_b[t], torch.stack([tx, ty], -1).reshape(-1, 2)).reshape(H, W, 2)
        err = torch.linalg.vector_norm(back + flow_f[t], dim=-1)
        oob = (tx < 0) | (tx > W - 1) | (ty < 0) | (ty > H - 1)
        out.append(((err > thres) | oob).to(flow_f.dtype))
    return torch.stack(out)


def _refine(p, ref1, ref2, scale, flow12, iters):
    """LM on p [N, 4] = (x_f, y_f, x_f+1, y_f+1): one model evaluation per
    step, damping x0.3 on an accepted step and x4 on a rejected one."""
    eye2 = torch.eye(2, dtype=p.dtype, device=p.device).expand(p.shape[0], 2, 2)
    zero = torch.zeros_like(eye2)

    def model(p):
        x1, x2 = p[:, :2], p[:, 2:]
        f, jf = _clamped_sample_jac(flow12, x1)
        r = torch.cat([x1 - ref1, (x2 - ref2) * scale[:, None], x2 - x1 - f], dim=1)
        J = torch.cat([torch.cat([eye2, zero], -1),
                       torch.cat([zero, scale[:, None, None] * eye2], -1),
                       torch.cat([-eye2 - jf, eye2], -1)], dim=1)
        return (r * r).sum(1), (J.transpose(1, 2) @ r[:, :, None])[:, :, 0], \
            J.transpose(1, 2) @ J

    cost, g, Hm = model(p)
    lam = torch.full((p.shape[0],), 1e-4, dtype=p.dtype, device=p.device)
    eye4 = torch.eye(4, dtype=p.dtype, device=p.device)
    for _ in range(iters):
        cand = p + torch.linalg.solve(Hm + lam[:, None, None] * eye4, -g)
        cost_c, g_c, H_c = model(cand)
        better = cost_c < cost
        p = torch.where(better[:, None], cand, p)
        cost = torch.where(better, cost_c, cost)
        g = torch.where(better[:, None], g_c, g)
        Hm = torch.where(better[:, None, None], H_c, Hm)
        lam = torch.where(better, lam * 0.3, lam * 4.0).clamp(1e-8, 1e6)
    return p


def _disc(radius: int, device):
    k = int(np.floor(radius))
    return [(dy, dx) for dy in range(-k, k + 1) for dx in range(-k, k + 1)
            if dx * dx + dy * dy <= radius * radius]


def track(flows, track_cfg: dict, height: int, width: int):
    """Trajectories of one sequence. `flows` maps flow_f, flow_b (and, with
    path consistency, flow_f2, flow_b2) to [T(-1), H, W, 2] float tensors on
    the device the tracker runs on. Returns (xy [N, T+1, 2] float32, mask
    [N, T+1] bool) on the host, rows in id order."""
    ff = flows["flow_f"]
    dev, dt = ff.device, ff.dtype
    T, H, W = ff.shape[0], height, width
    r, cap = int(track_cfg["sample_ratio"]), int(track_cfg["capacity"])
    occ = occlusion(ff, flows["flow_b"], track_cfg["flow_check_thres"])
    use_pc = "flow_f2" in flows
    if use_pc:
        ff2 = flows["flow_f2"]
        occ2 = occlusion(ff2, flows["flow_b2"], track_cfg["flow_check_thres"])
    gy, gx = torch.meshgrid(torch.arange(0, H, r, device=dev, dtype=dt),
                            torch.arange(0, W, r, device=dev, dtype=dt), indexing="ij")
    cells = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    disc = _disc(r, dev)

    free = torch.ones(cells.shape[0], dtype=torch.bool, device=dev)
    pos = torch.zeros(0, 2, dtype=dt, device=dev)
    prev1 = torch.zeros(0, 2, dtype=dt, device=dev)
    start = torch.zeros(0, dtype=torch.long, device=dev)
    ids = torch.zeros(0, dtype=torch.long, device=dev)
    next_id = 0
    emitted = []                                  # (frame, ids, xy)
    for f in range(T):
        new = cells[free][: max(cap - pos.shape[0], 0)]
        n = new.shape[0]
        pos = torch.cat([pos, new])
        prev1 = torch.cat([prev1, new])
        start = torch.cat([start, torch.full((n,), f, dtype=torch.long, device=dev)])
        ids = torch.cat([ids, next_id + torch.arange(n, device=dev)])
        next_id += n

        head = pos + _sample(ff[f], pos)
        live = ((head[:, 0] > 0) & (head[:, 0] < W - 1) & (head[:, 1] > 0)
                & (head[:, 1] < H - 1) & (_sample(occ[f][..., None], pos)[:, 0] <= 0.1))

        occupied = torch.zeros(H + 2 * r, W + 2 * r, dtype=torch.bool, device=dev)
        hx, hy = head[live, 0].long(), head[live, 1].long()
        occupied[hy + r, hx + r] = True
        near = torch.zeros(H, W, dtype=torch.bool, device=dev)
        for dy, dx in disc:
            near |= occupied[r + dy: r + dy + H, r + dx: r + dx + W]
        free = ~near[::r, ::r].reshape(-1)

        at_f = pos.clone()
        if use_pc:
            elig = live & (start <= f - 1)
            if bool(elig.any()):
                x0 = prev1[elig]                  # each one's position at f-1
                f01 = _sample(ff[f - 1], x0)
                f02 = _sample(ff2[f - 1], x0)
                o02 = _sample(occ2[f - 1][..., None], x0)[:, 0]
                w = (1.0 - o02) * (torch.linalg.vector_norm(f02, dim=-1)
                                   < track_cfg["upper_flow"]).to(dt)
                p = _refine(torch.cat([pos[elig], head[elig]], 1), x0 + f01, x0 + f02, w,
                            ff[f], int(track_cfg["gn_iters"]))
                at_f[elig], head[elig] = p[:, :2], p[:, 2:]
        emitted.append((f, ids, at_f))
        pos, prev1, start, ids = head[live], at_f[live], start[live], ids[live]
    emitted.append((T, ids, pos))

    xy = np.zeros((next_id, T + 1, 2), np.float32)
    mask = np.zeros((next_id, T + 1), bool)
    for f, i, p in emitted:
        q = torch.clamp(torch.round(p * 32.0), 0, 65535).cpu().numpy().astype(np.uint16)
        i = i.cpu().numpy()
        xy[i, f] = q.astype(np.float32) / 32.0
        mask[i, f] = True
    keep = mask.sum(1) >= int(track_cfg["min_len"])
    return xy[keep], mask[keep]

"""Gaze scan-path simulation: per-frame fovea coordinates, masks, patches.

A copy of crfp_tpu/data/fovea.py (numpy only; the port imports nothing of
the JAX package). It replicates the reference's ``fovea_generator``
(dataset/reds.py:17-226 of the reference; the Vimeo variant's 7-point
Nanascan is its dataset/vimeo7.py:169-187), including its integer-percent
arithmetic so scan paths land on identical pixels. Randomized scans (Rscan,
Nanascan) draw from an explicit ``np.random.Generator`` for
reproducibility.

Returns NHWC numpy arrays: fovea images (T,H,W,C) = GT masked, masks
(T,H,W,1), and the (T,2) top-left (y,x) coordinates.
"""

from __future__ import annotations

import math

import numpy as np


def _scan_coords(
    method: str,
    len_sp: int,
    gt_hw: tuple[int, int],
    fv_hw: tuple[int, int],
    step: float,
    rng: np.random.Generator,
    nanascan_grid: str,
) -> list[list[int]]:
    gt_h, gt_w = gt_hw
    fv_h, fv_w = fv_hw
    sp_f, cp_f, ep_f = 0.1, 0.5, 0.9

    cp_h = (gt_h * cp_f - fv_h // 2) / gt_h
    cp_w = (gt_w * cp_f - fv_w // 2) / gt_w
    ep_h = (gt_h * ep_f - fv_h) / gt_h
    ep_w = (gt_w * ep_f - fv_w) / gt_w

    if method in ("Cscan", "Zscan"):
        side = math.ceil(math.sqrt(len_sp))
        if sp_f + side * step > ep_h or sp_f + side * step > ep_w:
            step = min((ep_h - sp_f) / side, (ep_w - sp_f) / side)
        sp = int(sp_f * 100)
        step_i = int(step * 100)
        ep = int(sp + math.ceil(math.sqrt(len_sp) - 1) * step_i)
    elif method == "Hscan":
        if sp_f + len_sp * step > ep_w:
            step = (ep_w - sp_f) / len_sp
        sp = int(sp_f * 100)
        step_i = int(step * 100)
        ep = int(sp + len_sp * step_i)
    elif method == "Vscan":
        if sp_f + len_sp * step > ep_h:
            step = (ep_h - sp_f) / len_sp
        sp = int(sp_f * 100)
        step_i = int(step * 100)
        ep = int(sp + len_sp * step_i)
    else:
        if sp_f + len_sp * step > ep_h or sp_f + len_sp * step > ep_w:
            step = min((ep_h - sp_f) / len_sp, (ep_w - sp_f) / len_sp)
        sp = int(sp_f * 100)
        step_i = int(step * 100)
        ep = int(sp + len_sp * step_i)

    if method == "Hscan":
        return [[int(cp_h * gt_h), int((v / 100) * gt_w)] for v in range(sp, ep, step_i)]
    if method == "Vscan":
        return [[int((v / 100) * gt_h), int(cp_w * gt_w)] for v in range(sp, ep, step_i)]
    if method == "Cscan":
        coords = []
        v, h = sp, sp
        v_step, h_step = step_i, step_i
        for _ in range(len_sp):
            coords.append([int((v / 100) * gt_h), int((h / 100) * gt_w)])
            if h == ep and h_step > 0:
                h_step = -h_step
                v += v_step
            elif h == sp and h_step < 0:
                h_step = -h_step
                v += v_step
            else:
                h += h_step
        return coords
    if method == "Zscan":
        coords = []
        v, h = sp, sp
        v_step, h_step = step_i, step_i
        for _ in range(len_sp):
            coords.append([int((v / 100) * gt_h), int((h / 100) * gt_w)])
            if h == ep and v_step < 0:
                v_step = -v_step
                v += v_step
                h_step = -abs(h_step)
            elif v == sp and h_step > 0:
                h += h_step
                h_step = -h_step
                v_step = abs(v_step)
            elif v == ep and h_step < 0:
                h_step = -h_step
                h += h_step
                v_step = -abs(v_step)
            elif h == sp and v_step > 0:
                v += v_step
                v_step = -v_step
                h_step = abs(h_step)
            else:
                h += h_step
                v += v_step
        return coords
    if method == "Rscan":
        sigma = 0.05
        rand_h = rng.normal(cp_h, sigma, len_sp).clip(0, ep_h)
        rand_w = rng.normal(cp_w, sigma, len_sp).clip(0, ep_w)
        return [[int(rh * gt_h), int(rw * gt_w)] for rh, rw in zip(rand_h, rand_w)]
    if method == "Nanascan":
        if nanascan_grid == "reds16":
            # 16-point grid over the center-shifted span (reds.py:120-157)
            ratio_h = fv_h / gt_h
            sp_h, ep_h2 = ratio_h / 2, 1 - ratio_h / 2
            t1_h = sp_h + (ep_h2 - sp_h) * 0.33
            t2_h = sp_h + (ep_h2 - sp_h) * 0.66
            ratio_w = fv_w / gt_w
            sp_w, ep_w2 = ratio_w / 2, 1 - ratio_w / 2
            t1_w = sp_w + (ep_w2 - sp_w) * 0.33
            t2_w = sp_w + (ep_w2 - sp_w) * 0.66
            hs = [sp_h, t1_h, t2_h, ep_h2]
            ws = [sp_w, t1_w, t2_w, ep_w2]
            locs = [(y - ratio_h / 2, x - ratio_h / 2) for y in hs for x in ws]
            idx = rng.integers(0, len(locs), size=len_sp)
            coords = [
                [
                    min(int(locs[i][0] * gt_h), gt_h - fv_h),
                    min(int(locs[i][1] * gt_w), gt_w - fv_w),
                ]
                for i in idx
            ]
            rng.shuffle(coords)
            return coords
        # 7-point grid (vimeo7.py:169-187)
        def clip_lo(v, lim):
            return v if v > 0 else lim

        def clip_hi(v, edge, lim):
            return v if edge <= 1 else lim

        sp_h2, ep_h3 = 0, (gt_h - fv_h - 1) / gt_h
        q1_h = clip_lo(0.25 - (fv_h / gt_h) / 2, sp_h2)
        q2_h = 0.50 - (fv_h / gt_h) / 2
        q3_h = clip_hi(0.75 - (fv_h / gt_h) / 2, 0.75 + (fv_h / gt_h) / 2, ep_h3)
        t1_h = clip_lo(0.33 - (fv_h / gt_h) / 2, sp_h2)
        t2_h = clip_hi(0.66 - (fv_h / gt_h) / 2, 0.66 + (fv_h / gt_h) / 2, ep_h3)
        sp_w2, ep_w3 = 0, (gt_w - fv_w - 1) / gt_w
        q1_w = clip_lo(0.25 - (fv_w / gt_w) / 2, sp_w2)
        q2_w = 0.50 - (fv_w / gt_w) / 2
        q3_w = clip_hi(0.75 - (fv_w / gt_w) / 2, 0.75 + (fv_w / gt_w) / 2, ep_w3)
        t1_w = clip_lo(0.33 - (fv_w / gt_w) / 2, sp_w2)
        t2_w = clip_hi(0.66 - (fv_w / gt_w) / 2, 0.66 + (fv_w / gt_w) / 2, ep_w3)
        pts = [[q1_h, t1_w], [q1_h, t2_w], [q2_h, q1_w], [q2_h, q2_w], [q2_h, q3_w],
               [q3_h, t1_w], [q3_h, t2_w]]
        coords = [[int(v[0] * gt_h), int(v[1] * gt_w)] for v in pts]
        rng.shuffle(coords)
        return coords[:len_sp] if len_sp <= len(coords) else [
            coords[i % len(coords)] for i in range(len_sp)
        ]
    if method == "Evenscan":
        # raster tiling starting at tile index 20 (reds.py:158-168)
        idx0 = 20
        n_h = gt_h // fv_h
        n_w = gt_w // fv_w
        sp_h3 = gt_h / n_h
        sp_w3 = gt_w / n_w
        coords = []
        for i in range(idx0, idx0 + len_sp):
            x_i = i % n_w
            y_i = (i // n_w) % n_h
            coords.append(
                [int((1 + y_i) * sp_h3 - (sp_h3 + fv_h) / 2), int((1 + x_i) * sp_w3 - (sp_w3 + fv_w) / 2)]
            )
        return coords
    if method == "DemoHscan":
        coords = []
        direction = -1
        scan_step = 8
        accm = gt_w - scan_step
        for _ in range(len_sp):
            coords.append([0, accm])
            accm += direction * scan_step
            if accm < 0 or accm >= gt_w:
                direction *= -1
                accm += direction * scan_step
        return coords
    # DRscan / DLscan / fallback: diagonal
    return [[int((v / 100) * gt_h), int((v / 100) * gt_w)] for v in range(sp, ep, step_i)]


def fovea_generator(
    gt_imgs: np.ndarray,
    method: str = "Rscan",
    step: float = 0.1,
    fv_hw: tuple[int, int] = (32, 32),
    rng: np.random.Generator | None = None,
    nanascan_grid: str = "reds16",
):
    """gt_imgs: (T, H, W, C) array. Returns (fv_imgs, masks, coords)."""
    rng = rng or np.random.default_rng()
    t, gt_h, gt_w, c = gt_imgs.shape
    fv_h, fv_w = fv_hw
    coords = _scan_coords(method, t, (gt_h, gt_w), (fv_h, fv_w), step, rng, nanascan_grid)
    coords = np.asarray(coords[:t], np.int64)

    masks = np.zeros((t, gt_h, gt_w, 1), gt_imgs.dtype)
    for i in range(t):
        y, x = int(coords[i, 0]), int(coords[i, 1])
        if method == "DemoHscan":
            masks[i, y:, x:, :] = 1
        else:
            masks[i, y : y + fv_h, x : x + fv_w, :] = 1
    fv_imgs = gt_imgs * masks
    return fv_imgs, masks, coords

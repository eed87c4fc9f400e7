"""Bayesian inverse-depth seeds: delayed map-point insertion.

A working rebuild of the subsystem the reference ships only vestigially
(src/cv/depth_filter.cpp:35-60 — an SVO-style `Seed` with the Vogiatzis
Beta-Gaussian inverse-depth posterior, constructed nowhere in the live
pipeline).  Here it closes the dominant monocular accuracy bug: keyframe
pairs with near-zero baseline triangulate points whose depth error is
amplified by 1/parallax; once inserted they poison the pose fit and local
BA converges to a compromise local minimum (see NOTES.md round-1 backlog
and tests/test_depth_filter.py for the measured replay).

Design: the per-keyframe seed state is a fixed-capacity struct-of-arrays
aligned with the keyframe's keypoint slots, so the device triangulation
stage's packed outputs (match indices, per-view along-ray depth z and
uncertainty tau — `depth_and_tau`, geometry/triangulation.py) drive
batched, fully vectorized posterior updates.  The update itself is a few
elementwise ops on <=1k floats — host numpy, deliberately: shipping
scattered 1k-element updates to the device costs more in transfers than
the arithmetic.

Update rule (Seed::updateSeed, depth_filter.cpp:35-60; Vogiatzis &
Hernandez 2011): each measurement x = 1/z with variance tau_inv^2 updates
a Gaussian x Beta posterior over (inverse depth, inlier ratio); a seed is
promoted to a map point when the depth posterior's std shrinks below
z_range/convergence_div.

The port keeps its own copy of the JAX package's slam/depth_filter.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from sp_orb_slam_tpu_torch.config import Config


class SeedBank:
    """Fixed-capacity inverse-depth seeds for one keyframe's keypoints.

    Slot i corresponds to keypoint i of the owning keyframe.  State mirrors
    the reference Seed fields (depth_filter.h): Beta(a, b) inlier posterior,
    Gaussian (mu, sigma2) inverse-depth posterior, z_range prior support.
    """

    def __init__(self, capacity: int):
        K = capacity
        self.active = np.zeros(K, bool)
        self.mu = np.zeros(K, np.float32)        # posterior mean of 1/z
        self.sigma2 = np.zeros(K, np.float32)    # posterior var of 1/z
        self.a = np.zeros(K, np.float32)         # Beta inlier evidence
        self.b = np.zeros(K, np.float32)         # Beta outlier evidence
        self.z_range = np.zeros(K, np.float32)   # 1/min_depth prior support
        self.born = np.zeros(K, np.int64)        # kf_id at initialization
        self.n_upd = np.zeros(K, np.int32)

    def init_slots(self, idx: np.ndarray, z: np.ndarray, min_depth: float,
                   born_kf: int) -> None:
        """Seed(depth_mean, depth_min) ctor semantics
        (depth_filter.cpp:22-32): mu = 1/z_mean, z_range = 1/z_min,
        sigma2 = z_range^2/36, a = b = 10."""
        if idx.size == 0:
            return
        zr = np.float32(1.0 / max(min_depth, 1e-3))
        self.active[idx] = True
        self.mu[idx] = 1.0 / np.maximum(z, 1e-6)
        self.z_range[idx] = zr
        self.sigma2[idx] = zr * zr / 36.0
        self.a[idx] = 10.0
        self.b[idx] = 10.0
        self.born[idx] = born_kf
        self.n_upd[idx] = 0

    def update(self, idx: np.ndarray, x: np.ndarray,
               tau2: np.ndarray) -> None:
        """Vectorized Seed::updateSeed (depth_filter.cpp:35-60)."""
        if idx.size == 0:
            return
        mu = self.mu[idx].astype(np.float64)
        sigma2 = self.sigma2[idx].astype(np.float64)
        a = self.a[idx].astype(np.float64)
        b = self.b[idx].astype(np.float64)
        z_range = self.z_range[idx].astype(np.float64)
        x = x.astype(np.float64)
        tau2 = np.maximum(tau2.astype(np.float64), 1e-12)

        norm2 = sigma2 + tau2
        s2 = 1.0 / (1.0 / sigma2 + 1.0 / tau2)
        m = s2 * (mu / sigma2 + x / tau2)
        # N(x; mu, sqrt(norm2))
        pdf = np.exp(-0.5 * (x - mu) ** 2 / norm2) / np.sqrt(
            2.0 * np.pi * norm2)
        C1 = a / (a + b) * pdf
        C2 = b / (a + b) / z_range
        norm_c = np.maximum(C1 + C2, 1e-300)
        C1 = C1 / norm_c
        C2 = C2 / norm_c
        f = C1 * (a + 1.0) / (a + b + 1.0) + C2 * a / (a + b + 1.0)
        e = (C1 * (a + 1.0) * (a + 2.0) / ((a + b + 1.0) * (a + b + 2.0))
             + C2 * a * (a + 1.0) / ((a + b + 1.0) * (a + b + 2.0)))
        mu_new = C1 * m + C2 * mu
        sigma2_new = (C1 * (s2 + m * m) + C2 * (sigma2 + mu * mu)
                      - mu_new * mu_new)
        # a = (e - f) / (f - e/f): numerator and denominator are both
        # negative in the usual regime — guard magnitude, KEEP the sign
        f_safe = np.where(np.abs(f) < 1e-12, 1e-12, f)
        denom = f - e / f_safe
        denom_ok = np.abs(denom) > 1e-12
        a_new = (e - f) / np.where(denom_ok, denom, 1.0)
        b_new = a_new * (1.0 - f) / f_safe

        ok = (denom_ok & np.isfinite(mu_new) & np.isfinite(sigma2_new)
              & np.isfinite(a_new) & np.isfinite(b_new) & (sigma2_new > 0)
              & (a_new > 0) & (b_new > 0))
        upd = idx[ok]
        self.mu[upd] = mu_new[ok]
        self.sigma2[upd] = sigma2_new[ok]
        self.a[upd] = a_new[ok]
        self.b[upd] = b_new[ok]
        self.n_upd[upd] += 1

    def converged(self, div: float, promote_rel: float) -> np.ndarray:
        """Promotion test, >=1 update past the init measurement.  Two
        criteria, either suffices:
        - sqrt(sigma2) < z_range/div — the reference's absolute criterion
          (depth_filter.cpp:58-59 uses /200 with per-frame epipolar
          updates; keyframe-rate updates converge in fewer, larger steps
          so the divisor is a config knob);
        - posterior *relative* depth std sqrt(sigma2)/mu < promote_rel —
          insert once the fused estimate is as certain as a direct-insert
          candidate would be (the gate that deferred it)."""
        sig = np.sqrt(np.maximum(self.sigma2, 0.0))
        return (self.active & (self.n_upd >= 1)
                & ((sig < self.z_range / div)
                   | (sig < promote_rel * np.maximum(self.mu, 1e-9))))

    def kill(self, idx: np.ndarray) -> None:
        self.active[idx] = False


class DepthFilter:
    """Routes high-uncertainty triangulation candidates into seeds and
    promotes converged seeds to map points.

    Called from LocalMapping.create_new_map_points per neighbor pass with
    the packed triangulation-kernel outputs; owns nothing device-side.
    """

    def __init__(self, cfg: Config, world, K_intr):
        self.cfg = cfg.mapping.depth_filter
        self.map = world
        self.K = np.asarray(K_intr, np.float64)  # [fx, fy, cx, cy]
        self.banks: Dict[int, SeedBank] = {}
        self.n_seeded = 0
        self.n_promoted = 0
        self.n_expired = 0
        self.n_updates = 0
        self.n_rescued = 0

    def bank(self, kf) -> SeedBank:
        bk = self.banks.get(kf.kf_id)
        if bk is None:
            bk = SeedBank(len(kf.mp_ids))
            self.banks[kf.kf_id] = bk
        return bk

    # ------------------------------------------------------------- lifecycle

    def prune(self, newest_kf_id: int) -> None:
        """Drop banks of erased KFs; expire seeds past max_seed_age and
        seeds whose keypoint acquired a map point by another path."""
        for kf_id in list(self.banks):
            kf = self.map.keyframes.get(kf_id)
            if kf is None or kf.bad:
                del self.banks[kf_id]
                continue
            bk = self.banks[kf_id]
            taken = bk.active & (kf.mp_ids >= 0)
            bk.active[taken] = False
            old = bk.active & (newest_kf_id - bk.born
                               > self.cfg.max_seed_age)
            self.n_expired += int(old.sum())
            bk.active[old] = False
            if not bk.active.any():
                del self.banks[kf_id]

    # ------------------------------------------------------------- measure

    def observe_pair(self, kf1, kf2, out: dict,
                     seedable: np.ndarray) -> List[Tuple[int, int, int, int]]:
        """Update both KFs' seeds from one triangulation pass.

        `out` is the packed triangulate_pair_batch result (match21 maps each KF2
        keypoint j to a KF1 keypoint i; z/tau per view); `seedable` marks
        candidates that passed the geometric gates but failed the
        relative-uncertainty direct-insert gate.

        Returns promotions as (owner_kf_id, owner_idx, other_kf_id,
        other_idx) — the caller creates the map points under the map lock.
        """
        js = np.nonzero(seedable)[0]
        if js.size == 0:
            return []
        match21 = out["match21"]
        is_ = match21[js].astype(np.int64)

        def inv_meas(z, tau):
            z = np.maximum(z, 1e-6)
            tau = np.minimum(tau, z * 0.9)  # keep 1/(z-tau) finite
            x = 1.0 / z
            tau_inv = 0.5 * (1.0 / np.maximum(z - tau, 1e-6)
                             - 1.0 / (z + tau))
            return x, tau_inv * tau_inv

        promotions: List[Tuple[int, int, int, int]] = []
        newest = max(kf1.kf_id, kf2.kf_id)
        for kf, idx, other_kf, other_idx, z, tau in (
                (kf1, is_, kf2, js, out["z1"][js], out["tau1"][js]),
                (kf2, js, kf1, is_, out["z2"][js], out["tau2"][js])):
            bk = self.bank(kf)
            fresh = ~bk.active[idx]
            if fresh.any():
                md = self._min_scene_depth(kf, np.median(z[fresh]))
                bk.init_slots(idx[fresh], z[fresh], md, newest)
                self.n_seeded += int(fresh.sum())
            upd = ~fresh
            if upd.any():
                x, tau2 = inv_meas(z[upd], tau[upd])
                bk.update(idx[upd], x, tau2)
                self.n_updates += int(upd.sum())
            conv = bk.converged(self.cfg.convergence_div,
                                self.cfg.promote_rel_sigma)
            for k, slot in enumerate(idx):
                if conv[slot]:
                    promotions.append((kf.kf_id, int(slot), other_kf.kf_id,
                                       int(other_idx[k])))
                    bk.active[slot] = False
        return promotions

    def _min_scene_depth(self, kf, fallback: float) -> float:
        """z_min for the prior support (Seed ctor's depth_min)."""
        zs = []
        R2 = kf.Tcw[2, :3]
        t2 = kf.Tcw[2, 3]
        for pid in kf.mp_ids:
            if pid >= 0:
                zs.append(float(R2 @ self.map.pool.pos[pid] + t2))
        zs = [z for z in zs if z > 1e-3]
        if zs:
            return 0.5 * min(zs)
        return max(0.25 * fallback, 1e-3)

    # ------------------------------------------------------------- promote

    def point_from_seed(self, kf, slot: int) -> Optional[np.ndarray]:
        """World position from the fused posterior: depth 1/mu along the
        keypoint's bearing ray."""
        bk = self.banks.get(kf.kf_id)
        if bk is None or bk.mu[slot] <= 1e-9:
            return None
        fx, fy, cx, cy = self.K
        u, v = kf.data.uv[slot]
        ray = np.array([(u - cx) / fx, (v - cy) / fy, 1.0], np.float64)
        ray /= np.linalg.norm(ray)
        Rwc = kf.Tcw[:3, :3].T.astype(np.float64)
        X = kf.Ow.astype(np.float64) + (1.0 / float(bk.mu[slot])) * (Rwc @ ray)
        return X.astype(np.float32)

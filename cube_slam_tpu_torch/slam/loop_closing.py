"""Loop closing: place recognition, Sim3 verification, pose-graph correction.

PyTorch counterpart of cube_slam_tpu/slam/loop_closing.py, the re-design of
LoopClosing + KeyFrameDatabase (orb_object_slam/src/LoopClosing.cc,
KeyFrameDatabase.cc) without DBoW2:

* place recognition — each keyframe gets a global binary-statistic
  signature (the mean of its ORB descriptor bits, a 256-d float vector);
  querying the database is one matvec against all signatures (host numpy).
  Candidate gating mirrors DetectLoopCandidates (KeyFrameDatabase.cc:74-194).
* geometric verification — descriptor matching between the two keyframes'
  map points + batched Sim3 RANSAC (slam/sim3.py) standing in for
  SearchByBoW + Sim3Solver (LoopClosing.cc:231-400).
* correction — a 7-DoF Sim3 pose graph over the essential graph
  (sequential + covisibility + loop edges), solved with the dense LM
  (OptimizeEssentialGraph, Optimizer.cc:2575), then map points re-anchored
  through their reference keyframe's correction (CorrectLoop,
  LoopClosing.cc:401-580).

The map stays host numpy, as in the JAX package: descriptors are its uint32
words, and travel to the device as int32 tensors with the same bits. The
matchers, RANSACs and the pose-graph LM run on `device`; the edge lists, the
guided re-match's selection and the logm/expm initialisation of the
correction run on the host, as in JAX.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from ..device import resolve
from ..graph.lm import lm_optimize
from ..ops import matching
from ..utils import geometry as geo
from ..utils import np_geometry as np_geo
from . import sim3 as sim3_mod


def keyframe_signature(desc, valid):
    """(N, 8) uint32 descriptors -> (256,) float bit-frequency signature."""
    bits = ((desc[:, :, None] >> np.arange(32, dtype=np.uint32)[None, None, :]) & 1)
    bits = bits.reshape(desc.shape[0], 256).astype(np.float32)
    w = valid.astype(np.float32)
    n = max(w.sum(), 1.0)
    return (bits * w[:, None]).sum(axis=0) / n


def signature_similarity(query, db):
    """Cosine similarity of a query signature against a stack (K, 256).

    Signatures are CENTERED at 0.5 first: raw bit frequencies hover around
    0.5 for random descriptors, so un-centered cosines are all ~1 and carry
    no information. Centered, unrelated keyframes score ~0 and revisits
    score high — which also makes an absolute candidate floor meaningful
    (fixing the degenerate floor=0 case when no covisible keyframe is in
    the database, cf. KeyFrameDatabase.cc:74-194's minScore)."""
    q = query - 0.5
    d = db - 0.5
    qn = q / max(np.linalg.norm(q), 1e-9)
    dn = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    return dn @ qn


class LoopDetector:
    """KeyFrameDatabase analog over signatures."""

    def __init__(self, min_gap_kfs=10, margin=1.02, abs_floor=0.35):
        self.signatures = {}
        # insertion order per kf id: the temporal rank used for the min-gap
        # test (KF slot ids are recycled, so slot distance is NOT time)
        self._order = {}
        self._n_added = 0
        self.min_gap_kfs = min_gap_kfs
        self.margin = margin
        self.abs_floor = abs_floor

    def add(self, kf_id, desc, valid):
        self.signatures[int(kf_id)] = keyframe_signature(desc, valid)
        self._order[int(kf_id)] = self._n_added
        self._n_added += 1

    def remove(self, kf_id):
        self.signatures.pop(int(kf_id), None)
        self._order.pop(int(kf_id), None)

    def detect(self, kf_id, covisible_ids):
        """Returns candidate kf ids sorted by similarity (best first)."""
        if kf_id not in self.signatures:
            return []
        ids = sorted(self.signatures)
        others = [i for i in ids if i != kf_id]
        if not others:
            return []
        db = np.stack([self.signatures[i] for i in others])
        sims = signature_similarity(self.signatures[kf_id], db)
        cov = set(int(c) for c in covisible_ids)
        # reference: candidates must beat the minimum covisible score; the
        # absolute floor guards the empty-covisible case
        cov_sims = [s for i, s in zip(others, sims) if i in cov]
        floor = max(min(cov_sims) if cov_sims else 0.0, self.abs_floor)
        my_rank = self._order.get(kf_id, self._n_added)
        cands = [
            (s, i) for i, s in zip(others, sims)
            if i not in cov
            and abs(my_rank - self._order.get(i, -10**9)) >= self.min_gap_kfs
            and s > floor * self.margin
        ]
        cands.sort(reverse=True)
        return [i for _, i in cands]

    def detect_relocalization(self, signature, max_candidates=3,
                              covis_groups=None):
        """DetectRelocalizationCandidates (KeyFrameDatabase.cc:196-260):
        rank stored keyframes by signature similarity to a LOST frame's
        signature — no covisibility exclusion (we want the closest stored
        place, wherever it is).

        With `covis_groups` (kf_id -> covisible kf ids), scores accumulate
        over each keyframe's covisibility group and the BEST MEMBER of each
        leading group is returned (the reference's accumulated-score
        ranking, :219-249 + the 0.75*best gate :251) — on maps with
        repeated structure a single aliased keyframe can out-score the true
        place, but its group cannot."""
        if not self.signatures:
            return []
        ids = sorted(self.signatures)
        db = np.stack([self.signatures[i] for i in ids])
        sims = signature_similarity(signature, db)
        sim_of = dict(zip(ids, sims))
        if covis_groups is None:
            order = np.argsort(-sims)
            return [int(ids[int(k)]) for k in order[:max_candidates]
                    if sims[int(k)] > self.abs_floor]
        scored = []
        for k in ids:
            gl = covis_groups(k)
            gl = [] if gl is None else list(gl)
            group = [k] + [int(g) for g in gl
                           if int(g) in sim_of and int(g) != k]
            acc = float(sum(max(sim_of[g], 0.0) for g in group))
            best_member = max(group, key=lambda g: sim_of[g])
            scored.append((acc, best_member))
        best_acc = max(a for a, _ in scored)
        out = []
        for acc, member in sorted(scored, reverse=True):
            if acc < 0.75 * best_acc or acc <= 0:
                break
            if member not in out and sim_of[member] > self.abs_floor:
                out.append(member)
            if len(out) >= max_candidates:
                break
        return out


def _np_sim3_compose(a, b):
    """Compose two numpy Sim3 triples (s, R, t): apply b then a."""
    sa, Ra, ta = a
    sb, Rb, tb = b
    return sa * sb, Ra @ Rb, sa * (Ra @ tb) + ta


def _np_sim3_of_se3(T):
    return 1.0, T[:3, :3].astype(np.float64), T[:3, 3].astype(np.float64)


def _np_sim3_inverse(s, R, t):
    return 1.0 / s, R.T, -(R.T @ t) / s


def _desc(words, device):
    """Host uint32 descriptor words -> an int32 tensor with the same bits."""
    return torch.tensor(np.ascontiguousarray(words).view(np.int32), device=device)


def _f32(x, device):
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def _sim3_guided_matches(m, kf_a, kf_b, s, R, t, radius, max_dist=matching.TH_HIGH, device=None):
    """SearchBySim3-style guided re-matching (ORBmatcher.cc:1141-1370),
    performed in 3D map space: warp each keyframe's map points into the
    other side's world through the estimated Sim3, descriptor-match within
    a 3D `radius`, keep mutually-agreeing distinct map-point pairs.
    The Hamming matrices run on `device`; the rest is host numpy.
    Returns (pa_w, pb_w) arrays of the agreed correspondences."""
    device = resolve(device)

    def one_way(src_kf, dst_kf, S):
        """src's map points through S near dst's map points. mp_src->mp_dst."""
        out = {}
        mp_s = m.kf_kp_mp[src_kf]
        sel_s = np.where((mp_s >= 0) & m.kf_kp_valid[src_kf])[0]
        ids_s = mp_s[sel_s]
        ids_s = ids_s[m.mp_valid[ids_s]]
        mp_d = m.kf_kp_mp[dst_kf]
        sel_d = np.where((mp_d >= 0) & m.kf_kp_valid[dst_kf])[0]
        ids_d = mp_d[sel_d]
        ids_d = ids_d[m.mp_valid[ids_d]]
        if len(ids_s) == 0 or len(ids_d) == 0:
            return out
        warped = S[0] * (m.mp_pos[ids_s].astype(np.float64) @ S[1].T) + S[2]
        d = matching.hamming_matrix(_desc(m.mp_desc[ids_s], device),
                                    _desc(m.mp_desc[ids_d], device)).cpu().numpy()
        near = np.linalg.norm(warped[:, None, :] - m.mp_pos[ids_d][None, :, :], axis=-1) < radius
        d = np.where(near, d, matching.BIG)
        best = d.argmin(axis=1)
        ok = d[np.arange(len(d)), best] <= max_dist
        return {int(a): int(ids_d[b]) for a, b in zip(ids_s[ok], best[ok])}

    m_ab = one_way(kf_a, kf_b, (s, R, t))
    m_ba = one_way(kf_b, kf_a, _np_sim3_inverse(s, R, t))
    # a == b is the same map point seen from both keyframes — a covisible
    # observation, not a loop correspondence (see verify_loop_sim3)
    agreed = [(a, b) for a, b in m_ab.items() if m_ba.get(b, -1) == a and a != b]
    if not agreed:
        return np.zeros((0, 3)), np.zeros((0, 3))
    a_ids = np.array([a for a, _ in agreed])
    b_ids = np.array([b for _, b in agreed])
    return m.mp_pos[a_ids].astype(np.float64), m.mp_pos[b_ids].astype(np.float64)


def _samples(n, count, seed):
    """`count` 3-point minimal samples of range(n), one numpy generator
    per sample, as in the JAX package."""
    return np.stack([np.random.default_rng(seed + i).choice(n, 3, replace=False)
                     for i in range(count)]).astype(np.int32)


def verify_loop_sim3(map_state, kf_a, kf_b, K=None, fix_scale=False,
                     min_inliers=20, seed=0, min_total=40, device=None):
    """Geometric verification (LoopClosing.cc:231-400): descriptor match ->
    Sim3 RANSAC -> guided SearchBySim3 re-match with that Sim3 -> re-fit ->
    accept at >= min_total agreed inliers.

    Returns (s, R, t, n_inliers) aligning kf_a's world points onto kf_b's
    (both in one world: a drifted map yields the correction) or None.
    `K` given selects the full pipeline with the trimmed RANSAC; without it
    the thresholded RANSAC's result (0.3 m) is returned."""
    device = resolve(device)
    m = map_state
    mp_a = m.kf_kp_mp[kf_a]
    mp_b = m.kf_kp_mp[kf_b]
    sel_a = np.where((mp_a >= 0) & m.kf_kp_valid[kf_a])[0]
    sel_b = np.where((mp_b >= 0) & m.kf_kp_valid[kf_b])[0]
    if len(sel_a) < min_inliers or len(sel_b) < min_inliers:
        return None
    d = matching.hamming_matrix(_desc(m.kf_kp_desc[kf_a, sel_a], device),
                                _desc(m.kf_kp_desc[kf_b, sel_b], device))
    idx, _ = matching.match_mutual_ratio(d, max_dist=matching.TH_LOW, ratio=0.9)
    idx = idx.cpu().numpy()
    good = idx >= 0
    if good.sum() < min_inliers:
        return None
    kp_a = sel_a[good]
    kp_b = sel_b[idx[good]]
    # drop same-map-point pairs: every Sim3 correspondence must relate two
    # distinct map points (the drifted duplicate vs the original)
    distinct = mp_a[kp_a] != mp_b[kp_b]
    kp_a, kp_b = kp_a[distinct], kp_b[distinct]
    if len(kp_a) < min_inliers:
        return None
    pa = m.mp_pos[mp_a[kp_a]]
    pb = m.mp_pos[mp_b[kp_b]]
    N = len(pa)
    samples = torch.tensor(_samples(N, 128, seed), device=device)
    ones = torch.ones(N, dtype=torch.bool, device=device)
    if K is not None:
        s, R, t, inlier, n_in = sim3_mod.sim3_ransac_trimmed(
            _f32(pa, device), _f32(pb, device), ones, samples, fix_scale=fix_scale)
    else:
        s, R, t, inlier, n_in = sim3_mod.sim3_ransac(
            _f32(pa, device), _f32(pb, device), ones, samples, 0.3, fix_scale=fix_scale)
    if int(n_in) < min_inliers:
        return None
    s, R, t = float(s), R.cpu().numpy().astype(np.float64), t.cpu().numpy().astype(np.float64)
    if K is None:
        return s, R, t, int(n_in)

    # guided re-match with the trimmed Sim3 (SearchBySim3 analog) in 3D, then
    # a trimmed re-fit on the agreed set; accept at the reference's
    # >= min_total(40) gate (LoopClosing.cc:367-400). The re-match radius
    # comes from the consensus residuals themselves.
    inl = inlier.cpu().numpy()
    resid = np.linalg.norm(s * (pa[inl] @ R.T) + t - pb[inl], axis=-1)
    scene = float(np.median(np.linalg.norm(pb - np.median(pb, axis=0), axis=-1)))
    radius = float(np.clip(4.0 * np.median(resid), 0.02 * scene, 0.1 * scene))
    pa2, pb2 = _sim3_guided_matches(m, kf_a, kf_b, s, R, t, radius, device=device)
    if len(pa2) < min_total:
        # no weaker fallback: the raw RANSAC count is not an acceptance
        # signal on self-similar structure
        return None
    N2 = len(pa2)
    s2, R2, t2, _, n2 = sim3_mod.sim3_ransac_trimmed(
        _f32(pa2, device), _f32(pb2, device), torch.ones(N2, dtype=torch.bool, device=device),
        torch.tensor(_samples(N2, 64, seed + 7919), device=device), fix_scale=fix_scale)
    if int(n2) < min_total:
        return None
    return float(s2), R2.cpu().numpy().astype(np.float64), t2.cpu().numpy().astype(np.float64), int(n2)


# ---------------------------------------------------------------------------
# Sim3 pose graph (OptimizeEssentialGraph)
# ---------------------------------------------------------------------------

def _relative_sim3_batch(s, R, t, ei, ej):
    """Relative measurements S_ij = S_i o S_j^-1 for all edges at once."""
    ei, ej = ei.long(), ej.long()
    inv_s, inv_R, inv_t = sim3_mod.sim3_inverse(s[ej], R[ej], t[ej])
    return sim3_mod.sim3_compose(s[ei], R[ei], t[ei], inv_s, inv_R, inv_t)


def optimize_sim3_pose_graph(
    kf_s, kf_R, kf_t,            # (K,), (K, 3, 3), (K, 3): world->kf Sim3
    edge_i, edge_j,              # (E,) int
    edge_s, edge_R, edge_t,      # measured relative Sim3: S_ij = S_i S_j^-1
    edge_valid, edge_weight,
    kf_fixed, kf_valid,
    num_iters: int = 20,
    n_kf: int = 0,
):
    """7-DoF pose graph: minimize log(S_ij S_j S_i^-1) over all edges, by
    lm_optimize with a jacfwd Jacobian over 7·K unknowns (`n_kf` is the JAX
    signature's static argument, unused here)."""
    Kf = kf_s.shape[0]
    dim = Kf * 7
    edge_i, edge_j = edge_i.long(), edge_j.long()
    w_edge = (edge_weight * edge_valid.to(edge_weight.dtype))[:, None]

    def retract(params, dx):
        s, R, t = params
        d = dx.reshape(Kf, 7)
        # left-compose the increment
        return sim3_mod.sim3_compose(torch.exp(d[:, 0]), geo.so3_exp(d[:, 1:4]), d[:, 4:7], s, R, t)

    def residual(params):
        s, R, t = params
        inv_si, inv_Ri, inv_ti = sim3_mod.sim3_inverse(s[edge_i], R[edge_i], t[edge_i])
        # error transform = S_ij o S_j o S_i^-1
        s1, R1, t1 = sim3_mod.sim3_compose(s[edge_j], R[edge_j], t[edge_j], inv_si, inv_Ri, inv_ti)
        s2, R2, t2 = sim3_mod.sim3_compose(edge_s, edge_R, edge_t, s1, R1, t1)
        r = torch.cat([torch.log(torch.clamp(s2, min=1e-9))[:, None], geo.so3_log(R2), t2], dim=1)
        return (r * w_edge).reshape(-1)

    mask = torch.repeat_interleave(kf_valid & (~kf_fixed), 7)
    res = lm_optimize(residual, retract, (kf_s, kf_R, kf_t), dim=dim, num_iters=num_iters,
                      param_mask=mask)
    return res.params


def correct_loop(map_state, loop_kf, matched_kf, sim3_correction, kf_order=None,
                 num_iters=20, covis_theta=30, extra_loop_edges=None, device=None):
    """Apply a verified loop: build the essential graph (spanning chain +
    covisibility edges above `covis_theta` shared points + past loop edges
    + the new loop edge, Optimizer.cc:2644-2740), optimize Sim3 poses on
    `device`, re-anchor map points through their first-observing keyframe
    (CorrectLoop, LoopClosing.cc:401-580). The design notes of each step are
    in the JAX package's correct_loop.

    sim3_correction: (s, R, t) mapping loop_kf-side world coords onto
    matched_kf-side coords (from verify_loop_sim3).
    extra_loop_edges: list of (kf_a, kf_b) pairs from previous closures.
    Returns {kf: (new_Tcw, old_Tcw, scale)} for every corrected keyframe."""
    device = resolve(device)
    m = map_state
    # temporal order (slot ids are recycled, so sorted ids are not time)
    kfs = kf_order if kf_order is not None else sorted(
        (int(k) for k in m.kf_ids()), key=lambda k: int(m.kf_frame_id[k]))
    K = len(kfs)
    idx_of = {k: i for i, k in enumerate(kfs)}

    # current Sim3 poses (scale 1): world -> kf
    s = np.ones(K, dtype=np.float32)
    R = np.stack([m.kf_tcw[k][:3, :3] for k in kfs])
    t = np.stack([m.kf_tcw[k][:3, 3] for k in kfs])

    # propagate the correction to the loop keyframe's covisible group on the
    # recent side of the loop first (CorrectLoop, LoopClosing.cc:434-470)
    sc_, Rc_, tc_ = sim3_correction
    corr = (float(sc_), np.asarray(Rc_, dtype=np.float64), np.asarray(tc_, dtype=np.float64))
    corr_inv = _np_sim3_inverse(*corr)
    r_i, r_j = idx_of[matched_kf], idx_of[loop_kf]
    covis_all = m.covisibility_matrix()
    group = {loop_kf} | {k for k in kfs if covis_all[loop_kf, k] >= 15 and idx_of[k] > (r_i + r_j) / 2}
    s_m = s.astype(np.float64).copy()
    R_m = R.astype(np.float64).copy()
    t_m = t.astype(np.float64).copy()
    for g in group:
        gi = idx_of[g]
        s_m[gi], R_m[gi], t_m[gi] = _np_sim3_compose((s_m[gi], R_m[gi], t_m[gi]), corr_inv)

    ei_l, ej_l, ew_l = [], [], []
    inserted = set()
    # spanning-chain edges (the sequential KF ordering is the spanning tree)
    for a, b in zip(range(K - 1), range(1, K)):
        ei_l.append(a); ej_l.append(b); ew_l.append(1.0)
        inserted.add((a, b))
    # covisibility edges: KF pairs sharing >= covis_theta map points, weight
    # 1/temporal span (Optimizer.cc:2744-)
    sub = covis_all[np.ix_(kfs, kfs)]
    iu, ju = np.triu_indices(K, 1)
    strong = sub[iu, ju] >= covis_theta
    for a, b in zip(iu[strong], ju[strong]):
        key = (int(a), int(b))
        if key in inserted:
            continue
        ei_l.append(int(a)); ej_l.append(int(b))
        ew_l.append(1.0 / max(int(b) - int(a), 1))
        inserted.add(key)
    # past loop edges (KeyFrame::GetLoopEdges)
    for a, b in (extra_loop_edges or []):
        if a not in idx_of or b not in idx_of:
            continue
        ia, ib = idx_of[a], idx_of[b]
        key = (min(ia, ib), max(ia, ib))
        if key in inserted:
            continue
        ei_l.append(key[0]); ej_l.append(key[1]); ew_l.append(float(K))
        inserted.add(key)

    ei = list(ei_l); ej = list(ej_l); ew = list(ew_l)
    # normal edges measure the pre-correction relatives; loop connections
    # (a corrected-group keyframe re-linked non-adjacently to the rest) the
    # corrected ones (OptimizeEssentialGraph, Optimizer.cc:2620-2740)
    ei_arr = np.asarray(ei, dtype=np.int32)
    ej_arr = np.asarray(ej, dtype=np.int32)
    in_group = np.array([kfs[x] in group for x in range(K)])
    is_loop_conn = (in_group[ei_arr] != in_group[ej_arr]) & (np.abs(ei_arr - ej_arr) > 1)
    ei_t = torch.tensor(ei_arr, device=device)
    ej_t = torch.tensor(ej_arr, device=device)
    es_d, eR_d, et_d = (x.cpu().numpy() for x in _relative_sim3_batch(
        _f32(s, device), _f32(R, device), _f32(t, device), ei_t, ej_t))
    es_c, eR_c, et_c = (x.cpu().numpy() for x in _relative_sim3_batch(
        _f32(s_m, device), _f32(R_m, device), _f32(t_m, device), ei_t, ej_t))
    sel = is_loop_conn
    es = [float(x) for x in np.where(sel, es_c, es_d)]
    eR = list(np.where(sel[:, None, None], eR_c, eR_d))
    et = list(np.where(sel[:, None], et_c, et_d))
    # loop connections carry the verified correction: full weight
    ew = [1.0 if lc_ else w for lc_, w in zip(sel, ew)]

    # the loop edge: the corrected relative between the anchor and the loop
    # keyframe (S_i o S o S_j^-1, with S_j already group-corrected)
    i, j = r_i, r_j
    S_ij = _np_sim3_compose((s_m[i], R_m[i], t_m[i]), _np_sim3_inverse(s_m[j], R_m[j], t_m[j]))
    ei.append(i); ej.append(j)
    es.append(float(S_ij[0])); eR.append(S_ij[1]); et.append(S_ij[2])
    ew.append(float(len(kfs)))  # strong loop edge

    E = len(ei)
    # gauge: the matched (old) keyframe is fixed (Optimizer.cc:2605-2612)
    fixed = np.zeros(K, dtype=bool)
    fixed[idx_of[matched_kf]] = True

    # initialize the vertices at the rank-interpolated correction
    # exp(alpha * log S^-1) between the anchor and the loop keyframe, the
    # corrected group at alpha = 1 (host scipy, as in JAX)
    C4 = np.eye(4)
    C4[:3, :3] = corr[1] * corr[0]
    C4[:3, 3] = corr[2]
    logC_inv = -np.real(scipy.linalg.logm(C4))
    denom = max(r_j - r_i, 1)
    for r in range(K):
        alpha = min(max((r - r_i) / denom, 0.0), 1.0)
        if kfs[r] in group:
            alpha = 1.0
        if alpha == 0.0:
            continue
        Vinv = np.real(scipy.linalg.expm(alpha * logC_inv))  # = (S^-1)^alpha as 4x4
        s_v = float(np.cbrt(np.linalg.det(Vinv[:3, :3])))
        R_v = Vinv[:3, :3] / s_v
        t_v = Vinv[:3, 3]
        # S_r_init = S_r_current o Vinv (Sim3 composition)
        s[r], R[r], t[r] = _np_sim3_compose(
            (float(s[r]), R[r].astype(np.float64), t[r].astype(np.float64)), (s_v, R_v, t_v))

    s2, R2, t2 = optimize_sim3_pose_graph(
        _f32(s, device), _f32(R, device), _f32(t, device),
        torch.tensor(np.asarray(ei, dtype=np.int32), device=device),
        torch.tensor(np.asarray(ej, dtype=np.int32), device=device),
        _f32(es, device), _f32(np.stack(eR), device), _f32(np.stack(et), device),
        torch.ones(E, dtype=torch.bool, device=device), _f32(ew, device),
        torch.tensor(fixed, device=device), torch.ones(K, dtype=torch.bool, device=device),
        num_iters=num_iters, n_kf=K)
    s2, R2, t2 = s2.cpu().numpy(), R2.cpu().numpy(), t2.cpu().numpy()

    # write corrected SE3 poses: absorb scale into translation (mono maps
    # rescale, rotations stay orthonormal)
    corrections = {}
    for k in kfs:
        i = idx_of[k]
        old_Tcw = m.kf_tcw[k].astype(np.float64)
        new_Tcw = np.eye(4)
        new_Tcw[:3, :3] = R2[i]
        new_Tcw[:3, 3] = t2[i] / s2[i]
        corrections[k] = (new_Tcw, old_Tcw, float(s2[i]))
        m.kf_tcw[k] = new_Tcw.astype(np.float32)

    # re-anchor map points through their first-observing keyframe
    for mp in m.mp_ids():
        ref = int(m.mp_first_kf[mp])
        if ref not in corrections:
            kf_idx, _, _ = m.observations_of([mp])
            if len(kf_idx) == 0:
                continue
            ref = int(kf_idx[0])
            if ref not in corrections:
                continue
        new_Tcw, old_Tcw, s_ref = corrections[ref]
        p_cam = old_Tcw[:3, :3] @ m.mp_pos[mp] + old_Tcw[:3, 3]
        Twc_new = np_geo.inv_T(new_Tcw)
        m.mp_pos[mp] = (Twc_new[:3, :3] @ (p_cam / s_ref) + Twc_new[:3, 3]).astype(np.float32)
    # full per-KF corrections so callers can re-anchor other world-frame
    # state (object landmarks) the same way map points were
    return corrections

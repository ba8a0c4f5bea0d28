"""Loop closing, keyframe-database part: place recognition by signatures.

numpy copy of the KeyFrameDatabase half of cube_slam_tpu/slam/loop_closing.py
(KeyFrameDatabase.cc without DBoW2): each keyframe gets a global
binary-statistic signature (the mean of its ORB descriptor bits, a 256-d
float vector); querying the database is one matvec against all signatures.
The tracker uses it for relocalization and keeps it in step with keyframe
culling and eviction. Sim3 verification, loop correction and the pose
graph belong to the loop-closing slice of the port.

Descriptors here are the host's uint32 words.
"""

from __future__ import annotations

import numpy as np


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

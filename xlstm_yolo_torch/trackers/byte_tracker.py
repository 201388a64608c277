"""ByteTrack: multi-object tracking by associating each frame's
detections with the tracks, on the host in float64 numpy.

Port of ``xlstm_yolo_tpu/trackers/byte_tracker.py``: ``STrack`` (one track: its
Kalman state over (cx, cy, aspect, height), score, class, id and life
cycle), ``BYTETracker`` (two association stages: detections at or above
``track_high_thresh`` against tracked and lost tracks by score-fused IoU,
then those between ``track_low_thresh`` and it against the tracks left,
by IoU; unconfirmed tracks against the rest; new tracks from detections
at or above ``new_track_thresh``; lost tracks dropped after
``track_buffer`` frames at 30 fps) and the list helpers ``joint_stracks``,
``sub_stracks`` and ``remove_duplicate_stracks``. Track ids count up from
a counter on the ``STrack`` class, as in JAX: every tracker built resets
it, and ``STrack.reset_id`` does too.
"""
from __future__ import annotations

import numpy as np

from .kalman import KalmanFilterXYAH
from .matching import iou_distance, linear_assignment


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


class STrack:
    """One tracked object."""

    shared_kalman = KalmanFilterXYAH()
    _count = 0

    def __init__(self, xywh, score, cls):
        self._tlwh = np.asarray(
            [xywh[0] - xywh[2] / 2, xywh[1] - xywh[3] / 2, xywh[2], xywh[3]], np.float32
        )
        self.kalman_filter = None
        self.mean, self.covariance = None, None
        self.is_activated = False
        self.score = float(score)
        self.cls = int(cls)
        self.tracklet_len = 0
        self.state = TrackState.New
        self.track_id = 0
        self.frame_id = 0
        self.start_frame = 0
        self.idx = -1

    @staticmethod
    def next_id():
        STrack._count += 1
        return STrack._count

    @staticmethod
    def reset_id():
        STrack._count = 0

    def activate(self, kalman_filter, frame_id):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = self.kalman_filter.initiate(self.tlwh_to_xyah(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        if frame_id == 1:
            self.is_activated = True
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track, frame_id, new_id=False):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xyah(new_track.tlwh)
        )
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.cls = new_track.cls

    def update(self, new_track, frame_id):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.tlwh_to_xyah(new_track.tlwh)
        )
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def predict(self):
        mean_state = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean_state[7] = 0
        self.mean, self.covariance = self.kalman_filter.predict(mean_state, self.covariance)

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed

    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()
        ret[2] *= ret[3]  # a*h = w
        ret[:2] -= ret[2:] / 2
        return ret

    @property
    def xyxy(self):
        t = self.tlwh
        return np.asarray([t[0], t[1], t[0] + t[2], t[1] + t[3]], np.float32)

    @property
    def end_frame(self):
        return self.frame_id

    @staticmethod
    def tlwh_to_xyah(tlwh):
        ret = np.asarray(tlwh, np.float32).copy()
        ret[:2] += ret[2:] / 2
        ret[2] /= ret[3]
        return ret

    def __repr__(self):
        return f"OT_{self.track_id}({self.start_frame}-{self.end_frame})"


class BYTETracker:
    """The ByteTrack association loop (module docstring)."""

    def __init__(self, track_high_thresh=0.25, track_low_thresh=0.1, new_track_thresh=0.25,
                 track_buffer=30, match_thresh=0.8, frame_rate=30, **kwargs):
        self.tracked_stracks: list[STrack] = []
        self.lost_stracks: list[STrack] = []
        self.removed_stracks: list[STrack] = []
        self.frame_id = 0
        self.track_high_thresh = track_high_thresh
        self.track_low_thresh = track_low_thresh
        self.new_track_thresh = new_track_thresh
        self.match_thresh = match_thresh
        self.max_time_lost = int(frame_rate / 30.0 * track_buffer)
        self.kalman_filter = self.get_kalmanfilter()
        STrack.reset_id()

    def get_kalmanfilter(self):
        return KalmanFilterXYAH()

    def init_track(self, xywhs, scores, clss, img=None):
        tracks = [STrack(x, s, c) for x, s, c in zip(xywhs, scores, clss)]
        return tracks

    def get_dists(self, tracks, detections):
        dists = iou_distance(tracks, detections)
        # fuse the detections' scores into the IoU cost
        if len(dists):
            det_scores = np.asarray([d.score for d in detections])
            dists = 1 - (1 - dists) * det_scores[None, :]
        return dists

    def multi_predict(self, tracks):
        for t in tracks:
            t.predict()

    def update(self, dets: np.ndarray, img=None) -> np.ndarray:
        """dets: (n, 6) = x1, y1, x2, y2, conf, cls.
        Returns (m, 7) = x1, y1, x2, y2, track_id, conf, cls for active tracks."""
        self.frame_id += 1
        activated, refind, lost, removed = [], [], [], []
        dets = np.asarray(dets, np.float32).reshape(-1, 6)
        xyxy, scores, clss = dets[:, :4], dets[:, 4], dets[:, 5]
        xywh = np.stack([
            (xyxy[:, 0] + xyxy[:, 2]) / 2, (xyxy[:, 1] + xyxy[:, 3]) / 2,
            xyxy[:, 2] - xyxy[:, 0], xyxy[:, 3] - xyxy[:, 1],
        ], 1) if len(dets) else np.zeros((0, 4), np.float32)

        remain = scores >= self.track_high_thresh
        low = (scores > self.track_low_thresh) & (scores < self.track_high_thresh)
        detections = self.init_track(xywh[remain], scores[remain], clss[remain], img)
        for di, si in enumerate(np.nonzero(remain)[0]):
            detections[di].idx = si
        detections_low = self.init_track(xywh[low], scores[low], clss[low], img)
        for di, si in enumerate(np.nonzero(low)[0]):
            detections_low[di].idx = si

        unconfirmed = [t for t in self.tracked_stracks if not t.is_activated]
        tracked = [t for t in self.tracked_stracks if t.is_activated]
        strack_pool = joint_stracks(tracked, self.lost_stracks)
        self.multi_predict(strack_pool)

        # stage 1: high-conf matching
        dists = self.get_dists(strack_pool, detections)
        matches, u_track, u_det = linear_assignment(dists, thresh=self.match_thresh)
        for it, idet in matches:
            track, det = strack_pool[it], detections[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id)
                refind.append(track)

        # stage 2: rescue with low-conf detections
        r_tracked = [strack_pool[i] for i in u_track if strack_pool[i].state == TrackState.Tracked]
        dists = iou_distance(r_tracked, detections_low)
        matches, u_track2, _ = linear_assignment(dists, thresh=0.5)
        for it, idet in matches:
            track, det = r_tracked[it], detections_low[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id)
                refind.append(track)
        for i in u_track2:
            track = r_tracked[i]
            if track.state != TrackState.Lost:
                track.mark_lost()
                lost.append(track)

        # unconfirmed tracks vs remaining detections
        detections_r = [detections[i] for i in u_det]
        dists = self.get_dists(unconfirmed, detections_r)
        matches, u_unconf, u_det2 = linear_assignment(dists, thresh=0.7)
        for it, idet in matches:
            unconfirmed[it].update(detections_r[idet], self.frame_id)
            activated.append(unconfirmed[it])
        for i in u_unconf:
            track = unconfirmed[i]
            track.mark_removed()
            removed.append(track)

        # new tracks
        for i in u_det2:
            track = detections_r[i]
            if track.score >= self.new_track_thresh:
                track.activate(self.kalman_filter, self.frame_id)
                activated.append(track)

        # expire lost tracks
        for track in self.lost_stracks:
            if self.frame_id - track.end_frame > self.max_time_lost:
                track.mark_removed()
                removed.append(track)

        self.tracked_stracks = [t for t in self.tracked_stracks if t.state == TrackState.Tracked]
        self.tracked_stracks = joint_stracks(self.tracked_stracks, activated)
        self.tracked_stracks = joint_stracks(self.tracked_stracks, refind)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks.extend(lost)
        self.lost_stracks = sub_stracks(self.lost_stracks, removed)
        self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(
            self.tracked_stracks, self.lost_stracks
        )
        self.removed_stracks.extend(removed)
        if len(self.removed_stracks) > 1000:
            self.removed_stracks = self.removed_stracks[-999:]

        return np.asarray(
            [[*t.xyxy, t.track_id, t.score, t.cls] for t in self.tracked_stracks if t.is_activated],
            np.float32,
        ).reshape(-1, 7)


def joint_stracks(a: list, b: list) -> list:
    seen = {t.track_id for t in a}
    return a + [t for t in b if t.track_id not in seen]


def sub_stracks(a: list, b: list) -> list:
    ids = {t.track_id for t in b}
    return [t for t in a if t.track_id not in ids]


def remove_duplicate_stracks(a: list, b: list):
    pdist = iou_distance(a, b)
    pairs = np.nonzero(pdist < 0.15)
    dup_a, dup_b = set(), set()
    for p, q in zip(*pairs):
        timep = a[p].frame_id - a[p].start_frame
        timeq = b[q].frame_id - b[q].start_frame
        if timep > timeq:
            dup_b.add(q)
        else:
            dup_a.add(p)
    return [t for i, t in enumerate(a) if i not in dup_a], [t for i, t in enumerate(b) if i not in dup_b]

"""Seeded frames and detections for the tracker tests, with no JAX and no
cv2: ``tests/test_torch_trackers.py`` imports them, and ``run`` tracks the
panned sequence with the port's BOT-SORT in a process of its own (where
the test then checks that nothing imported cv2)."""
import numpy as np
from scipy.ndimage import gaussian_filter


def texture(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth seeded RGB texture, uint8 (blurred noise, contrast raised)."""
    rng = np.random.default_rng(seed)
    x = gaussian_filter(rng.uniform(0, 255, (h, w, 3)), (2.0, 2.0, 0), mode="reflect")
    return np.clip((x - x.mean()) * 6 + 128, 0, 255).astype(np.uint8)


def panned_sequence(n_frames: int = 12, h: int = 240, w: int = 320, seed: int = 5):
    """Frames of a texture panned 3 px a frame with 4 bright squares on
    straight paths, and each frame's detections: the squares' boxes with
    seeded noise (conf 0.6-0.95, class 0)."""
    rng = np.random.default_rng(seed)
    canvas = texture(h, w + 3 * n_frames, seed)
    start = np.asarray([[40.0, 40.0], [200.0, 60.0], [80.0, 160.0], [240.0, 170.0]])
    vel = np.asarray([[2.0, 1.0], [-1.5, 2.0], [3.0, -1.0], [-2.5, -1.5]])
    frames, dets = [], []
    for f in range(n_frames):
        img = canvas[:, 3 * f:3 * f + w].copy()
        boxes = []
        for k, (p, v) in enumerate(zip(start, vel)):
            x1, y1 = (p + f * v).astype(int)
            img[y1:y1 + 30, x1:x1 + 30] = (230, 200 + 10 * k, 60)
            b = np.asarray([x1, y1, x1 + 30, y1 + 30], np.float64) + rng.normal(0, 0.5, 4)
            boxes.append([*b, rng.uniform(0.6, 0.95), 0])
        frames.append(img)
        dets.append(np.asarray(boxes, np.float32))
    return frames, dets


def run(n_frames: int = 4) -> np.ndarray:
    """The port's ``BOTSORT`` (``sparseOptFlow``) over the first
    ``n_frames`` of the panned sequence; the last frame's tracks."""
    from xlstm_yolo_torch.trackers import BOTSORT

    frames, dets = panned_sequence(n_frames)
    tracker = BOTSORT()
    out = None
    for img, d in zip(frames, dets):
        out = tracker.update(d, img)
    return out
